"""Runtime accuracy guards of the PyTorch port: the paper's Lemma 3.1
a-posteriori bound consulted live, with bandwidth escalation and the exact
direct-sum floor (see ``guards``)."""

from repro_torch.runtime.guards import (  # noqa: F401
    DirectKernelOperator, GuardPolicy, GuardReport, ProbeReport,
    guarded_fastsum, guarded_normalized_adjacency, probe_fastsum,
)
