"""Guarded execution in the PyTorch port: the paper's Lemma 3.1
a-posteriori bound consulted live, with bandwidth escalation and the exact
direct-sum floor (``guards``); durable, snapshot-resumable Krylov drivers
(``durable``); and seeded fault injectors for driving the solve and serve
paths through failures (``faultinject``)."""

from repro_torch.runtime.durable import (
    DurablePolicy, DurableReport, resumable_eigsh, resumable_solve,
)
from repro_torch.runtime.faultinject import (
    KillPoint, KillSchedule, Preemption, SlowMatvec, TickChaos,
    chaos_schedule, corrupt_group_plan, nan_poison_grid, poison_bank_member,
    poison_columns, poison_registry_grids,
)
from repro_torch.runtime.guards import (
    DirectKernelOperator, GuardPolicy, GuardReport, ProbeReport,
    guarded_fastsum, guarded_normalized_adjacency, probe_fastsum,
)

__all__ = [
    "DirectKernelOperator",
    "DurablePolicy",
    "DurableReport",
    "GuardPolicy",
    "GuardReport",
    "KillPoint",
    "KillSchedule",
    "Preemption",
    "ProbeReport",
    "SlowMatvec",
    "TickChaos",
    "chaos_schedule",
    "corrupt_group_plan",
    "guarded_fastsum",
    "guarded_normalized_adjacency",
    "nan_poison_grid",
    "poison_bank_member",
    "poison_columns",
    "poison_registry_grids",
    "probe_fastsum",
    "resumable_eigsh",
    "resumable_solve",
]
