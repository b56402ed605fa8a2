"""Serving: the continuous-batching LM engine (``engine``), the
graph-predict tier (``graph``: batched NFFT kernel predictions for
multi-tenant KRR models) and its durability (``journal``: a checksummed
append-only journal and warm-restart replay)."""

from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serving.graph import (  # noqa: F401
    GraphModelRegistry, GraphServeEngine, PredictRequest, TickStats,
)
from repro_torch.serving.journal import (  # noqa: F401
    RecoveryReport, RegistryJournal, recover_registry,
)
