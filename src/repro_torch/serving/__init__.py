"""Serving: the continuous-batching LM engine (``engine``) and the
graph-predict tier (``graph``: batched NFFT kernel predictions for
multi-tenant KRR models)."""

from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serving.graph import (  # noqa: F401
    GraphModelRegistry, GraphServeEngine, PredictRequest, TickStats,
)
