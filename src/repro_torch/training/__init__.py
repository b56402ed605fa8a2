"""Training substrate of the PyTorch port: checkpointing (``checkpoint``)
and the fault-tolerant step loop (``fault_tolerance``).  The optimizers and
the LM train loop wait for ROADMAP queue 1 item 13."""

from repro_torch.training.checkpoint import (  # noqa: F401
    latest_step, restore_checkpoint, save_checkpoint,
)
