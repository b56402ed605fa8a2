"""Training substrate of the PyTorch port: optimizers, the train step,
checkpointing and the fault-tolerant step loop."""

from repro_torch.training.optimizer import (  # noqa: F401
    OptimizerConfig, init_optimizer, make_schedule,
)
from repro_torch.training.train_loop import (  # noqa: F401
    TrainConfig, TrainState, init_train_state, make_train_step,
)
from repro_torch.training.checkpoint import (  # noqa: F401
    latest_step, restore_checkpoint, save_checkpoint,
)
