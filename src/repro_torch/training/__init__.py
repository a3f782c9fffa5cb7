"""Training: the train step, its state and the fault-tolerant runner."""
from repro_torch.training.train import (  # noqa: F401
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
)
