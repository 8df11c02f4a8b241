"""Training of the port (counterpart of `repro.training`): AdamW with
float32 master weights and moments, and the train step over `lm_loss`
under autograd."""
from repro_torch.training import adamw, train_step  # noqa: F401
from repro_torch.training.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
)
