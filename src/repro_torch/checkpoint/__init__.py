"""Checkpoints of the port (counterpart of `repro.checkpoint`)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
