"""Synthetic training data of the port (counterpart of `repro.data`)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    make_batches,
    synthetic_stream,
)
