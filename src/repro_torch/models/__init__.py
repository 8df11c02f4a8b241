"""Model substrate of the port: the dense decoder and its serving entry
points (counterpart of `repro.models`)."""
from repro_torch.models.attention import KVCache  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    Model,
    decode_step,
    init_caches,
    init_model,
    prefill,
)
