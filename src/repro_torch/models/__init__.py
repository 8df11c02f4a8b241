"""Model substrate of the port: the decoders of the ten architectures,
their training and serving entry points (counterpart of
`repro.models`)."""
from repro_torch.models.attention import KVCache  # noqa: F401
from repro_torch.models.blocks import LayerCache  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    Model,
    cache_axes,
    decode_step,
    forward_train,
    init_caches,
    init_model,
    lm_loss,
    param_axes,
    prefill,
)
from repro_torch.models.ssm import SSMState, init_ssm_state  # noqa: F401
