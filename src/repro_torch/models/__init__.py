"""Model substrate of the port: the dense, state-space and hybrid
decoders and their serving entry points (counterpart of
`repro.models`)."""
from repro_torch.models.attention import KVCache  # noqa: F401
from repro_torch.models.blocks import LayerCache  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    Model,
    decode_step,
    init_caches,
    init_model,
    prefill,
)
from repro_torch.models.ssm import SSMState, init_ssm_state  # noqa: F401
