"""Mamba2-780M [arXiv:2405.21060]: attention-free SSD (state-space
duality) stack; 48 mixer layers, d_state=128, no FFN."""
import dataclasses

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    activation="silu_gated",
    norm="rmsnorm",
    rope=False,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=128),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=256, vocab=512,
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, conv_width=4, chunk=32))
