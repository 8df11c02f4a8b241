"""Hymba-1.5B [arXiv:2411.13676]: hybrid-head blocks — attention and Mamba
heads in parallel on the same input, outputs mean-fused after per-branch
normalization. Sliding-window attention except three global layers."""
import dataclasses

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv=5,
    d_ff=5504,
    vocab=32001,
    activation="silu_gated",
    norm="rmsnorm",
    rope=True,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=128),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="hymba-smoke", n_layers=2, d_model=320, n_heads=5,
        n_kv=1, d_ff=512, vocab=512, sliding_window=32, global_layers=(0,),
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, conv_width=4, chunk=32))
