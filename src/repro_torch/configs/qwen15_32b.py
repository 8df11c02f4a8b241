"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B card family]: dense decoder with QKV
bias, full MHA (kv == heads), SiLU-gated MLP, RMSNorm, RoPE."""
import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=40,
    d_ff=27392,
    vocab=152064,
    activation="silu_gated",
    norm="rmsnorm",
    rope=True,
    qkv_bias=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen15-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv=8, d_ff=1024, vocab=512)
