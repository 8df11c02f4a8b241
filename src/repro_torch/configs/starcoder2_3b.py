"""StarCoder2-3B [arXiv:2402.19173]: dense GQA decoder, RoPE, GELU MLP,
LayerNorm, biases on all linears, sliding-window 4096 attention."""
import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv=2,
    d_ff=12288,
    vocab=49152,
    activation="gelu",
    norm="layernorm",
    rope=True,
    qkv_bias=True,
    out_bias=True,
    mlp_bias=True,
    sliding_window=4096,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv=2, d_ff=1024, vocab=512, sliding_window=64)
