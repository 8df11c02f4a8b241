"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA decoder with squared-ReLU
MLP (non-gated), RoPE, LayerNorm."""
import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv=8,
    d_ff=73728,
    vocab=256000,
    activation="sq_relu",
    norm="layernorm",
    rope=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="nemotron-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv=2, d_ff=1024, vocab=512)
