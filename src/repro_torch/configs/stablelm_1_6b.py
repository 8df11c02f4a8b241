"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]: dense decoder,
partial rotary (25% of head dim), LayerNorm, SiLU-gated MLP, full MHA."""
import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=5632,
    vocab=100352,
    activation="silu_gated",
    norm="layernorm",
    rope=True,
    rope_fraction=0.25,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv=8, d_ff=768, vocab=512)
