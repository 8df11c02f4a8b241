"""MusicGen-large [arXiv:2306.05284]: decoder-only transformer over EnCodec
audio tokens (vocab 2048), sinusoidal absolute positions, GELU MLP,
LayerNorm. The EnCodec tokenizer + text conditioner are stubs: the caller
supplies 64 conditioning frame embeddings as `prefix_embeds`, consumed as
a prefix."""
import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=2048,
    activation="gelu",
    norm="layernorm",
    rope=False,             # sinusoidal absolute positions
    prefix_len=64,          # conditioning embeddings from the stub frontend
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv=8, d_ff=768, vocab=512, prefix_len=8)
