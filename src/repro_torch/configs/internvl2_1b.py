"""InternVL2-1B [arXiv:2404.16821]: InternViT vision encoder (a stub: the
caller supplies its 256 patch embeddings as `prefix_embeds`) feeding a
Qwen2-0.5B-style LM backbone (GQA kv=2, SiLU-gated, RMSNorm, RoPE)."""
import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151655,
    activation="silu_gated",
    norm="rmsnorm",
    rope=True,
    qkv_bias=True,          # Qwen2-style attention biases
    prefix_len=256,         # ViT patch embeddings provided by the stub
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", n_layers=2, d_model=224, n_heads=14,
        n_kv=2, d_ff=512, vocab=512, prefix_len=16)
