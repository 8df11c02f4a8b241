"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
16-expert top-2 MoE, GQA kv=8."""
import dataclasses

from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=6400,
    vocab=32064,
    activation="silu_gated",
    norm="rmsnorm",
    rope=True,
    moe=MoEConfig(n_experts=16, top_k=2, capacity_factor=1.25),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi35-moe-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv=2, d_ff=512, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25))
