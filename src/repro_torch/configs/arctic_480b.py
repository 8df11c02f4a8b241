"""Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]: dense-MoE hybrid —
128-expert top-2 MoE in parallel with a dense residual MLP, GQA kv=8."""
import dataclasses

from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=4864,
    vocab=32000,
    activation="silu_gated",
    norm="rmsnorm",
    rope=True,
    moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual=True),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="arctic-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv=2, d_ff=512, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25,
                      dense_residual=True))
