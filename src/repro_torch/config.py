"""Model and serving configuration of the port.

The port's own copy of the dataclasses of `repro.config` that the model
substrate, the serving engine and the trainer read: `ModelConfig` (one
architecture), `MoEConfig`, `SSMConfig`, `TrainConfig` and
`ServeConfig`, and the assigned input shapes (`ShapeConfig`, `SHAPES`:
train_4k / prefill_32k / decode_32k / long_500k) that the dry run
(`repro_torch.launch.dryrun`) builds its steps at.  Field names,
defaults and the derived properties are the reference's, so a
configuration reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False      # Arctic: dense MLP in parallel w/ MoE
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2                   # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128                  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free
    n_kv: int
    d_ff: int
    vocab: int
    # attention flavor
    rope: bool = True
    rope_fraction: float = 1.0        # stablelm: rotary on 25% of head dim
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    out_bias: bool = False
    mlp_bias: bool = False
    sliding_window: int = 0           # 0 = full attention
    global_layers: tuple = ()         # hybrid: layers that keep full attn
    # body flavor
    activation: str = "silu_gated"    # silu_gated | sq_relu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    # mixtures / state-space
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # positions of the (stubbed) modality prefix
    prefix_len: int = 0
    # numerics
    dtype: str = "bfloat16"
    scan_unroll: bool = False         # kept for field parity; unused here
    variant_note: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128, as in the reference;
        the padded logit columns are masked to -inf in the head."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return dataclasses.replace(
            self,
            sliding_window=window,
            variant_note=f"sliding-window({window}) variant for long-context decode",
        )

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula (it leaves
        out norms, biases and the vocabulary's padding)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if not self.attention_free and self.arch_type != "hybrid":
            hd = self.head_dim
            per_layer += d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd)
            per_layer += (self.n_heads * hd) * d
        gate_mult = 3 if self.activation == "silu_gated" else 2
        if self.moe:
            expert = gate_mult * d * ff
            per_layer += self.moe.n_experts * expert + d * self.moe.n_experts
            if self.moe.dense_residual:
                per_layer += gate_mult * d * ff
        elif ff > 0:
            per_layer += gate_mult * d * ff
        if self.ssm:
            di, ds = self.d_inner, self.ssm.d_state
            nh = self.n_ssm_heads
            per_layer += d * (2 * di + 2 * ds + nh) + di * d
            per_layer += self.ssm.conv_width * (di + 2 * ds)
        if self.arch_type == "hybrid":
            hd = self.head_dim
            per_layer += d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd)
            per_layer += (self.n_heads * hd) * d
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Active (per-token) parameters: a MoE counts top_k experts."""
        if not self.moe:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        gate_mult = 3 if self.activation == "silu_gated" else 2
        inactive = L * (self.moe.n_experts - self.moe.top_k) * gate_mult * d * ff
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1             # grad accumulation (perf knob)
    remat: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048
    max_batch: int = 8
    temperature: float = 0.0
    eos_id: int = 1
