"""Transformer blocks.  Counterpart of `repro.models.blocks`, with one
`nn.Module` per layer (the model holds them in an `nn.ModuleList`)
instead of the reference's stacked `(L, ...)` leaves under `lax.scan`.

Every kind of the reference:

* dense, and the decoders behind a modality prefix (vlm, audio): pre-
  norm, attention (RoPE or, for MusicGen, none: the model adds
  sinusoidal positions), residual, pre-norm, MLP, residual;
* moe: the same with the MLP replaced by `MoE` (the channel mix is the
  MoE whenever the config has a `MoEConfig`, as in the reference);
* ssm (Mamba2): pre-norm, the SSM mixer, residual; no MLP;
* hybrid (Hymba): attention and the SSM mixer on the same normed input,
  fused as 0.5 * (rmsnorm_a(a) + rmsnorm_s(s)) in the model dtype,
  residual, pre-norm, MLP, residual.

An `arch_type` outside these raises `ValueError`.
"""
from __future__ import annotations

from typing import NamedTuple

from torch import nn

from repro_torch import tracing
from repro_torch.config import ModelConfig
from repro_torch.models.attention import Attention, KVCache
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.norms import Norm
from repro_torch.models.ssm import SSM, SSMState
from repro_torch.sharding.rules import constrain

KINDS = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class LayerCache(NamedTuple):
    """One layer's decode state: its KV cache (attention layers) and its
    SSM state (ssm and hybrid layers); the other is None."""
    kv: KVCache | None
    ssm: SSMState | None


def check_supported(cfg: ModelConfig) -> None:
    kind = cfg.arch_type
    if kind not in KINDS:
        raise ValueError(f"{cfg.name}: unknown arch_type {kind!r}; "
                         f"choose from {KINDS}")
    if kind in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: {kind} blocks need an SSMConfig")
    if kind == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.name}: moe blocks need a MoEConfig")


def _pin(y):
    """A mixer's or MLP's output pinned to the residual stream's
    placement (batch split, every column whole) before it is added: in a
    sharded step the row-parallel output projection leaves a partial
    sum, reduced here, as GSPMD reduces it; the identity otherwise."""
    return constrain(y, "batch", None, None)


def layer_window(cfg: ModelConfig, layer: int) -> int:
    """The layer's attention window (0 = full): hybrid global layers
    attend fully, every other layer uses the config's window."""
    return 0 if layer in cfg.global_layers else cfg.sliding_window


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        check_supported(cfg)
        self.kind = cfg.arch_type
        d = cfg.d_model
        self.norm1 = Norm(d, cfg.norm, dtype, device)
        self.attn = (None if self.kind == "ssm"
                     else Attention(cfg, dtype, device))
        self.ssm = (SSM(cfg, dtype, device)
                    if self.kind in ("ssm", "hybrid") else None)
        if self.kind == "hybrid":
            self.branch_norm_attn = Norm(d, "rmsnorm", dtype, device)
            self.branch_norm_ssm = Norm(d, "rmsnorm", dtype, device)
        self.moe = self.mlp = None
        if self.kind != "ssm":
            self.norm2 = Norm(d, cfg.norm, dtype, device)
            if cfg.moe is not None:
                self.moe = MoE(cfg, dtype, device)
            else:
                self.mlp = MLP(d, cfg.d_ff, cfg.activation, dtype, device,
                               cfg.mlp_bias)

    def _fuse(self, a, s):
        return 0.5 * (self.branch_norm_attn(_pin(a))
                      + self.branch_norm_ssm(_pin(s)))

    def _channel_mix(self, x):
        """x plus the MLP (or the MoE) of its norm, and the MoE's aux
        loss (float32 (); None without a MoE, whose aux the reference
        sets to 0.0, so leaving it out of the sum changes no bit)."""
        if self.kind == "ssm":
            return x, None
        h = self.norm2(x)
        if self.moe is not None:
            with tracing.span("block.moe"):
                y, aux = self.moe(h)
            return x + _pin(y), aux
        with tracing.span("block.mlp"):
            y = self.mlp(h)
        return x + _pin(y), None

    def forward(self, x, positions, window: int, impl: str = "kernel"):
        """Full block over a sequence: serving's prefill and, with
        `impl="plain"` under autograd, training's pass.  Returns (x,
        (k, v) or None, SSMState or None, the MoE aux loss or None)."""
        h = self.norm1(x)
        kv = st = None
        if self.kind == "ssm":
            mix, st = self.ssm.prefill(h, impl)
        elif self.kind == "hybrid":
            with tracing.span("block.attention"):
                a, kv = self.attn.prefill(h, positions, window, impl)
            s, st = self.ssm.prefill(h, impl)
            mix = self._fuse(a, s)
        else:
            with tracing.span("block.attention"):
                mix, kv = self.attn.prefill(h, positions, window, impl)
        x, aux = self._channel_mix(x + _pin(mix))
        return x, kv, st, aux

    def decode(self, x, pos: int, cache: LayerCache, window: int,
               valid=None, impl: str = "kernel"):
        """One token.  Returns (x, cache), the cache updated in place."""
        h = self.norm1(x)
        if self.kind == "ssm":
            mix, _ = self.ssm.decode(h, cache.ssm)
        elif self.kind == "hybrid":
            with tracing.span("block.attention"):
                a, _ = self.attn.decode(h, pos, cache.kv, window, valid,
                                        impl)
            s, _ = self.ssm.decode(h, cache.ssm)
            mix = self._fuse(a, s)
        else:
            with tracing.span("block.attention"):
                mix, _ = self.attn.decode(h, pos, cache.kv, window, valid,
                                          impl)
        return self._channel_mix(x + _pin(mix))[0], cache
