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

from repro_torch.config import ModelConfig
from repro_torch.models.attention import Attention, KVCache
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.norms import Norm
from repro_torch.models.ssm import SSM, SSMState

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
        return 0.5 * (self.branch_norm_attn(a) + self.branch_norm_ssm(s))

    def _channel_mix(self, x):
        if self.kind == "ssm":
            return x
        h = self.norm2(x)
        if self.moe is not None:
            return x + self.moe(h)[0]
        return x + self.mlp(h)

    def prefill(self, x, positions, window: int, impl: str = "kernel"):
        """Full block over a sequence.  Returns (x, (k, v) or None,
        SSMState or None)."""
        h = self.norm1(x)
        kv = st = None
        if self.kind == "ssm":
            mix, st = self.ssm.prefill(h, impl)
        elif self.kind == "hybrid":
            a, kv = self.attn.prefill(h, positions, window, impl)
            s, st = self.ssm.prefill(h, impl)
            mix = self._fuse(a, s)
        else:
            mix, kv = self.attn.prefill(h, positions, window, impl)
        return self._channel_mix(x + mix), kv, st

    def decode(self, x, pos: int, cache: LayerCache, window: int,
               valid=None, impl: str = "kernel"):
        """One token.  Returns (x, cache), the cache updated in place."""
        h = self.norm1(x)
        if self.kind == "ssm":
            mix, _ = self.ssm.decode(h, cache.ssm)
        elif self.kind == "hybrid":
            a, _ = self.attn.decode(h, pos, cache.kv, window, valid, impl)
            s, _ = self.ssm.decode(h, cache.ssm)
            mix = self._fuse(a, s)
        else:
            mix, _ = self.attn.decode(h, pos, cache.kv, window, valid, impl)
        return self._channel_mix(x + mix), cache
