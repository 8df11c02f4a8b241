"""Grouped-query attention with RoPE, optional QKV bias, sliding windows
and a KV-cache decode path.

Counterpart of `repro.models.attention`.  Prefill runs the whole prompt
through the flash-attention kernel and decode runs one token against
the cache through the flash-decode kernel (`impl="kernel"`, the main
path).  On CPU tensors the kernels' wrappers take their plain versions;
`impl="plain"` calls the plain versions on any device, which is how the
chip check holds the kernels against them inside the model.  The
reference's XLA attention (`_sdpa`, `flash_xla`) is not ported.

The decode path writes the new K/V into the cache in place (the
reference returns a new cache; updating in place saves a copy of every
layer's cache a step).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.common import Dense
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
IMPLS = ("kernel", "plain")


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, S_cache, KV, hd)
    v: torch.Tensor    # (B, S_cache, KV, hd)
    # ring buffer when window > 0 (S_cache == window), else linear buffer


def cache_valid(pos: int, S_cache: int, window: int, device=None
                ) -> torch.Tensor:
    """(S_cache,) bool: the cache slots a query at absolute position
    `pos` attends to, after the token at `pos` is written.

    Slot s holds position p(s) = pos - ((pos - s) mod S_cache), the
    latest p <= pos congruent to s; it is valid iff written (p >= 0) and
    within the window when one is set.  One rule for the ring (S_cache
    == window) and the linear cache (the reference's unified rule,
    `attention.py:189-196`)."""
    idx = torch.arange(S_cache, device=device)
    p_abs = pos - torch.remainder(pos - idx, S_cache)
    valid = p_abs >= 0
    if window > 0:
        valid &= p_abs > pos - window
    return valid


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        hd = cfg.head_dim
        self.n_heads, self.n_kv, self.head_dim = cfg.n_heads, cfg.n_kv, hd
        self.rope, self.rope_fraction = cfg.rope, cfg.rope_fraction
        self.rope_theta = cfg.rope_theta
        d = cfg.d_model
        self.q = Dense(d, cfg.n_heads * hd, cfg.qkv_bias, dtype, device,
                       axes=("embed", "heads"))
        self.k = Dense(d, cfg.n_kv * hd, cfg.qkv_bias, dtype, device,
                       axes=("embed", "kv_heads"))
        self.v = Dense(d, cfg.n_kv * hd, cfg.qkv_bias, dtype, device,
                       axes=("embed", "kv_heads"))
        self.o = Dense(cfg.n_heads * hd, d, cfg.out_bias, dtype, device,
                       axes=("heads", "embed"))
        self.o.init_scale = (1.0 / (cfg.n_heads * hd) ** 0.5
                             / (2 * cfg.n_layers) ** 0.5)

    def qkv(self, x, positions):
        """x: (B, S, D); positions: (B, S) -> q (B,S,H,hd), k/v
        (B,S,KV,hd) with RoPE applied to q and k."""
        B, S, _ = x.shape
        hd = self.head_dim
        q = self.q(x).reshape(B, S, self.n_heads, hd)
        k = self.k(x).reshape(B, S, self.n_kv, hd)
        v = self.v(x).reshape(B, S, self.n_kv, hd)
        if self.rope:
            q = apply_rope(q, positions, self.rope_fraction, self.rope_theta)
            k = apply_rope(k, positions, self.rope_fraction, self.rope_theta)
        return q, k, v

    def prefill(self, x, positions, window: int, impl: str = "kernel"):
        """Causal attention over the whole sequence.  Returns (out,
        (k, v)) so that serving can seed a cache."""
        _check_impl(impl)
        q, k, v = self.qkv(x, positions)
        if impl == "kernel":
            out = fa_ops.flash_attention(q, k, v, window=window)
        else:
            out = fa_ref.flash_attention_ref(q, k, v, window=window)
        return self.o(out.reshape(*out.shape[:2], -1)), (k, v)

    def decode(self, x, pos: int, cache: KVCache, window: int,
               valid: torch.Tensor | None = None, impl: str = "kernel"):
        """One token against the cache.  x: (B, 1, D); pos: the token's
        absolute position (a host int).  Writes its K/V at slot
        pos % S_cache in place and attends to the `cache_valid` slots
        (computed here unless the caller passes them).  Returns (out,
        cache)."""
        _check_impl(impl)
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        q, k_new, v_new = self.qkv(x, positions)
        S_cache = cache.k.shape[1]
        slot = pos % S_cache  # == pos for a linear cache (S_cache > pos)
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
        if valid is None:
            valid = cache_valid(pos, S_cache, window, x.device)
        qd = q[:, 0].to(cache.k.dtype)
        if impl == "kernel":
            out = da_ops.decode_attention(qd, cache.k, cache.v, valid)
        else:
            out = da_ref.decode_attention_ref(qd, cache.k, cache.v, valid)
        return self.o(out.reshape(B, 1, -1).to(x.dtype)), cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, window: int,
               dtype, device) -> KVCache:
    S = min(window, max_seq) if window > 0 else max_seq
    shape = (batch, S, cfg.n_kv, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# logical axes of a layer's cache, mapped by the activation rules
CACHE_AXES = KVCache(
    k=("cache_batch", "cache_seq", "kv_heads", None),
    v=("cache_batch", "cache_seq", "kv_heads", None),
)
