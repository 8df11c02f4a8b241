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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.common import Dense
from repro_torch.models.rope import apply_rope
from repro_torch.sharding import dist as sd

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
        return self._heads(self.q(x), self.k(x), self.v(x), positions)

    def prefill(self, x, positions, window: int, impl: str = "kernel"):
        """Causal attention over the whole sequence.  Returns (out,
        (k, v)) so that serving can seed a cache."""
        _check_impl(impl)
        if isinstance(x, DTensor):
            return self._prefill_sharded(x, positions, window, impl)
        q, k, v = self.qkv(x, positions)
        out = _prefill_attend(q, k, v, window, impl)
        return self.o(out.reshape(*out.shape[:2], -1)), (k, v)

    # --- a sharded step: x a DTensor, each rank attends on its slices ---

    def _split(self, dmesh) -> tuple[bool, bool]:
        """(q's heads, K/V's heads) split over the mesh's `model` axis:
        q's where the heads divide by it and a rank's share of them
        reads whole K/V heads, K/V's where theirs divide too.  Where
        they do not, each rank of the axis gets every head (the
        projections' columns all-gathered) and attends with its own
        share of ceil(H / M) of them alone, as a split padded to M
        shares would."""
        M = sd.axis_size(dmesh, "model")
        H, KV = self.n_heads, self.n_kv
        G, Hl = H // KV, H // M
        q_split = H % M == 0 and (Hl % G == 0 or G % Hl == 0)
        return q_split, q_split and KV % M == 0

    def _kv_for(self, k, v, n_q: int, r: int):
        """The K/V heads that q heads r*n_q..(r+1)*n_q read, where q is
        split and K/V is not; all of them otherwise."""
        if k.shape[2] != self.n_kv or n_q == self.n_heads:
            return k, v
        G = self.n_heads // self.n_kv
        a, b = r * n_q // G, ((r + 1) * n_q - 1) // G + 1
        return k[:, :, a:b], v[:, :, a:b]

    def _heads(self, q, k, v, positions):
        """Local (B, S, cols) projections -> (B, S, heads, hd), RoPE
        applied to q and k."""
        B, S = q.shape[:2]
        hd = self.head_dim
        q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
        if self.rope:
            q = apply_rope(q, positions, self.rope_fraction, self.rope_theta)
            k = apply_rope(k, positions, self.rope_fraction, self.rope_theta)
        return q, k, v

    def _prefill_sharded(self, x, positions, window: int, impl: str):
        dm = x.device_mesh
        q_split, kv_split = self._split(dm)
        bpl = sd.batch_placements(x)
        pq = sd.on_axis(bpl, dm, "model", Shard(2) if q_split else Replicate())
        pkv = sd.on_axis(bpl, dm, "model",
                         Shard(2) if kv_split else Replicate())
        r = sd.axis_rank(dm, "model")
        M, H = sd.axis_size(dm, "model"), self.n_heads
        share = -(-H // M)
        h0, h1 = min(H, r * share), min(H, (r + 1) * share)
        G = H // self.n_kv

        def attend(q, k, v, positions):
            q, k, v = self._heads(q, k, v, positions)
            if q_split or M == 1:
                out = _prefill_attend(q, *self._kv_for(k, v, q.shape[2], r),
                                      window, impl)
                return out.reshape(*out.shape[:2], -1), k, v
            # heads h0..h1 alone, each with its K/V head; zeros for the
            # other ranks' heads, summed over the axis
            kv = torch.arange(h0, h1, device=q.device) // G
            out = _prefill_attend(q[:, :, h0:h1], k[:, :, kv], v[:, :, kv],
                                  window, impl)
            out = torch.nn.functional.pad(out, (0, 0, h0, H - h1))
            return out.reshape(*out.shape[:2], -1), k, v

        # a whole tensor a rank reads only its share of has a partial
        # gradient over the axis
        part = sd.on_axis(bpl, dm, "model", Partial())
        po = gq = pq if q_split else part
        gkv = pkv if kv_split else part
        out, k, v = local_map(
            attend, out_placements=(po, pkv, pkv),
            in_placements=(pq, pkv, pkv, bpl),
            in_grad_placements=(gq, gkv, gkv, bpl), device_mesh=dm,
            redistribute_inputs=True)(self.q(x), self.k(x), self.v(x),
                                      positions)
        return self.o(out), (k, v)

    def _decode_sharded(self, x, pos: int, cache: KVCache, window: int,
                        valid, impl: str):
        """One token against a cache split over `cache_batch` and, on
        the `model` axis, over its slots (`cache_seq`).  The new K/V is
        written by the rank whose slots hold `pos % S_cache` alone; each
        rank attends over its own slots and the ranks of the axis
        combine their softmax partials (a max and two sums, each an
        all-reduce of (B, H) values)."""
        dm = x.device_mesh
        cpl = tuple(cache.k.placements)
        seq = sd.on_axis(cpl, dm, "model", Replicate()) != cpl
        if any(p.is_shard() and not (p.is_shard(0) or p.is_shard(1))
               for p in cpl):
            raise NotImplementedError(
                f"decode: cache placements {cpl} split more than batch "
                f"and slots")
        bpl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cpl)
        r = sd.axis_rank(dm, "model") if seq else 0
        S_cache = cache.k.shape[1]
        slot = pos % S_cache
        if valid is None:
            valid = cache_valid(pos, S_cache, window, x.device)

        def step(q, k_new, v_new, ck, cv):
            B = q.shape[0]
            positions = torch.full((B, 1), pos, dtype=torch.int32,
                                   device=q.device)
            q, k_new, v_new = self._heads(q, k_new, v_new, positions)
            S_l = ck.shape[1]
            lo = r * S_l
            if lo <= slot < lo + S_l:
                ck[:, slot - lo] = k_new[:, 0].to(ck.dtype)
                cv[:, slot - lo] = v_new[:, 0].to(cv.dtype)
            ok = valid[lo:lo + S_l].to(q.device)
            qd = q[:, 0].to(ck.dtype)
            out = (_split_decode(qd, ck, cv, ok, dm) if seq else
                   _decode_attend(qd, ck, cv, ok, impl))
            return out.reshape(B, 1, -1).to(x.dtype)

        out = local_map(
            step, out_placements=list(bpl), in_placements=(bpl,) * 3 + (cpl,) * 2,
            device_mesh=dm, redistribute_inputs=True)(
                self.q(x), self.k(x), self.v(x), cache.k, cache.v)
        return self.o(out), cache

    def decode(self, x, pos: int, cache: KVCache, window: int,
               valid: torch.Tensor | None = None, impl: str = "kernel"):
        """One token against the cache.  x: (B, 1, D); pos: the token's
        absolute position (a host int).  Writes its K/V at slot
        pos % S_cache in place and attends to the `cache_valid` slots
        (computed here unless the caller passes them).  Returns (out,
        cache)."""
        _check_impl(impl)
        if isinstance(x, DTensor):
            return self._decode_sharded(x, pos, cache, window, valid, impl)
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
        out = _decode_attend(qd, cache.k, cache.v, valid, impl)
        return self.o(out.reshape(B, 1, -1).to(x.dtype)), cache


def _prefill_attend(q, k, v, window: int, impl: str):
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, window=window)
    return fa_ref.flash_attention_ref(q, k, v, window=window)


def _decode_attend(q, k, v, valid, impl: str):
    if impl == "kernel":
        return da_ops.decode_attention(q, k, v, valid)
    return da_ref.decode_attention_ref(q, k, v, valid)


def _split_decode(q, k, v, valid, dmesh):
    """`decode_attention_ref` over a cache whose slots are split over
    the mesh's `model` axis: q (B, H, hd) whole on every rank, k/v
    (B, S_local, KV, hd) and valid (S_local,) this rank's slots.  Each
    rank's softmax partial (its max, sum and weighted V in float32) is
    combined over the axis; equal to the whole-cache softmax up to the
    order of float32 sums."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) * (1.0 / hd ** 0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m_l = s.amax(-1)
    m = sd.all_reduce(m_l, "max", dmesh, "model")
    p = torch.exp(s - m[..., None])
    l = sd.all_reduce(p.sum(-1), "sum", dmesh, "model")
    acc = sd.all_reduce(torch.einsum("bkgt,btkh->bkgh", p, v.float()),
                        "sum", dmesh, "model")
    return (acc / l[..., None]).reshape(B, H, hd).to(q.dtype)


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
