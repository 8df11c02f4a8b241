"""Public wrapper of the flash-decode kernel.

Counterpart of `repro.kernels.decode_attention.ops`.  `decode_attention`
refuses inputs that need a gradient (the kernel is forward-only),
checks device, dtype, shape and contiguity, then dispatches on where
its tensors lie:

* on CUDA it launches `decode_attention.cu` on the current stream (its
  two launches: per-split partials, one CTA per (split, KV head, batch)
  serving the KV head's query heads, then the combine; output and the
  split scratch allocated here with `torch.empty`), raises if a launch
  reports an error, and adds one to `LAUNCHES["decode_attention"]`;
* on the CPU it calls the plain version in `ref.py`;
* anywhere else it raises.

Unlike the reference, the cache length S need not be a multiple of a
block.  On CUDA `valid` must be 16-byte aligned: the kernel reads it in
16-byte words.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.flash_attention.ops import (
    DTYPES,
    check_attention_inputs,
)

BLOCK = 32         # keys a tile (decode_attention.cu TK)
MAX_TILES = 128    # tiles a split holds at most (decode_attention.cu)
SMS = 132          # SMs of an H100 SXM
TARGET_CTAS = 4 * SMS  # partial CTAs over B * KV * n_split

LAUNCHES = {"decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    with _build.LOCK:
        if _LIB is None:
            lib = _build.load("decode_attention", {
                "decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _I, _I, ctypes.c_float, _I,
                                         _P],
                "decode_attention_block": []})
            if lib.decode_attention_block() != BLOCK:
                raise RuntimeError("decode_attention.cu TK disagrees with "
                                   "ops.BLOCK")
            _LIB = lib
    return _LIB


def split_plan(B: int, KV: int, S: int) -> tuple[int, int]:
    """(n_split, tiles_per_split): the cache's tiles of BLOCK keys cut
    into runs of at most MAX_TILES, enough of them that the B * KV *
    n_split partial CTAs reach TARGET_CTAS where the cache has that many
    tiles.  Since n_split >= min(want, n_tiles) / 2, that puts at least
    one CTA on each SM wherever B * KV * n_tiles >= SMS."""
    n_tiles = -(-S // BLOCK)
    want = min(max(1, -(-TARGET_CTAS // (B * KV))), n_tiles)
    per = min(-(-n_tiles // want), MAX_TILES)
    return -(-n_tiles // per), per


def decode_attention(q, k, v, valid):
    """q: (B, H, hd); k/v: (B, S, KV, hd); valid: (S,) bool.  One query
    token per sequence against the cache positions where `valid` holds.
    Returns (B, H, hd) in q's dtype."""
    _build.refuse_autograd("decode_attention", q, k, v)
    dev = check_attention_inputs("decode_attention", q, k, v, 3)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if valid.shape != (S,) or valid.dtype != torch.bool:
        raise ValueError(f"decode_attention: valid must be ({S},) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != dev or not valid.is_contiguous():
        raise ValueError(f"decode_attention: valid must be contiguous on "
                         f"{dev}")
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid)
    if valid.data_ptr() % 16:
        raise ValueError("decode_attention: valid must be 16-byte aligned")
    lib = _lib()
    n_split, per = split_plan(B, KV, S)
    out = torch.empty_like(q)
    part = torch.empty((B, H, n_split, hd + 2), dtype=torch.float32,
                       device=dev)
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, S, H, KV, hd, n_split, per,
        1.0 / hd ** 0.5, DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(lib, rc, "decode_attention")
    _build.count_launch(LAUNCHES, "decode_attention")
    return out
