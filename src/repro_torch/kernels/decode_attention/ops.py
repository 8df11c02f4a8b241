"""Public wrapper of the flash-decode kernel.

Counterpart of `repro.kernels.decode_attention.ops`.  `decode_attention`
checks device, dtype, shape and contiguity, then dispatches on where
its tensors lie:

* on CUDA it launches `decode_attention.cu` on the current stream (its
  two launches: per-split partials, then the combine; output and the
  split scratch allocated here with `torch.empty`), raises if a launch
  reports an error, and adds one to `LAUNCHES["decode_attention"]`;
* on the CPU it calls the plain version in `ref.py`;
* anywhere else it raises.

Unlike the reference, the cache length S need not be a multiple of a
block.
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

BLOCK = 128        # keys per block (decode_attention.cu DBK)
TARGET_CTAS = 264  # 2 per SM of an H100 SXM

LAUNCHES = {"decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention", {
            "decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _I, _I, ctypes.c_float, _I, _P],
            "decode_attention_block": []})
        if lib.decode_attention_block() != BLOCK:
            raise RuntimeError("decode_attention.cu DBK disagrees with "
                               "ops.BLOCK")
        _LIB = lib
    return _LIB


def split_plan(B: int, H: int, S: int) -> tuple[int, int]:
    """(n_split, blocks_per_split): enough splits of the cache that
    B * H * n_split reaches TARGET_CTAS, each a run of whole blocks."""
    n_blk = -(-S // BLOCK)
    want = min(max(1, -(-TARGET_CTAS // (B * H))), n_blk)
    per = -(-n_blk // want)
    return -(-n_blk // per), per


def decode_attention(q, k, v, valid):
    """q: (B, H, hd); k/v: (B, S, KV, hd); valid: (S,) bool.  One query
    token per sequence against the cache positions where `valid` holds.
    Returns (B, H, hd) in q's dtype."""
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
    lib = _lib()
    n_split, per = split_plan(B, H, S)
    out = torch.empty_like(q)
    part = torch.empty((B, H, n_split, hd + 2), dtype=torch.float32,
                       device=dev)
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, S, H, KV, hd, n_split, per,
        1.0 / hd ** 0.5, DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(lib, rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
