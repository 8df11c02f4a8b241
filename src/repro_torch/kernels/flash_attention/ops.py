"""Public wrapper of the flash-attention (prefill) kernel.

Counterpart of `repro.kernels.flash_attention.ops`.  `flash_attention`
checks device, dtype, shape and contiguity, then dispatches on where
its tensors lie:

* on CUDA it launches `flash_attention.cu` on the current stream (the
  output allocated here with `torch.empty`), raises if the launch
  reports an error, and adds one to `LAUNCHES["flash_attention"]`;
* on the CPU it calls the plain version in `ref.py`;
* anywhere else it raises.

Unlike the reference, Sq and Skv need not be multiples of a block: the
kernel masks its ragged edges.  It requires Sq <= Skv (the causal
diagonal starts at key 0, as in the reference), so that every query row
has a valid key.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (32, 64, 128, 192)   # the kernels' (the plain versions take any)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0}

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
            _LIB = _build.load("flash_attention", {"flash_attention_fwd": [
                _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                _P]})
    return _LIB


def check_head_dim(name, hd):
    """The kernels are built for the head dims of HEAD_DIMS; checked
    where a wrapper launches one (its plain version takes any)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")


def check_attention_inputs(name, q, k, v, q_dims):
    """Shared checks of both attention wrappers: q has `q_dims` dims and
    ends in (H, hd); k/v are (B, S, KV, hd) with H % KV == 0; one dtype
    (float32 or bfloat16), one device, contiguous; on CUDA hd in
    HEAD_DIMS."""
    if q.dim() != q_dims or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (GQA needs H % KV == 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share a dtype in float32, "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"{name}: tensors on {q.device}, {k.device}, "
                         f"{v.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda":
        check_head_dim(name, hd)
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return dev


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd), Sq <= Skv.  Causal
    attention, with a sliding window when window > 0.  Returns
    (B, Sq, H, hd) in q's dtype."""
    dev = check_attention_inputs("flash_attention", q, k, v, 4)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    window = int(window)
    if Sq < 1 or Sq > Skv or window < 0:
        raise ValueError(f"flash_attention: need 1 <= Sq <= Skv and window "
                         f">= 0, got Sq={Sq} Skv={Skv} window={window}")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, window=window)
    lib = _lib()
    out = torch.empty_like(q)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, KV, hd, window, 1.0 / hd ** 0.5, DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(lib, rc, "flash_attention")
    _build.count_launch(LAUNCHES, "flash_attention")
    return out
