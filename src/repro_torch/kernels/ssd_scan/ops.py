"""Public wrapper of the SSD intra-chunk kernel.

Counterpart of `repro.kernels.ssd_scan.ops`.  `ssd_intra` refuses
inputs that need a gradient (the kernel is forward-only), checks
device, dtype, shape and contiguity, then dispatches on where its
tensors lie:

* on CUDA it launches `ssd_scan.cu` on the current stream (both outputs
  allocated here with `torch.empty`), raises if the launch reports an
  error, and adds one to `LAUNCHES["ssd_intra"]`;
* on the CPU it calls the plain version in `ref.py`;
* anywhere else it raises.

The kernel takes any chunk length 1 <= Q <= 128 (the reference's
`ssd_chunked` gives Q = min(chunk, S)), any state size N and head dims
P <= 64 that are multiples of 4.  One CTA computes C.B^T once for a group
of heads; `heads_per_cta` reports the group size the kernel plans for a
shape on the current card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

MAX_Q = 128   # ssd_scan.cu QM
MAX_P = 64    # ssd_scan.cu PM

LAUNCHES = {"ssd_intra": 0}

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
            lib = _build.load("ssd_scan", {
                "ssd_intra_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _P],
                "ssd_intra_fwd_group": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _P],
                "ssd_intra_group": [_I, _I, _I],
                "ssd_intra_max_q": [], "ssd_intra_max_p": []})
            lim = (lib.ssd_intra_max_q(), lib.ssd_intra_max_p())
            if lim != (MAX_Q, MAX_P):
                raise RuntimeError(f"ssd_scan.cu limits {lim} disagree with "
                                   f"ops ({MAX_Q}, {MAX_P})")
            _LIB = lib
    return _LIB


def _check(xc, Bc, Cc, dtc, cum):
    _build.refuse_autograd("ssd_intra", xc, Bc, Cc, dtc, cum)
    if xc.dim() != 5 or Bc.dim() != 4:
        raise ValueError(f"ssd_intra: xc must be (B,nc,Q,H,P) and Bc "
                         f"(B,nc,Q,N); got {tuple(xc.shape)}, "
                         f"{tuple(Bc.shape)}")
    B, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    if (Bc.shape != (B, nc, Q, N) or Cc.shape != Bc.shape
            or dtc.shape != (B, nc, Q, H) or cum.shape != dtc.shape):
        raise ValueError(f"ssd_intra: shapes disagree: xc {tuple(xc.shape)}, "
                         f"Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}, dtc "
                         f"{tuple(dtc.shape)}, cum {tuple(cum.shape)}")
    if min(B, nc, Q, H, P, N) < 1 or Q > MAX_Q or P > MAX_P or P % 4:
        raise ValueError(f"ssd_intra: need 1 <= Q <= {MAX_Q} and P <= "
                         f"{MAX_P} a multiple of 4; got Q={Q}, P={P}")
    ts = (xc, Bc, Cc, dtc, cum)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_intra: inputs must be float32, got "
                        f"{[t.dtype for t in ts]}")
    dev = xc.device
    if any(t.device != dev for t in ts):
        raise ValueError(f"ssd_intra: tensors on {[t.device for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_intra: unsupported device {dev}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("ssd_intra: tensors must be contiguous")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError("ssd_intra: tensors must be 16-byte aligned")
    return dev


def ssd_intra(xc, Bc, Cc, dtc, cum):
    """xc: (B,nc,Q,H,P) f32; Bc/Cc: (B,nc,Q,N); dtc/cum: (B,nc,Q,H).
    Returns (y_intra: (B,nc,Q,H,P), chunk_state: (B,nc,H,P,N)), both
    float32."""
    dev = _check(xc, Bc, Cc, dtc, cum)
    if dev.type == "cpu":
        return ref.ssd_intra_ref(xc, Bc, Cc, dtc, cum)
    B, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    lib = _lib()
    y = torch.empty_like(xc)
    state = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=dev)
    rc = lib.ssd_intra_fwd(
        xc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), dtc.data_ptr(),
        cum.data_ptr(), y.data_ptr(), state.data_ptr(), B, nc, Q, H, P, N,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(lib, rc, "ssd_intra")
    _build.count_launch(LAUNCHES, "ssd_intra")
    return y, state


def heads_per_cta(B: int, nc: int, H: int) -> int:
    """Heads one CTA of `ssd_scan.cu` takes for B batches of nc chunks of
    H heads on the current CUDA device (its plan: the fewest, at most 8,
    that put all the CTAs in one wave over the card's SMs)."""
    lib = _lib()
    hg = lib.ssd_intra_group(B, nc, H)
    if hg < 1:
        _build.check_rc(lib, -hg, "ssd_intra_group")
    return hg
