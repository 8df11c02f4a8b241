"""Plain PyTorch version of the SSD intra-chunk kernel.

The same function as `ssd_scan.cu` and the reference's Pallas kernel
and oracle (`ssd_intra_ref` of `repro.models.ssm`), in float32: the
decay segment exp(cum_t - cum_s) is masked inside the exponent (-1e9
for s > t, so exp gives exactly 0), the (C . B) kernel is weighted by
the decay and then by dt_s, and the chunk-final state sums
exp(cum_last - cum_s) dt_s (x_s outer B_s).  The CPU path of `ops.py`,
`ssd_chunked(impl="plain")` and the card's comparisons use it; the main
path on a card never does.  `ssd_intra_3xtf32_ref` emulates the rounding
of `ssd_scan.cu`'s tensor-core products for the CPU tests.
"""
from __future__ import annotations

import torch


def ssd_intra_ref(xc, Bc, Cc, dtc, cum):
    """xc: (B,nc,Q,H,P) f32; Bc/Cc: (B,nc,Q,N); dtc/cum: (B,nc,Q,H).
    Returns (y_intra: (B,nc,Q,H,P), chunk_state: (B,nc,H,P,N))."""
    Q = xc.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Qt,Qs,H)
    seg = torch.movedim(seg, -1, 2)                          # (B,nc,H,Qt,Qs)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(mask, seg, torch.full_like(seg, -1e9)))
    kernel = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)         # (B,nc,Qt,Qs)
    W = kernel[:, :, None] * decay                           # (B,nc,H,Qt,Qs)
    W = W * torch.movedim(dtc, -1, 2)[:, :, :, None, :]      # weight by dt_s
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", W, xc)
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc          # (B,nc,Q,H)
    chunk_state = torch.einsum("bcqh,bcqhp,bcqn->bchpn", tail, xc, Bc)
    return y_intra, chunk_state


def tf32_round(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds it; float32 in and out."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, lo):
    """einsum(eq, a, b) from TF32 operands: hi.hi, plus hi.lo and lo.hi
    (lo = the rounded remainder a - hi) when `lo`; the products summed in
    float64 and rounded to float32."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ah.double(), bh.double())
    if lo:
        al, bl = tf32_round(a - ah), tf32_round(b - bh)
        out = (out + torch.einsum(eq, ah.double(), bl.double())
               + torch.einsum(eq, al.double(), bh.double()))
    return out.float()


def ssd_intra_3xtf32_ref(xc, Bc, Cc, dtc, cum, *, lo: bool = True):
    """The rounding of `ssd_scan.cu`'s three products, in plain PyTorch:
    G = C.B^T, y = W x and the state xw^T B each from operands split into
    TF32 hi and lo (3xTF32; `lo=False` keeps hi.hi alone, one TF32
    product), the products exact and summed in float64, then rounded to
    float32; W = (G * decay) * dt_s and xw = x * tail in float32 between
    them, as the kernel forms them.  The card's ex2.approx and its order of
    float32 sums are not emulated.  Same shapes as `ssd_intra_ref`."""
    Q = xc.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Qt,Qs,H)
    seg = torch.movedim(seg, -1, 2)                          # (B,nc,H,Qt,Qs)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.exp(torch.where(mask, seg, torch.full_like(seg, -1e9)))
    G = _tf32_product("bcqn,bckn->bcqk", Cc, Bc, lo)         # (B,nc,Qt,Qs)
    W = G[:, :, None] * decay
    W = W * torch.movedim(dtc, -1, 2)[:, :, :, None, :]
    y_intra = _tf32_product("bchqk,bckhp->bcqhp", W, xc, lo)
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc          # (B,nc,Q,H)
    chunk_state = _tf32_product("bcqhp,bcqn->bchpn", xc * tail[..., None],
                                Bc, lo)
    return y_intra, chunk_state
