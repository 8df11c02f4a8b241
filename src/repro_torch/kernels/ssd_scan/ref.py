"""Plain PyTorch version of the SSD intra-chunk kernel.

The same function as `ssd_scan.cu` and the reference's Pallas kernel
and oracle (`ssd_intra_ref` of `repro.models.ssm`), in float32: the
decay segment exp(cum_t - cum_s) is masked inside the exponent (-1e9
for s > t, so exp gives exactly 0), the (C . B) kernel is weighted by
the decay and then by dt_s, and the chunk-final state sums
exp(cum_last - cum_s) dt_s (x_s outer B_s).  The CPU path of `ops.py`,
`ssd_chunked(impl="plain")` and the card's comparisons use it; the main
path on a card never does.
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
