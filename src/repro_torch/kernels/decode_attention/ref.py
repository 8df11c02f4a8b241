"""Plain PyTorch version of the flash-decode kernel.

The same function as `decode_attention.cu` and the reference's Pallas
kernel: one query token per sequence against the whole cache, scores
scaled by 1/sqrt(hd) after the dot product and masked to -1e30 where
`valid` is false, softmax and the product with V in float32, the result
cast to q's dtype (the Pallas kernel's float32 semantics, not the
reference oracle's bfloat16 einsums).  The CPU path of `ops.py` and the
card's comparisons use it; the main path on a card never does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, valid):
    """q: (B, H, hd); k/v: (B, S, KV, hd); valid: (S,) bool -> (B, H, hd)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) * (1.0 / hd ** 0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, v.float())
    return out.reshape(B, H, hd).to(q.dtype)
