"""Plain PyTorch version of the flash-attention kernel.

The same function as `flash_attention.cu` and the reference's Pallas
kernel: inputs upcast to float32, scores scaled by 1/sqrt(hd) after the
dot product, masked to -1e30 outside the causal (and sliding-window)
band, softmax and the product with V in float32, the result cast to q's
dtype.  It follows the Pallas kernel's float32 semantics, not the
reference oracle's bfloat16 einsums.  The CPU path of `ops.py` and the
card's comparisons use it; the main path on a card never does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (1.0 / hd ** 0.5)
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = kj <= qi
    if window > 0:
        mask &= kj > qi - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
