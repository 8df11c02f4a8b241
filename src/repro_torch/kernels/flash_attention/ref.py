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


LOG2E = 1.4426950408889634


def flash_attention_mma_ref(q, k, v, *, window: int = 0, bk: int = 64):
    """The rounding of `flash_attention.cu`'s bfloat16 body, in plain
    PyTorch: the online softmax over `bk`-key tiles in the log2 domain,
    S from the bf16 operands (exact products, summed in float64 and
    rounded to float32), P rounded to bf16 before P V, O and the row sums
    (of the unrounded P) in float32, masked scores -inf and a row with no
    valid key yet subtracting 0, the result rounded to bf16.  The card's
    ex2.approx, its fused multiply-add and its order of float32 sums are
    not emulated: the kernel's output lies within one bf16 ulp of this
    one's, where the float32 plain version above lies up to several ulps
    away.  Same shapes as `flash_attention_ref`; q, k, v in bf16."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, dev = H // KV, q.device
    qd = q.double().reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
    kd = k.double().permute(0, 2, 1, 3)[:, :, None]   # (B, KV, 1, Skv, hd)
    vd = v.double().permute(0, 2, 1, 3)[:, :, None]
    # as the wrapper and the kernel form it: float32 scale times log2(e)
    scale_log2 = (torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32)).to(dev)
    m = torch.full((B, KV, G, Sq, 1), -torch.inf, device=dev)
    l = torch.zeros_like(m)
    o = torch.zeros(B, KV, G, Sq, hd, device=dev)
    qi = torch.arange(Sq, device=dev)[:, None]
    for k0 in range(0, Skv, bk):
        kj = torch.arange(k0, min(k0 + bk, Skv), device=dev)[None, :]
        valid = kj <= qi
        if window > 0:
            valid &= kj > qi - window
        s = (qd @ kd[..., k0:k0 + bk, :].transpose(-1, -2)).float()
        s = s.masked_fill(~valid, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        mu = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
        corr = torch.exp2(m - mu)
        p = torch.exp2(s * scale_log2 - mu)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p.to(torch.bfloat16).double() @ vd[..., k0:k0 + bk, :]
        o = o * corr + pv.float()
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(torch.bfloat16)
