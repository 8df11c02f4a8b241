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


def decode_attention_split_ref(q, k, v, valid, plan, block=32):
    """The kernel's algorithm, step by step, in float32: the cache cut
    into tiles of `block` keys and the tiles into `plan` = (n_split,
    tiles_per_split) runs, as `ops.split_plan` gives them.  Per split and
    query head an online softmax (m, l, acc) over the split's tiles,
    skipping every tile that holds no valid key (the kernel reads no K
    or V there); then the combine, which returns the mean of V over the
    S positions when no split saw a valid key.  Equal to
    `decode_attention_ref` up to the order of float32 sums: the skipping
    rule changes no result (`decode_attention.cu` says why).  For the
    CPU tests only."""
    n_split, per = plan
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)   # head h reads h // G
    vf = v.float().repeat_interleave(G, dim=2)
    scale = 1.0 / hd ** 0.5
    m = torch.full((B, H, n_split), NEG_INF)
    l = torch.zeros((B, H, n_split))
    acc = torch.zeros((B, H, n_split, hd))
    for t in range(-(-S // block)):
        j0, j1 = t * block, min((t + 1) * block, S)
        ok = valid[j0:j1]
        if not bool(ok.any()):
            continue
        sp = t // per
        s = torch.einsum("bhd,bjhd->bhj", qf, kf[:, j0:j1]) * scale
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m[..., sp], s.amax(-1))
        corr = torch.exp(m[..., sp] - m_new)
        p = torch.exp(s - m_new[..., None])
        l[..., sp] = l[..., sp] * corr + p.sum(-1)
        acc[..., sp, :] = (acc[..., sp, :] * corr[..., None]
                           + torch.einsum("bhj,bjhd->bhd", p, vf[:, j0:j1]))
        m[..., sp] = m_new
    f = torch.exp(m - m.amax(-1, keepdim=True))
    L = (l * f).sum(-1)[..., None]
    out = (acc * f[..., None]).sum(-2) / L.clamp_min(1e-30)
    out = torch.where(L == 0, vf.mean(dim=1), out)
    return out.to(q.dtype)
