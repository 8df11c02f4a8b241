"""Plain float32 building blocks of the references: PyTorch operations
only, no kernel, no cache.  A reference imports this module and
`torch`, nothing of the port.

`Prec` carries the precision a reference computes in: float32 (the
reference), or "fp8", the lower-precision control, in which every
product's two inputs are rounded to float8 e4m3 with one scale a tensor
(its largest magnitude to 448) and the products and everything else run
in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def q8(x):
    """x rounded to float8 e4m3 with one scale for the tensor."""
    s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Prec:
    def __init__(self, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.quant = quant

    def c(self, x):
        return q8(x) if self.quant == "fp8" else x

    def mm(self, a, b):
        return self.c(a) @ self.c(b)


def f32(w: dict, name: str):
    return w[name].float()


def layer_norm(x, scale, bias, eps: float):
    mu = x.mean(-1, keepdim=True)
    c = x - mu
    var = (c * c).mean(-1, keepdim=True)
    return c / torch.sqrt(var + eps) * scale.float() + bias.float()


def rms_norm(x, scale, eps: float):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x, positions, fraction: float, theta: float):
    """Rotary embedding of x (B, S, heads, hd) at `positions` (S,) on its
    first int(hd * fraction) // 2 * 2 dims, rotating the pairs (0, 1),
    (2, 3), ... (the port's layout, a fixed permutation of the
    published rotate-half layout's dims)."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot)
    ang = positions.float()[:, None] * inv            # (S, rot/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.flatten(-2), x[..., rot:]], -1)


def attention(q, k, v, prec: Prec, block: int = 1024):
    """Causal softmax attention with grouped K/V heads.  q (B, S, H, hd),
    k/v (B, S, KV, hd), float32 -> (B, S, H, hd), a batch row and a
    block of queries at a time."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    out = torch.empty_like(q)
    scale = 1.0 / hd ** 0.5
    for b in range(B):
        kb, vb = prec.c(k[b]), prec.c(v[b])           # (S, KV, hd)
        for s0 in range(0, S, block):
            s1 = min(S, s0 + block)
            qb = prec.c(q[b, s0:s1]).view(s1 - s0, KV, G, hd)
            sc = torch.einsum("qkgd,tkd->kgqt", qb, kb[:s1]) * scale
            t = torch.arange(s1, device=q.device)
            qi = torch.arange(s0, s1, device=q.device)
            sc = sc.masked_fill(t[None, :] > qi[:, None], float("-inf"))
            p = torch.softmax(sc, -1)
            o = torch.einsum("kgqt,tkd->qkgd", prec.c(p), vb[:s1])
            out[b, s0:s1] = o.reshape(s1 - s0, H, hd)
    return out


def swiglu(x, wi, wg, wo, prec: Prec):
    """silu(x wi) * (x wg), then wo; weights (in, out) float32."""
    return prec.mm(F.silu(prec.mm(x, wi)) * prec.mm(x, wg), wo)
