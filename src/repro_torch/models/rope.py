"""Rotary position embeddings with partial-rotary support (StableLM
rotates 25% of the head dim), and the absolute sinusoidal embeddings of
archs without RoPE (Mamba2).  Counterpart of `repro.models.rope`:
`rot_dim = int(hd * fraction) // 2 * 2`, and the rotated pairs are
interleaved (`0::2` with `1::2`), not the half-split convention."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    rot_dim = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=device) / rot_dim))
    return inv, rot_dim


def apply_rope(x, positions, fraction: float = 1.0, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S) integer absolute
    positions."""
    inv, rot_dim = rope_freqs(x.shape[-1], fraction, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., None].float() * inv         # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]               # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, x[..., rot_dim:]], dim=-1)


def sinusoidal_embed(positions, d_model: int, dtype=torch.float32):
    """Absolute sinusoidal position embeddings (MusicGen-style):
    positions (..., S) -> (..., S, d_model), sines then cosines, computed
    in float32 and cast to `dtype`."""
    half = d_model // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
