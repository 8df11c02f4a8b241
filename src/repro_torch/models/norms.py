"""RMSNorm / LayerNorm, computed in float32 whatever the parameter
dtype.  Counterpart of `repro.models.norms`: `eps = 1e-5`, division by
the square root (not a reciprocal-root product), and LayerNorm's
population variance (`jnp.var`), not torch's unbiased default."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import param
from repro_torch.sharding.dist import gathered


def rms_norm(x, scale, eps: float):
    """RMSNorm of x's last dim in float32, cast back to x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf / torch.sqrt(ms + eps)
    return (y * scale.float()).to(x.dtype)


class Norm(nn.Module):
    """`axis`: the logical axis of the normalised dimension (the SSM
    mixer's gated norm runs over `ssm_inner`)."""

    def __init__(self, d: int, kind: str, dtype, device, eps: float = 1e-5,
                 axis: str = "embed"):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(kind)
        self.kind, self.eps = kind, eps
        self.axes = {"scale": (axis,), "bias": (axis,)}
        self.scale = param((d,), dtype, device, 1.0)
        self.bias = (param((d,), dtype, device, 0.0) if kind == "layernorm"
                     else None)

    def forward(self, x):
        if self.kind == "rmsnorm":
            return rms_norm(x, gathered(self.scale), self.eps)
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        c = xf - mu
        var = (c * c).mean(-1, keepdim=True)
        y = c / torch.sqrt(var + self.eps)
        y = y * gathered(self.scale).float() + gathered(self.bias).float()
        return y.to(x.dtype)
