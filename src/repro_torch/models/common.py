"""Parameter utilities of the model substrate.

Counterpart of `repro.models.common`.  The reference keeps parameters as
nested dicts of arrays with `(in, out)` dense weights applied as
`x @ w (+ b)`; the port keeps the same layout inside `nn.Module`s, so
`repro_torch.bridge.params_from_jax` can copy the reference's leaves
one for one.  Parameters are created without gradients: this slice
serves, and training is a later one.
"""
from __future__ import annotations

import torch
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param(shape, dtype, device, fill: float | None = None) -> nn.Parameter:
    """A parameter without gradient, uninitialised unless `fill` is
    given."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


# elements of the largest float32 draw `normal_` makes at once (1 GiB)
DRAW_CHUNK = 1 << 28


def normal_(p: torch.Tensor, generator: torch.Generator, scale: float):
    """Fill `p` with normal draws times `scale`, drawn in float32 on the
    generator's device (the reference draws `normal * scale` in the
    parameter dtype; the distribution is the same).  A tensor of more
    than DRAW_CHUNK elements is drawn in slices along its first axis, so
    that a full-width expert stack or embedding needs no float32 copy of
    itself on the card."""
    parts = [p]
    if p.numel() > DRAW_CHUNK:
        parts = p.split(max(1, DRAW_CHUNK // p[0].numel()))
    for part in parts:
        draw = torch.randn(part.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
        part.copy_(draw.mul_(scale))


class Dense(nn.Module):
    """`y = x @ w (+ b)` with an `(in, out)` weight, as `dense_apply`.

    `init_scale` is the standard deviation `init_model` draws `w` with:
    1/sqrt(in) unless the owner sets another (the attention
    out-projection does)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, dtype, device):
        super().__init__()
        self.w = param((d_in, d_out), dtype, device)
        self.b = param((d_out,), dtype, device, 0.0) if bias else None
        self.init_scale = 1.0 / d_in ** 0.5

    def forward(self, x):
        y = x @ self.w
        if self.b is not None:
            y = y + self.b
        return y
