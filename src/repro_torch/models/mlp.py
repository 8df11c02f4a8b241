"""Feed-forward blocks: SiLU-gated (llama-style), squared-ReLU
(Nemotron-4) and GELU (StarCoder2).  Counterpart of
`repro.models.mlp`; `jax.nn.gelu` defaults to the tanh approximation,
so the port's GELU is `approximate="tanh"`."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Dense

ACTIVATIONS = ("silu_gated", "sq_relu", "gelu")


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str, dtype,
                 device, bias: bool = False):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(activation)
        self.activation = activation
        self.wi = Dense(d_model, d_ff, bias, dtype, device,
                        axes=("embed", "mlp"))
        self.wg = (Dense(d_model, d_ff, bias, dtype, device,
                         axes=("embed", "mlp"))
                   if activation == "silu_gated" else None)
        self.wo = Dense(d_ff, d_model, bias, dtype, device,
                        axes=("mlp", "embed"))

    def forward(self, x):
        h = self.wi(x)
        if self.activation == "silu_gated":
            h = F.silu(h) * self.wg(x)
        elif self.activation == "sq_relu":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        return self.wo(h)
