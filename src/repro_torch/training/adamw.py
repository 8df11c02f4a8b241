"""AdamW with float32 master weights and moments.

Counterpart of `repro.training.adamw`.  The state holds, for each of the
model's parameters by name (`named_parameters()` order), a float32
master copy and both moments; `apply` updates them in place under
`torch.no_grad()` and writes the new master values back into the
parameters in the model's dtype.  The arithmetic is the reference's,
operation for operation in float32: the global-norm clip, bias
correction, the update `master - lr * (mh / (sqrt(vh) + eps) + wd *
master)` with decoupled weight decay.  The step count, the learning
rate, the norm and the clip stay 0-d tensors on the parameters' device,
so an update reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.config import TrainConfig


class AdamWState(NamedTuple):
    step: torch.Tensor                # () int32
    master: dict[str, torch.Tensor]   # float32 copy of each parameter
    m: dict[str, torch.Tensor]        # float32 first moment
    v: dict[str, torch.Tensor]        # float32 second moment


def init(model: torch.nn.Module) -> AdamWState:
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master={k: p.detach().to(torch.float32, copy=True)
                for k, p in params.items()},
        m={k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in params.items()},
    )


def lr_schedule(tc: TrainConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in float32 (a 0-d tensor
    on `step`'s device when `step` is a tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(tc.warmup_steps, 1)
    frac = torch.clamp(
        (s - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * frac))
    return tc.lr * torch.where(s < tc.warmup_steps, warm, cos)


def leaf_groups(names) -> list[list[str]]:
    """The port's parameter names grouped into the reference's leaves,
    in the order `jax.tree.leaves` visits them: `blocks.<i>.<rest>` is
    layer i of the stacked leaf `blocks/<rest>`, and leaves go in the
    sorted order of their key paths (a dict's keys are sorted)."""
    groups: dict[tuple, list[str]] = {}
    for name in names:
        parts = name.split(".")
        key = ("blocks", *parts[2:]) if parts[0] == "blocks" else tuple(parts)
        groups.setdefault(key, []).append(name)
    return [groups[k] for k in sorted(groups)]


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed as the reference sums:
    leaf by leaf in its leaf order, a stacked leaf's layers in order."""
    total = None
    for group in leaf_groups(grads):
        for name in group:
            sq = torch.sum(torch.square(grads[name].float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(state: AdamWState, grads: dict[str, torch.Tensor],
          tc: TrainConfig, params: dict[str, torch.Tensor]):
    """One AdamW update, in place.  grads: name -> gradient (in the
    parameter dtype, or float32); params: name -> the tensor that takes
    the new master value in its own dtype (the model's parameters).
    Returns (state, {"grad_norm", "lr"}), both 0-d float32 tensors."""
    state.step.add_(1)
    gnorm = global_norm(grads)
    clip = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(tc, state.step)
    b1, b2, eps, wd = tc.b1, tc.b2, tc.eps, tc.weight_decay
    step = state.step.to(torch.float32)
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for name, p in params.items():
        master, m, v = state.master[name], state.m[name], state.v[name]
        g = grads[name].float() * clip
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        upd.add_(master * wd)
        master.sub_(upd.mul_(lr))
        p.copy_(master)
    return state, {"grad_norm": gnorm, "lr": lr}
