"""Train step: gradients of `lm_loss` under autograd, then AdamW.

Counterpart of `repro.training.train_step`.  The loss runs the plain
path (`impl="plain"`, the reference's `impl="xla"`) with `remat` as the
config sets it.  Whole-batch gradients come out in the parameter dtype;
with `microbatches > 1` the batch is cut into that many equal slices
along its first axis, and each slice's gradients, divided by the count
in their own dtype, are added into float32 buffers, as the reference's
`lax.scan` adds them.  A step reads nothing back to the host: its
metrics (`loss`, `grad_norm`, `lr`) are 0-d float32 tensors on the
device, and the caller syncs when it reads one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.model import Model, lm_loss
from repro_torch.training import adamw


class TrainState(NamedTuple):
    model: Model             # the parameters, in the model's dtype
    opt: adamw.AdamWState


def init_train_state(model: Model, tc: TrainConfig,
                     device=DEFAULT_DEVICE) -> TrainState:
    """Switch on gradients for `model`'s parameters and give it a fresh
    AdamW state.  The model must lie on `device` (CUDA unless the caller
    names another)."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"init_train_state: model on {model.device}, "
                         f"asked to train on {dev}")
    model.requires_grad_(True)
    return TrainState(model, adamw.init(model))


def _loss(model: Model, batch: dict, tc: TrainConfig) -> torch.Tensor:
    return lm_loss(model, batch["tokens"], batch["labels"],
                   batch.get("prefix_embeds"), impl="plain", remat=tc.remat)


def _grads(model: Model, batch: dict, tc: TrainConfig):
    """(loss, name -> gradient): whole-batch or microbatched."""
    params = dict(model.named_parameters())
    n = tc.microbatches
    if n <= 1:
        model.zero_grad(set_to_none=True)
        loss = _loss(model, batch, tc)
        loss.backward()
        return loss.detach(), {
            k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in params.items()}

    B = batch["tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch of {B} does not split into {n} microbatches")
    b = B // n
    loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    for i in range(n):
        micro = {k: x[i * b:(i + 1) * b] for k, x in batch.items()}
        model.zero_grad(set_to_none=True)
        loss = _loss(model, micro, tc)
        loss.backward()
        loss_acc = loss_acc + loss.detach() / n
        for k, p in params.items():
            if p.grad is not None:
                acc[k].add_(p.grad / n)
    return loss_acc, acc


def train_step(state: TrainState, batch: dict, tc: TrainConfig):
    """One step on `batch` ({"tokens", "labels"} (B, S) integer tensors
    and, for a prefixed arch, "prefix_embeds" (B, P, d_model), all on
    the model's device).  Updates the model and the optimizer state in
    place; returns (state, {"loss", "grad_norm", "lr"})."""
    model = state.model
    for k, x in batch.items():
        if not isinstance(x, torch.Tensor) or x.device != model.device:
            raise ValueError(f"train_step: batch[{k!r}] must be a tensor on "
                             f"{model.device}")
    loss, grads = _grads(model, batch, tc)
    _, metrics = adamw.apply(state.opt, grads, tc,
                             dict(model.named_parameters()))
    del grads
    model.zero_grad(set_to_none=True)
    return state, {"loss": loss, **metrics}
