"""Serving engine: prefill, then a decode loop over the model.

Counterpart of `repro.serving.engine`.  `generate` takes the first
token from the prefill logits and then runs `n_new - 1` decode steps;
sampling is greedy when `temperature <= 0`, else `torch.multinomial`
with an explicit generator seeded from `seed`.  Once a sequence emits
`eos_id`, every later token of it is `eos_id`.  The loop stays on the
device: positions are host ints known in advance, and no step reads a
value back, so the host only waits when the caller reads the tokens.
Attention and the SSD step always go through the kernels' wrappers;
the per-layer caches (`LayerCache`: KV cache and/or SSM state) are
updated in place by every step.  The reference's
`prefill_step`/`serve_step` exist for its ahead-of-time dry-run
launcher, which the port does not have; callers use `prefill` and
`decode_step` from `repro_torch.models`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import ServeConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import decode_step, prefill
from repro_torch.models.model import Model


class GenState(NamedTuple):
    tokens: torch.Tensor       # (B, n_new) int32 generated ids
    pos: int                   # absolute position of the next input token
    caches: list               # one LayerCache per layer (KV and/or SSM)
    done: torch.Tensor         # (B,) bool
    generator: torch.Generator | None


def _sample(logits, temperature: float, generator):
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _step(model: Model, sc: ServeConfig, state: GenState, i: int
          ) -> GenState:
    tok = state.tokens[:, i:i + 1]
    logits, caches = decode_step(model, tok, state.pos, state.caches)
    nxt = _sample(logits[:, -1], sc.temperature, state.generator)
    nxt = torch.where(state.done, sc.eos_id, nxt.to(torch.int32))
    state.tokens[:, i + 1] = nxt
    return GenState(state.tokens, state.pos + 1, caches,
                    state.done | (nxt == sc.eos_id), state.generator)


@torch.no_grad()
def generate(model: Model, sc: ServeConfig, prompt, n_new: int,
             seed: int = 0, device=DEFAULT_DEVICE):
    """prompt: (B, S_p) ids (array-like or tensor) -> (B, n_new) int32
    generated ids on `device`, where the model must lie."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"generate: model on {model.device}, asked to run "
                         f"on {dev}")
    if n_new < 1:
        raise ValueError(f"generate: n_new must be >= 1, got {n_new}")
    prompt = torch.as_tensor(prompt, dtype=torch.int32).to(model.device)
    B, S_p = prompt.shape
    logits, caches = prefill(model, prompt, sc.max_seq)
    gen = None
    if sc.temperature > 0:
        gen = torch.Generator(device=model.device).manual_seed(seed)
    first = _sample(logits[:, -1], sc.temperature, gen).to(torch.int32)
    tokens = torch.zeros((B, n_new), dtype=torch.int32, device=model.device)
    tokens[:, 0] = first
    state = GenState(tokens, S_p, caches, first == sc.eos_id, gen)
    for i in range(n_new - 1):
        state = _step(model, sc, state, i)
    return state.tokens
