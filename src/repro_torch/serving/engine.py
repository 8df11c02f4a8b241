"""Serving engine: prefill, then a decode loop over the model.

Counterpart of `repro.serving.engine`.  `generate` takes the first
token from the prefill logits and then runs `n_new - 1` decode steps;
sampling is greedy when `temperature <= 0`, else `torch.multinomial`
with an explicit generator seeded from `seed`.  Once a sequence emits
`eos_id`, every later token of it is `eos_id`.  The loop stays on the
device: positions are host ints known in advance, and no step reads a
value back, so the host only waits when the caller reads the tokens.
A vision or audio model's prefix embeddings (`prefix_embeds`, B x
prefix_len x d_model) go ahead of the prompt in the prefill, and decode
continues at position S_p + prefix_len, as in the reference.
Attention and the SSD step always go through the kernels' wrappers;
the per-layer caches (`LayerCache`: KV cache and/or SSM state) are
updated in place by every step.  `prefill_step` and `serve_step` are
the step functions the dry run (`repro_torch.launch.specs`) builds for
the prefill and decode shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import ServeConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import decode_step, prefill
from repro_torch.models.model import Model


def prefill_step(model: Model, tokens, max_seq: int, prefix_embeds=None,
                 impl: str = "kernel"):
    """Step of the prefill shapes: (last-position logits, caches)."""
    return prefill(model, tokens, max_seq, impl, prefix_embeds)


def serve_step(model: Model, token, pos: int, caches, impl: str = "kernel"):
    """Step of the decode shapes: ONE new token against the caches."""
    return decode_step(model, token, pos, caches, impl)


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
             seed: int = 0, device=DEFAULT_DEVICE, prefix_embeds=None):
    """prompt: (B, S_p) ids (array-like or tensor) -> (B, n_new) int32
    generated ids on `device`, where the model must lie.  prefix_embeds:
    (B, prefix_len, d_model) (array-like or tensor), or None."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"generate: model on {model.device}, asked to run "
                         f"on {dev}")
    if n_new < 1:
        raise ValueError(f"generate: n_new must be >= 1, got {n_new}")
    prompt = torch.as_tensor(prompt, dtype=torch.int32).to(model.device)
    B, S_p = prompt.shape
    if prefix_embeds is not None:
        prefix_embeds = torch.as_tensor(prefix_embeds).to(model.device)
    logits, caches = prefill(model, prompt, sc.max_seq,
                             prefix_embeds=prefix_embeds)
    pos0 = S_p + (model.cfg.prefix_len if prefix_embeds is not None else 0)
    gen = None
    if sc.temperature > 0:
        gen = torch.Generator(device=model.device).manual_seed(seed)
    first = _sample(logits[:, -1], sc.temperature, gen).to(torch.int32)
    tokens = torch.zeros((B, n_new), dtype=torch.int32, device=model.device)
    tokens[:, 0] = first
    state = GenState(tokens, pos0, caches, first == sc.eos_id, gen)
    for i in range(n_new - 1):
        state = _step(model, sc, state, i)
    return state.tokens
