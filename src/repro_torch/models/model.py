"""Decoder LM: embeddings -> the blocks -> the head.

Counterpart of `repro.models.model` for serving: `Model` (an
`nn.Module` with an `nn.ModuleList` of blocks), `init_model`, and the
two serving entry points

  * prefill     : logits for the prompt's last position + decode caches
  * decode_step : one token against the caches (updated in place)

Caches are a list with one `LayerCache` per layer: the layer's
`KVCache` (attention and hybrid layers; a compact ring of size
`min(window, max_seq)` for windowed dense archs, otherwise a linear
buffer of `max_seq` positions, which hybrid archs keep so that their
global layers see every position) and its `SSMState` (ssm and hybrid
layers), the other None.  Archs without RoPE (Mamba2, MusicGen) add
absolute sinusoidal positions to the embeddings, in prefill and at the
true position in decode.

The vision and audio frontends are stubs, as in the reference: the
caller passes `prefix_embeds` (B, prefix_len, d_model), the patch or
frame embeddings a real encoder would produce, and `prefill`
concatenates them ahead of the token embeddings; positions run over
prefix and text.  `forward_train` and `lm_loss` come with the training
slice (ROADMAP queue A9).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.attention import KVCache, cache_valid, init_cache
from repro_torch.models.blocks import Block, LayerCache, layer_window
from repro_torch.models.common import Dense, dtype_of, normal_, param
from repro_torch.models.moe import MoE
from repro_torch.models.norms import Norm
from repro_torch.models.rope import sinusoidal_embed
from repro_torch.models.ssm import SSM, init_ssm_state


class Model(nn.Module):
    """The parameters of one architecture, uninitialised (`init_model`
    draws them; `repro_torch.bridge.params_from_jax` copies the
    reference's)."""

    def __init__(self, cfg: ModelConfig, device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype_of(cfg.dtype)
        self.cfg = cfg
        self.embed = param((cfg.padded_vocab, cfg.d_model), dtype, dev)
        self.blocks = nn.ModuleList(Block(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.head = (None if cfg.tie_embeddings else
                     param((cfg.d_model, cfg.padded_vocab), dtype, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_model(cfg: ModelConfig, generator: torch.Generator | None = None,
               device=DEFAULT_DEVICE) -> Model:
    """A model with seeded random weights, drawn as the reference's
    `init_model` draws them: every dense weight normal * 1/sqrt(in) (the
    attention out-projection normal * 1/sqrt(H*hd) / sqrt(2L)), the
    embedding and head normal * 1/sqrt(d_model), biases 0, norm scales
    1; the experts' `wi`/`wg` normal * 1/sqrt(d_model) and `wo`
    normal * 1/sqrt(d_ff); the SSM mixer's `conv_w` normal *
    1/sqrt(conv_width) and its `A_log`, `D`, `dt_bias` and `conv_b` as
    `SSM` sets them.  Draws come
    from `generator` on its own device (a CUDA generator draws a
    full-width model on the card); the numbers differ from
    `jax.random`'s, so parity tests carry the reference's parameters
    over with `params_from_jax` instead."""
    model = Model(cfg, device)
    g = generator if generator is not None else torch.Generator()
    scale = 1.0 / cfg.d_model ** 0.5
    normal_(model.embed, g, scale)
    for mod in model.modules():
        if isinstance(mod, Dense):
            normal_(mod.w, g, mod.init_scale)
        elif isinstance(mod, MoE):
            for w in (mod.wi, mod.wg):
                if w is not None:
                    normal_(w, g, mod.in_scale)
            normal_(mod.wo, g, mod.out_scale)
        elif isinstance(mod, SSM):
            normal_(mod.conv_w, g, mod.conv_w_scale)
    if model.head is not None:
        normal_(model.head, g, scale)
    return model


def _embed(model: Model, tokens, pos0: int = 0, prefix_embeds=None):
    """tokens: (B, S_txt) integer ids; prefix_embeds: (B, P, D) or None,
    placed ahead of them.  Returns (h (B, S, D), positions (B, S)) for
    the S = P + S_txt positions pos0.., with sinusoidal positions added
    when the arch has no RoPE."""
    h = model.embed[tokens]
    if prefix_embeds is not None:
        cfg = model.cfg
        B = tokens.shape[0]
        if tuple(prefix_embeds.shape) != (B, cfg.prefix_len, cfg.d_model):
            raise ValueError(
                f"{cfg.name}: prefix_embeds must be ({B}, {cfg.prefix_len}, "
                f"{cfg.d_model}), got {tuple(prefix_embeds.shape)}")
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    B, S = h.shape[:2]
    positions = (pos0 + torch.arange(S, dtype=torch.int32,
                                     device=tokens.device)).expand(B, S)
    if not model.cfg.rope:  # MusicGen-style absolute positions
        h = h + sinusoidal_embed(positions, model.cfg.d_model, h.dtype)
    return h, positions


def _head(model: Model, h):
    cfg = model.cfg
    h = model.final_norm(h)
    w = model.embed.T if model.head is None else model.head
    logits = (h @ w).float()
    if cfg.padded_vocab != cfg.vocab:  # mask the alignment padding
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab
        logits = logits.masked_fill(pad, float("-inf"))
    return logits


def _ring_from_linear(k, S: int, window: int):
    """The last `window` positions of a linear (B, S, KV, hd) K/V in ring
    layout (slot = pos % window)."""
    if S <= window:
        pad = torch.zeros((k.shape[0], window - S, *k.shape[2:]),
                          dtype=k.dtype, device=k.device)
        return torch.cat([k, pad], dim=1)  # slots 0..S-1 valid
    return torch.roll(k[:, S - window:], S % window, dims=1)


def _uses_ring(cfg: ModelConfig) -> bool:
    return cfg.sliding_window > 0 and cfg.arch_type != "hybrid"


def _has_kv(cfg: ModelConfig) -> bool:
    return cfg.arch_type != "ssm"


def _has_ssm(cfg: ModelConfig) -> bool:
    return cfg.arch_type in ("ssm", "hybrid")


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device=DEFAULT_DEVICE) -> list[LayerCache]:
    """Empty decode caches, one `LayerCache` per layer."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    window = cfg.sliding_window if _uses_ring(cfg) else 0
    return [LayerCache(
        init_cache(cfg, batch, max_seq, window, dtype, dev)
        if _has_kv(cfg) else None,
        init_ssm_state(cfg, batch, dtype, dev) if _has_ssm(cfg) else None)
        for _ in range(cfg.n_layers)]


@torch.no_grad()
def prefill(model: Model, tokens, max_seq: int, impl: str = "kernel",
            prefix_embeds=None):
    """Run the prompt (B, S_txt), after `prefix_embeds` (B, prefix_len,
    d_model) when given: returns (last-position logits (B, 1, V)
    float32, decode caches holding prefix and text)."""
    cfg = model.cfg
    h, positions = _embed(model, tokens, prefix_embeds=prefix_embeds)
    S = h.shape[1]
    ring = _uses_ring(cfg)
    if _has_kv(cfg) and not ring and S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    dtype = dtype_of(cfg.dtype)
    caches = []
    for i, blk in enumerate(model.blocks):
        h, kv, st = blk.prefill(h, positions, layer_window(cfg, i), impl)
        if kv is not None:
            k, v = kv
            if ring:
                w = min(cfg.sliding_window, max_seq)
                k, v = _ring_from_linear(k, S, w), _ring_from_linear(v, S, w)
            else:
                pad = (0, 0, 0, 0, 0, max_seq - S)
                k = torch.nn.functional.pad(k, pad)
                v = torch.nn.functional.pad(v, pad)
            kv = KVCache(k.to(dtype).contiguous(), v.to(dtype).contiguous())
        caches.append(LayerCache(kv, st))
    return _head(model, h[:, -1:]), caches


@torch.no_grad()
def decode_step(model: Model, token, pos: int, caches: list[LayerCache],
                impl: str = "kernel"):
    """One decode step.  token: (B, 1) ids; pos: its absolute position (a
    host int, so the step needs no read-back); caches: as `prefill`
    returns them, updated in place.  Returns (logits (B, 1, V) float32,
    caches)."""
    cfg = model.cfg
    pos = int(pos)
    h, _ = _embed(model, token, pos)
    valid = {}  # one mask per (window, cache length), shared by the layers
    for i, (blk, cache) in enumerate(zip(model.blocks, caches)):
        w = layer_window(cfg, i)
        mask = None
        if cache.kv is not None:
            key = (w, cache.kv.k.shape[1])
            if key not in valid:
                valid[key] = cache_valid(pos, key[1], w, h.device)
            mask = valid[key]
        h, _ = blk.decode(h, pos, cache, w, mask, impl)
    return _head(model, h), caches
