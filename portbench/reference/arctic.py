"""Plain float32 Snowflake Arctic decoder (Snowflake/snowflake-arctic-base):
token embedding; per layer RMSNorm, grouped-query attention (56 query
heads over 8 K/V heads, head 128) with the rotary embedding on every
dim, output projection, residual; RMSNorm, then the sum of a dense
SiLU-gated MLP and a mixture of 128 SiLU-gated experts of which each
token takes its top 2, residual; final RMSNorm and the head.

The router: float32 softmax over the 128 logits, the two largest
probabilities (ties to the lower index), renormalised by their sum (at
least 1e-9).  The configuration's capacity rule: a call of T tokens
keeps every choice when T * k <= 4 E (every decode step of the port),
else each expert keeps its first int(max(1, round(cf * T * k / E)))
choices in token order (the prompt, all of a batch's rows together);
a dropped choice adds nothing.

Departures from the published model, shared with the port: the dense
MLP and the experts read the same normed input after attention (the
published layer runs the experts on the layer's input, beside
attention); the rotary pairs are interleaved (see `stablelm.py`).

Weights are read by the port's parameter names from the tensors the
benchmark drew (`w`), each cast to float32 where it is used, one
expert at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Prec,
    attention,
    f32,
    rms_norm,
    rope,
    swiglu,
)


def capacity(c: dict, n_tokens: int) -> int:
    k, E = c["num_experts_per_tok"], c["num_local_experts"]
    cf = c["port"]["capacity_factor"]
    if cf <= 0 or n_tokens * k <= 4 * E:
        return n_tokens * k
    return int(max(1, round(cf * n_tokens * k / E)))


def route(logits, k: int):
    """(gates (..., k), experts (..., k)) of float32 router logits."""
    probs = torch.softmax(logits, -1)
    g, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    g, idx = g[..., :k], idx[..., :k]
    return g / g.sum(-1, keepdim=True).clamp_min(1e-9), idx


def moe(x, w: dict, p: str, c: dict, prec: Prec, prompt_len: int):
    """x (B, S, d) float32 normed -> (B, S, d): the experts' gated sum
    plus the dense MLP.  The first `prompt_len` positions of every row
    are one call under the capacity rule; the rest are decode steps of
    B tokens each."""
    B, S, d = x.shape
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    logits = prec.mm(x, f32(w, p + "router.w"))
    g, idx = route(logits, k)                                # (B, S, k)
    keep = torch.ones_like(idx, dtype=torch.bool)
    T = B * prompt_len
    if capacity(c, T) < T * k:
        flat = idx[:, :prompt_len].reshape(-1)               # (b, s, j)
        sorted_e, order = torch.sort(flat, stable=True)
        rank = (torch.arange(flat.numel(), device=x.device)
                - torch.searchsorted(sorted_e, sorted_e))
        kept = torch.empty_like(flat, dtype=torch.bool)
        kept[order] = rank < capacity(c, T)
        keep[:, :prompt_len] = kept.view(B, prompt_len, k)
    xt = x.reshape(B * S, d)
    idx, g, keep = idx.reshape(-1, k), g.reshape(-1, k), keep.reshape(-1, k)
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        he = (F.silu(prec.mm(xe, w[p + "wi"][e].float()))
              * prec.mm(xe, w[p + "wg"][e].float()))
        ye = prec.mm(he, w[p + "wo"][e].float())
        y.index_add_(0, tok, ye * g[tok, j, None])
    y = y.view(B, S, d)
    r = p + "residual."
    return y + swiglu(x, f32(w, r + "wi.w"), f32(w, r + "wg.w"),
                      f32(w, r + "wo.w"), prec)


@torch.no_grad()
def forward(w: dict, c: dict, tokens, *, logits_at, prompt_len: int,
            kv_at=None, quant: str | None = None):
    """tokens (B, S): each row's prompt (its first `prompt_len` ids)
    and then the tokens it was served, fed back.  Returns (logits (B,
    len(logits_at), V) float32 at positions `logits_at`, {layer: (k, v)}
    at `kv_at` = (layers, positions) as in `stablelm.forward`)."""
    prec = Prec(quant)
    d, H = c["hidden_size"], c["num_attention_heads"]
    KV, hd = c["num_key_value_heads"], c["hidden_size"] // H
    eps, theta = c["rms_norm_eps"], float(c["rope_theta"])
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    layers, kv_pos = kv_at if kv_at is not None else ((), None)
    h = w["embed"][tokens].float()
    kv = {}
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}."
        x = rms_norm(h, w[p + "norm1.scale"], eps)
        q = rope(prec.mm(x, f32(w, p + "attn.q.w")).view(B, S, H, hd),
                 pos, 1.0, theta)
        k = rope(prec.mm(x, f32(w, p + "attn.k.w")).view(B, S, KV, hd),
                 pos, 1.0, theta)
        v = prec.mm(x, f32(w, p + "attn.v.w")).view(B, S, KV, hd)
        if i in layers:
            kv[i] = (k[:, kv_pos], v[:, kv_pos])
        a = attention(q, k, v, prec).reshape(B, S, H * hd)
        del q, k, v
        h = h + prec.mm(a, f32(w, p + "attn.o.w"))
        x = rms_norm(h, w[p + "norm2.scale"], eps)
        h = h + moe(x, w, p + "moe.", c, prec, prompt_len)
    x = rms_norm(h[:, logits_at], w["final_norm.scale"], eps)
    return prec.mm(x, f32(w, "head")), kv
