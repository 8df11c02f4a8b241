"""Plain float32 StableLM-2 decoder (stabilityai/stablelm-2-1_6b):
token embedding; per layer LayerNorm, Q/K/V with bias, partial rotary
embedding on the first 25% of each head's dims, causal multi-head
attention, output projection, residual, LayerNorm, SiLU-gated MLP,
residual; final LayerNorm and the head.

Departure from the published model, shared with the port: the rotated
dims are taken in interleaved pairs (0, 1), (2, 3), ... rather than
rotate-half's (i, i + rot/2), a fixed permutation of Q's and K's
rotated columns, which random weights cannot tell apart.

Weights are read by the port's parameter names from the tensors the
benchmark drew (`w`), each cast to float32 where it is used.
"""
from __future__ import annotations

import torch

from portbench.reference.common import (
    Prec,
    attention,
    f32,
    layer_norm,
    rope,
    swiglu,
)


@torch.no_grad()
def forward(w: dict, c: dict, tokens, *, logits_at, kv_at=None,
            quant: str | None = None):
    """tokens (B, S) ids.  Returns (logits (B, len(logits_at), V)
    float32 at positions `logits_at`, {layer: (k, v)} each (B, P, KV,
    hd) float32, k after the rotary embedding, for `kv_at` = (layers,
    positions (P,))."""
    prec = Prec(quant)
    d, H = c["hidden_size"], c["num_attention_heads"]
    KV, hd = c["num_key_value_heads"], c["hidden_size"] // H
    eps, frac = c["layer_norm_eps"], c["partial_rotary_factor"]
    theta = float(c["rope_theta"])
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    layers, kv_pos = kv_at if kv_at is not None else ((), None)
    h = w["embed"][tokens].float()
    kv = {}
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}."
        x = layer_norm(h, w[p + "norm1.scale"], w[p + "norm1.bias"], eps)
        q = prec.mm(x, f32(w, p + "attn.q.w")) + f32(w, p + "attn.q.b")
        k = prec.mm(x, f32(w, p + "attn.k.w")) + f32(w, p + "attn.k.b")
        v = prec.mm(x, f32(w, p + "attn.v.w")) + f32(w, p + "attn.v.b")
        q = rope(q.view(B, S, H, hd), pos, frac, theta)
        k = rope(k.view(B, S, KV, hd), pos, frac, theta)
        v = v.view(B, S, KV, hd)
        if i in layers:
            kv[i] = (k[:, kv_pos], v[:, kv_pos])
        a = attention(q, k, v, prec).reshape(B, S, H * hd)
        del q, k, v
        h = h + prec.mm(a, f32(w, p + "attn.o.w"))
        x = layer_norm(h, w[p + "norm2.scale"], w[p + "norm2.bias"], eps)
        h = h + swiglu(x, f32(w, p + "mlp.wi.w"), f32(w, p + "mlp.wg.w"),
                       f32(w, p + "mlp.wo.w"), prec)
    x = layer_norm(h[:, logits_at], w["final_norm.scale"],
                   w["final_norm.bias"], eps)
    return prec.mm(x, f32(w, "head")), kv
