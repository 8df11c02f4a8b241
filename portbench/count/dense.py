"""FLOPs and bytes of a dense decoder (StableLM-2), from a configuration
file's sizes.  A product of (m, n) by (n, p) is 2 m n p FLOPs; causal
attention over S positions computes S (S + 1) / 2 query-key pairs, each
4 hd FLOPs a head (the scores and the weighted sum of V).  Bytes count
each input read once and each output written once, at `ELEM` bytes an
element (the served dtype)."""
from __future__ import annotations

ELEM = 2   # bytes of a bf16 element


def sizes(c: dict):
    d, H = c["hidden_size"], c["num_attention_heads"]
    return d, H, c["num_key_value_heads"], d // H


def proj_flops(c: dict, tokens: int) -> int:
    """Q, K, V and the output projection over `tokens` tokens."""
    d, H, KV, hd = sizes(c)
    return 2 * tokens * d * (2 * H * hd + 2 * KV * hd)


def mlp_flops(c: dict, tokens: int) -> int:
    """A SiLU-gated MLP (three products) over `tokens` tokens."""
    return 2 * tokens * 3 * c["hidden_size"] * c["intermediate_size"]


def causal_attn_flops(c: dict, batch: int, seq: int) -> int:
    d, H, KV, hd = sizes(c)
    return 4 * batch * H * hd * (seq * (seq + 1) // 2)


def head_flops(c: dict, tokens: int) -> int:
    return 2 * tokens * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: dict, batch: int, seq: int) -> int:
    """One prefill of `batch` prompts of `seq` tokens: every layer over
    every position, the head at the last position only (the port's
    `prefill` returns the last position's logits)."""
    T = batch * seq
    per_layer = (proj_flops(c, T) + causal_attn_flops(c, batch, seq)
                 + mlp_flops(c, T))
    return c["num_hidden_layers"] * per_layer + head_flops(c, batch)


def flash_call(c: dict, batch: int, seq: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one causal flash-attention call: Q, K, V read
    once, the output written once."""
    d, H, KV, hd = sizes(c)
    n_bytes = ELEM * batch * seq * hd * (2 * H + 2 * KV)
    return causal_attn_flops(c, batch, seq), n_bytes
