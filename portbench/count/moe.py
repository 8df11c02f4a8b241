"""FLOPs and bytes of an MoE decoder with a dense residual MLP (Arctic),
from a configuration file's sizes, for one decode step of B tokens.

Only what the step needs counts: each token's top-k experts (FLOPs) and
the weights of the distinct experts the step's tokens chose (bytes),
never every expert, so a decode that reads only the chosen experts is
still bounded by 100%.  Attention reads the cache's valid positions.
Bytes count each input read once and each output written once."""
from __future__ import annotations

from portbench.count.dense import (
    ELEM,
    head_flops,
    mlp_flops,
    proj_flops,
    sizes,
)


def decode_step_flops(c: dict, batch: int, valid: int) -> int:
    """One decode step of `batch` tokens against `valid` cache
    positions (the new one included)."""
    d, H, KV, hd = sizes(c)
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    per_layer = (proj_flops(c, batch) + 4 * batch * H * hd * valid
                 + 2 * batch * d * E                 # the router
                 + mlp_flops(c, batch)               # the dense MLP
                 + k * mlp_flops(c, batch))          # k experts a token
    return c["num_hidden_layers"] * per_layer + head_flops(c, batch)


def decode_step_bytes(c: dict, batch: int, valid: int,
                      experts_used: list) -> int:
    """Bytes one decode step needs: `experts_used[l]` is the number of
    distinct experts layer l's tokens chose."""
    d, H, KV, hd = sizes(c)
    ff, E, V = c["intermediate_size"], c["num_local_experts"], c["vocab_size"]
    mlp_w = 3 * d * ff
    total = batch * d                                  # embedding rows
    for used in experts_used:
        total += 2 * d                                 # the two norms
        total += d * (2 * H * hd + 2 * KV * hd)        # Q, K, V, O
        total += 2 * batch * valid * KV * hd           # K/V read
        total += 2 * batch * KV * hd                   # new K/V written
        total += d * E                                 # the router
        total += mlp_w                                 # the dense MLP
        total += used * mlp_w                          # chosen experts
    total += d + d * V                                 # final norm, head
    return ELEM * total + 4 * batch * V                # float32 logits
