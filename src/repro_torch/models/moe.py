"""Mixture-of-experts layer (Arctic 128e/top-2 + dense residual,
Phi-3.5-MoE 16e/top-2).

Counterpart of `repro.models.moe` (`moe_init`/`moe_apply`), with the
reference's sort-based token permutation kept step for step, so that
expert choice, capacity and drops are the reference's exactly:

  1. router: `x @ w` in the model dtype, then a float32 softmax and the
     top k per token, ties to the lower expert index as `lax.top_k`
     gives them (a stable descending sort, then the first k);
  2. gates renormalised: divided by max(sum, 1e-9);
  3. capacity: dropless (every slot kept) when `capacity_factor <= 0`
     or T * k <= 4 E, as in decode steps; otherwise
     int(max(1, round(cf * T * k / E))), Python's `round`;
  4. the (token, k) slots stably sorted by expert, each slot's rank
     within its expert, `keep = rank < capacity`;
  5. kept slots gathered into an (E, C, d) buffer (dropped slots go to a
     spare row past the buffer, so no boolean indexing syncs the host),
     the batched expert products of `_expert_ffn` (`torch.bmm`; the
     reference left them to XLA, outside any Pallas kernel);
  6. combine: each token's k slot outputs times their gates, rounded to
     the model dtype, summed in slot order onto zero.  The reference
     scatter-adds them; with k = 2 its two additions onto zero commute,
     so the fixed-order sum gives its bits, and no atomics
     (`index_add_` on CUDA) make the result vary from run to run.

Arctic's dense residual MLP runs on the same normed input and is added
to the output.  The Switch-style load-balance loss `aux = E *
sum_e(frac_tokens_e * mean_prob_e) * router_aux_weight` is returned
beside the output.

Note the reference's semantics: with a capacity, a token's output
depends on the other tokens of the call (its batch mates), and a
dropless step runs every expert's product, so a decode step reads every
expert's weights.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.common import Dense, param
from repro_torch.models.mlp import MLP


class Routing(NamedTuple):
    """What the router decided for T tokens: (T, k) expert ids and
    renormalised gates; the (T * k,) slots (token * k + j) in expert
    order, their experts, each one's rank in its expert and whether it
    was kept; and the capacity."""
    expert_idx: torch.Tensor
    gates: torch.Tensor
    order: torch.Tensor
    sorted_expert: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    capacity: int


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert keeps for a call of `n_tokens` tokens (the
    reference's rule, `moe.py:93-98`)."""
    m = cfg.moe
    k, E = m.top_k, m.n_experts
    if m.capacity_factor <= 0 or n_tokens * k <= 4 * E:
        return n_tokens * k
    return int(max(1, round(m.capacity_factor * n_tokens * k / E)))


def top_k_lower_index(probs: torch.Tensor, k: int):
    """The k largest values of each row and their indices, equal values
    ordered by index as `lax.top_k` orders them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m = cfg.moe
        d, ff, E = cfg.d_model, cfg.d_ff, m.n_experts
        self.cfg = cfg
        self.activation = cfg.activation
        self.router = Dense(d, E, False, dtype, device,
                            axes=("embed", "experts"))
        self.wi = param((E, d, ff), dtype, device)
        self.wg = (param((E, d, ff), dtype, device)
                   if cfg.activation == "silu_gated" else None)
        self.wo = param((E, ff, d), dtype, device)
        self.residual = (MLP(d, ff, cfg.activation, dtype, device,
                             cfg.mlp_bias) if m.dense_residual else None)
        self.axes = {"wi": ("experts", "embed", "mlp"),
                     "wg": ("experts", "embed", "mlp"),
                     "wo": ("experts", "mlp", "embed")}
        # standard deviations `init_model` draws the expert weights with
        self.in_scale, self.out_scale = 1.0 / d ** 0.5, 1.0 / ff ** 0.5

    def route(self, xt):
        """xt: (T, d) -> (Routing, float32 router probabilities (T, E))."""
        m = self.cfg.moe
        T, k = xt.shape[0], m.top_k
        logits = self.router(xt).float()
        # jax.nn.softmax's steps: exp(x - max), then a division by the sum
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        probs = e / e.sum(-1, keepdim=True)
        gates, expert_idx = top_k_lower_index(probs, k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        cap = capacity(self.cfg, T)
        flat = expert_idx.reshape(-1)
        sorted_expert, order = torch.sort(flat, stable=True)
        # a sorted slot's rank: its position less its expert's first one
        starts = torch.searchsorted(sorted_expert, sorted_expert)
        rank = torch.arange(T * k, device=xt.device) - starts
        return Routing(expert_idx, gates, order, sorted_expert, rank,
                       rank < cap, cap), probs

    def expert_ffn(self, buf):
        """buf: (E, C, d) -> (E, C, d), each expert's own weights."""
        h = torch.bmm(buf, self.wi)
        if self.activation == "silu_gated":
            h = F.silu(h) * torch.bmm(buf, self.wg)
        elif self.activation == "sq_relu":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.wo)

    def forward(self, x):
        """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux float32 ())."""
        m = self.cfg.moe
        B, S, d = x.shape
        T, k, E = B * S, m.top_k, m.n_experts
        xt = x.reshape(T, d)
        r, probs = self.route(xt)

        # Switch-style load balance on the top-1 choice
        frac_tokens = F.one_hot(r.expert_idx[:, 0], E).float().mean(0)
        aux = E * torch.sum(frac_tokens * probs.mean(0)) * m.router_aux_weight

        # dispatch: kept slot (e, rank) -> row e * C + rank of the flat
        # buffer; dropped slots -> the spare row E * C
        cap = r.capacity
        row = torch.where(r.keep, r.sorted_expert * cap + r.rank, E * cap)
        buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
        buf[row] = xt[r.order // k]
        out = self.expert_ffn(buf[:E * cap].view(E, cap, d)).reshape(-1, d)

        # combine: each kept slot's output times its gate, in the model
        # dtype, back in (token, k) order, summed over k onto zero
        slot_out = torch.where(r.keep[:, None],
                               out[torch.where(r.keep, row, 0)], 0.0)
        slot_gate = r.gates.reshape(-1)[r.order]
        contrib = (slot_out * slot_gate[:, None]).to(x.dtype)
        unsort = torch.empty_like(r.order)
        unsort[r.order] = torch.arange(T * k, device=x.device)
        contrib = contrib[unsort].view(T, k, d)
        y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
        for j in range(k):
            y = y + contrib[:, j]
        if self.residual is not None:
            y = y + self.residual(xt)
        return y.reshape(B, S, d), aux
