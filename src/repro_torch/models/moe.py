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
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ModelConfig
from repro_torch.models.common import Dense, param
from repro_torch.models.mlp import MLP
from repro_torch.sharding import dist as sd


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

    def route(self, xt, rw=None):
        """xt: (T, d) -> (Routing, float32 router probabilities (T, E)).
        rw: the router's weight as a plain tensor (a sharded step's
        whole copy); the layer's own router by default."""
        m = self.cfg.moe
        T, k = xt.shape[0], m.top_k
        logits = (self.router(xt) if rw is None else xt @ rw).float()
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

    def expert_ffn(self, buf, wi=None, wg=None, wo=None):
        """buf: (E, C, d) -> (E, C, d), each expert's own weights (the
        layer's, unless a slice of the experts' is given)."""
        if wi is None:
            wi, wg, wo = self.wi, self.wg, self.wo
        h = torch.bmm(buf, wi)
        if self.activation == "silu_gated":
            h = F.silu(h) * torch.bmm(buf, wg)
        elif self.activation == "sq_relu":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, wo)

    def _dispatch(self, xt, r, row, n_experts: int, C: int, *w):
        """The experts' outputs (n_experts * C, d) for the slots placed
        at `row` of the flat (n_experts * C + 1, d) buffer (dropped slots
        at its spare last row), with the experts' weights `w` (the
        layer's own by default)."""
        d = xt.shape[1]
        buf = torch.zeros((n_experts * C + 1, d), dtype=xt.dtype,
                          device=xt.device)
        buf[row] = xt[r.order // self.cfg.moe.top_k]
        return self.expert_ffn(buf[:n_experts * C].view(n_experts, C, d),
                               *w).reshape(-1, d)

    @staticmethod
    def _combine(r, out, kept, row, dtype):
        """Each kept slot's output times its gate, in the model dtype,
        back in (token, k) order, summed over k onto zero."""
        T, k = r.expert_idx.shape
        slot_out = torch.where(kept[:, None], out[torch.where(kept, row, 0)],
                               0.0)
        slot_gate = r.gates.reshape(-1)[r.order]
        contrib = (slot_out * slot_gate[:, None]).to(dtype)
        unsort = torch.empty_like(r.order)
        unsort[r.order] = torch.arange(T * k, device=out.device)
        contrib = contrib[unsort].view(T, k, -1)
        y = torch.zeros((T, contrib.shape[-1]), dtype=dtype,
                        device=out.device)
        for j in range(k):
            y = y + contrib[:, j]
        return y

    def forward(self, x):
        """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux float32 ())."""
        if isinstance(x, DTensor):
            return self._forward_sharded(x)
        m = self.cfg.moe
        B, S, d = x.shape
        T, E = B * S, m.n_experts
        xt = x.reshape(T, d)
        r, probs = self.route(xt)

        # Switch-style load balance on the top-1 choice
        frac_tokens = F.one_hot(r.expert_idx[:, 0], E).float().mean(0)
        aux = E * torch.sum(frac_tokens * probs.mean(0)) * m.router_aux_weight

        # dispatch: kept slot (e, rank) -> row e * C + rank of the flat
        # buffer; dropped slots -> the spare row E * C
        cap = r.capacity
        row = torch.where(r.keep, r.sorted_expert * cap + r.rank, E * cap)
        out = self._dispatch(xt, r, row, E, cap)
        y = self._combine(r, out, r.keep, row, x.dtype)
        if self.residual is not None:
            y = y + self.residual(xt)
        return y.reshape(B, S, d), aux

    # --- a sharded step ------------------------------------------------

    def _forward_sharded(self, x):
        """`forward` on a DTensor x whose batch is split over some mesh
        axes, the experts over another (expert parallelism).  Each rank
        routes its own tokens with the whole router, and every slot's
        fate is the unsharded call's: a slot's rank in its expert is its
        rank among this rank's slots plus the count of that expert's
        slots on the batch ranks before it (an all-gather of (E,)
        counts), kept when below the capacity of all B * S tokens.  The
        rank then runs its own experts on its kept slots (a product's
        rows do not depend on each other, so each kept slot's output is
        the unsharded one) and sums their gated outputs: a partial sum
        over the experts' axis.  The aux loss sums each rank's tokens'
        probabilities against the global top-1 fractions (an all-reduce
        of (E,) counts): a partial sum over the batch axes, taken on the
        first rank of the experts' axis alone."""
        m = self.cfg.moe
        B, S, d = x.shape
        E, k = m.n_experts, m.top_k
        dm = x.device_mesh
        names = dm.mesh_dim_names
        bpl = sd.batch_placements(x)
        b_axes = sd.batch_axes(bpl, dm)
        wi, wo = sd.gathered(self.wi), sd.gathered(self.wo)
        wg = sd.gathered(self.wg) if self.wg is not None else None
        wpl = tuple(wi.placements)
        e_axes = [n for n, p in zip(names, wpl) if p.is_shard(0)]
        if len(e_axes) > 1:
            raise NotImplementedError("moe: experts split over two axes")
        e_axis = e_axes[0] if e_axes else None
        E_l = wi.to_local().shape[0]
        e0 = sd.axis_rank(dm, e_axis) * E_l if e_axis else 0
        first = e_axis is None or sd.axis_rank(dm, e_axis) == 0
        # this rank's index among the batch ranks, rows in mesh order
        b_idx = 0
        for n in b_axes:
            b_idx = b_idx * sd.axis_size(dm, n) + sd.axis_rank(dm, n)
        cap = capacity(self.cfg, B * S)
        rw = sd.gathered(self.router.w)
        rw = rw.redistribute(dm, (Replicate(),) * dm.ndim)
        repl = (Replicate(),) * dm.ndim

        def local(x, rw, wi, wg, wo):
            b = x.shape[0]
            T = b * S
            xt = x.reshape(T, d)
            r, probs = self.route(xt, rw)
            ones = torch.ones_like(r.sorted_expert)
            counts = torch.zeros(E, dtype=ones.dtype, device=x.device
                                 ).scatter_add_(0, r.sorted_expert, ones)
            every = counts[None]
            for n in reversed(b_axes):   # (n_batch_ranks, E), in order
                every = sd.all_gather(every, dm, n).flatten(0, 1)
            before = every[:b_idx].sum(0)
            ex = r.sorted_expert
            mine = ((r.rank + before[ex] < cap) & (ex >= e0)
                    & (ex < e0 + E_l))
            C = min(cap, T * k)
            row = torch.where(mine, (ex - e0) * C + r.rank, E_l * C)
            out = self._dispatch(xt, r, row, E_l, C, wi, wg, wo)
            y = self._combine(r, out, mine, row, x.dtype)
            top1 = torch.zeros(E, dtype=torch.float32, device=x.device
                               ).scatter_add_(0, r.expert_idx[:, 0],
                                              torch.ones(T, device=x.device))
            for n in b_axes:
                top1 = sd.all_reduce(top1, "sum", dm, n)
            frac = top1 / (B * S)
            aux = (E * torch.sum(frac * probs.sum(0) / (B * S))
                   * m.router_aux_weight)
            if not first:
                aux = aux * 0
            return y.reshape(b, S, d), aux

        y_pl = tuple(Partial() if n == e_axis else p
                     for n, p in zip(names, bpl))
        aux_pl = tuple(Partial() if n == e_axis or n in b_axes
                       else Replicate() for n in names)
        w_grad = tuple(Partial() if n in b_axes else p
                       for n, p in zip(names, wpl))
        args = (x, rw, wi, wg, wo)
        in_pl = (bpl, repl, wpl, wpl if wg is not None else None, wpl)
        grad_pl = (y_pl, aux_pl, w_grad, w_grad if wg is not None else None,
                   w_grad)
        y, aux = local_map(
            local, out_placements=(y_pl, aux_pl), in_placements=in_pl,
            in_grad_placements=grad_pl, device_mesh=dm,
            redistribute_inputs=True)(*args)
        if self.residual is not None:
            y = y + self.residual(x)
        return y, aux
