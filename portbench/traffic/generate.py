"""Traffic kind `generate`: batches of prompts decoded greedily for a
fixed number of new tokens, one closed-loop client, tokens per second.

Parameters (the cell's `params`):

    batch      prompts a call
    lengths    {"min", "max", "step"}: the prompt lengths, one a call
    n_new      tokens generated a prompt (every step is computed; a
               prompt that emits EOS is served EOS after it)
    max_seq    the KV cache's length
    check      {"calls": calls compared}

Every seed serves the same lengths, each once a cycle, in an order
drawn from the seed.  Token ids are uniform, drawn on the card from the
seed and the call's index.  A timed call is the port's
`serving.engine.generate` on the batch (its prefill, then n_new - 1
decode steps), the tokens read back to the host.

The comparison: a sample of the first cycle's calls drawn from the
seed, the longest prompt's among them (`prefill.sample`): every served
token of every prompt, up to its first EOS, against the float32
reference run over the prompt and the served tokens fed back.  The
number compared is the mean of the gaps (`mean_gap`; see
`harness.judge`): the widest one, printed beside it, is set by bf16
flips of the router's top-2 and reads alike in the program and in the
fp8 control, so it cannot separate them (PERF.md).

In a traced run the driver also keeps each decode step's router logits
(forward hooks on the MoE layers' routers, no device work) to count the
distinct experts each step's tokens chose, for `hbm_share.decode`.
"""
from __future__ import annotations

import contextlib
import random

import torch

from portbench.harness import judge
from portbench.harness.spec import module, sub_seed
from portbench.traffic.prefill import sample


def lengths(p: dict, seed: int) -> list[int]:
    L = p["lengths"]
    out = list(range(L["min"], L["max"] + 1, L["step"]))
    random.Random(sub_seed(seed, "order")).shuffle(out)
    return out


def distinct_experts(router_logits, k: int) -> list[int]:
    """Distinct experts chosen in each of N router calls: router_logits
    (N, T, E) in the served dtype, top k by the port's rule (float32
    softmax, ties to the lower index)."""
    x = router_logits.float()
    e = torch.exp(x - x.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    N, E = x.shape[0], x.shape[-1]
    used = torch.zeros((N, E), dtype=torch.bool, device=x.device)
    used.scatter_(1, idx.reshape(N, -1), True)
    return used.sum(1).tolist()


class Driver:
    def __init__(self, run):
        from repro_torch.config import ServeConfig
        from repro_torch.serving import engine

        self.run, self.engine = run, engine
        p = run.params
        self.B, self.n_new = p["batch"], p["n_new"]
        self.eos = run.c["eos_token_id"]
        self.sc = ServeConfig(max_seq=p["max_seq"], max_batch=self.B,
                              temperature=0.0, eos_id=self.eos)
        self.cycle = lengths(p, run.seed)
        self.kept = {}           # call index -> (S, served)
        self.router_out = []
        self.ref = module("reference", run.c["reference"])

    def tokens(self, i: int, S: int):
        g = torch.Generator(device=self.run.device)
        g.manual_seed(sub_seed(self.run.seed, "prompt", i))
        return torch.randint(0, self.run.c["vocab_size"], (self.B, S),
                             generator=g, device=self.run.device)

    def call(self, prompt, n_new: int):
        model = self.run.built.model
        return self.engine.generate(model, self.sc, prompt, n_new,
                                    device=self.run.device).cpu()

    def warmup(self):
        for S in sorted(set(self.cycle), reverse=True):
            self.call(self.tokens(-1, S), 2)

    def prepare(self, i: int):
        S = self.cycle[i % len(self.cycle)]
        return i, S, self.tokens(i, S)

    def timed(self, inputs):
        return self.call(inputs[2], self.n_new)

    def record(self, i, inputs, served, t0, t1):
        _, S, _ = inputs
        if i < len(self.cycle):   # the first cycle's calls, to sample
            self.kept[i] = (S, served)
        rec = {"t0": t0, "t1": t1, "batch": self.B, "prompt_len": S,
               "n_new": self.n_new}
        if self.router_out:
            k = self.run.c["num_experts_per_tok"]
            L = self.run.c["num_hidden_layers"]
            used = distinct_experts(torch.stack(self.router_out), k)
            rec["experts_used"] = [used[s * L:(s + 1) * L]
                                   for s in range(len(used) // L)]
            self.router_out = []
        return rec

    @contextlib.contextmanager
    def hooks(self):
        """Keep every decode step's router logits (a call of B tokens)."""
        def keep(mod, args, out):
            if out.shape[0] == self.B:
                self.router_out.append(out)

        handles = [blk.moe.router.register_forward_hook(keep)
                   for blk in self.run.built.model.blocks
                   if getattr(blk, "moe", None) is not None]
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    def judge(self, control: bool = False) -> dict:
        judge.no_tf32()
        w, c = self.run.built.weights, self.run.c
        total = c_total = widest = 0.0
        n_tok = 0
        kept = sample(self.kept, self.run.params["check"]["calls"],
                      self.run.seed)
        for i, (S, served) in kept:
            served = served.to(self.run.device).long()
            prompt = self.tokens(i, S)
            seq = torch.cat([prompt, served[:, :-1]], 1)
            at = list(range(S - 1, S - 1 + self.n_new))
            logits, _ = self.ref.forward(w, c, seq, logits_at=at,
                                         prompt_len=S)
            # compare up to each prompt's first EOS, which is served
            is_eos = (served == self.eos).int()
            upto = (is_eos.cumsum(1) - is_eos) == 0
            g = judge.gaps(logits, served)[upto]
            total += float(g.sum())
            widest = max(widest, float(g.max()))
            n_tok += g.numel()
            if control:
                lo, _ = self.ref.forward(w, c, seq, logits_at=at,
                                         prompt_len=S, quant="fp8")
                c_total += float(judge.gaps(logits, lo.argmax(-1))[upto]
                                 .sum())
            del logits
        self.run.notes.append(f"compared {len(kept)} calls, {n_tok} served "
                              f"tokens; widest gap {widest!r}")
        out = {"mean_gap": total / n_tok}
        if control:
            out["control_mean_gap"] = c_total / n_tok
        return out
