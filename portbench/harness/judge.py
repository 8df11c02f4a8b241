"""The comparison that decides `correct`: what the timed path served,
against the plain float32 reference run by the benchmark on the same
inputs and weights.

The numbers, each with a limit the cell's file states (set from the
program's readings over a dozen seeds and the lower-precision control's,
as PERF.md records):

* `gap`: over every served token compared, the widest amount by which
  the reference's logit of the served token lies below the reference's
  best logit at that position (0 when the served token is the
  reference's own greedy choice);
* `mean_gap`: the mean of those amounts over the served tokens
  compared, where the widest one cannot tell the program from the
  control (an MoE whose routing flips on rounding);
* `kv_rel_err` (where a cell compares caches): over the compared cache
  rows, the largest |program - reference| over the largest |reference|
  of one layer's K or V rows.

The control (`control_*`) reads the gap of the token that the
reference computed in fp8 puts first, at the same positions.
"""
from __future__ import annotations

import torch


def gaps(ref_logits, tokens):
    """ref_logits (..., V) float32; tokens (...) ids -> (...) the amount
    by which each token's logit lies below the best."""
    best = ref_logits.amax(-1)
    mine = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return best - mine


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    got, want = got.float(), want.float()
    scale = want.abs().amax().clamp_min(1e-30)
    return float((got - want).abs().amax() / scale)


def verdict(checks: dict, failed: int) -> bool:
    """Correct when every compared number lies within its limit and no
    request failed."""
    return failed == 0 and all(c["value"] <= c["limit"]
                               for c in checks.values())


def report(checks: dict) -> list[str]:
    """One line per compared number: name, value, limit."""
    return [f"check {k}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
            for k, c in checks.items()]


def no_tf32():
    """The reference's products in true float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
