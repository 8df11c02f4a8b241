"""Core client-side scheduling stack (the paper's contribution), in torch.

Layers:
  * repro_torch.core.drr       — allocation (adaptive DRR + alternatives)
  * repro_torch.core.ordering  — intra-class feasible-set scoring
  * repro_torch.core.overload  — severity + cost-ladder admission
  * repro_torch.core.scheduler — the batched B-grant decision
  * repro_torch.core.policy    — PolicyConfig + named paper strategies
"""
from repro_torch.core.policy import PolicyConfig, STRATEGIES, strategy  # noqa: F401
from repro_torch.core.scheduler import BatchDecision, schedule_batch  # noqa: F401
