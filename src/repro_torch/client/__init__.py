"""The streaming client: the paper's scheduler at a black-box boundary.

Counterpart of `repro.client`.  `ClientSession` runs the three-layer
scheduler as an open-ended submit/poll/drain session over the
`AsyncProvider` boundary; `MockProvider` replays the simulator's
provider dynamics (with fault injection) behind it,
`AsyncBlackBoxProvider` adapts a real model behind a blocking
`submit`, and `FleetProvider` multiplexes a session over P endpoints
with endpoint-aware routing.
"""
from repro_torch.client.blackbox import AsyncBlackBoxProvider  # noqa: F401
from repro_torch.client.fleet import FleetProvider  # noqa: F401
from repro_torch.client.provider import (  # noqa: F401
    AsyncProvider,
    Completion,
    MockProvider,
    SubmitResult,
    sanitize_retry_after_ms,
)
from repro_torch.client.request import Request, default_p90  # noqa: F401
from repro_torch.client.resilience import ResilienceConfig, Watchdog  # noqa: F401
from repro_torch.client.session import (  # noqa: F401
    ClientSession,
    PollResult,
    SessionConfig,
    SessionStats,
    expo_retry,
    honor_retry_after,
)
