"""Serving on the port's models: the engine, the black-box provider and
the deprecated `ScheduledClient` shim (counterpart of `repro.serving`).
The client surface proper lives in `repro_torch.client`; its names are
re-exported here as the reference re-exports them."""
from repro_torch.serving.engine import (  # noqa: F401
    GenState,
    generate,
    prefill_step,
    serve_step,
)
from repro_torch.serving.blackbox import (  # noqa: F401
    BlackBoxProvider,
    ScheduledClient,
)
from repro_torch.client import (  # noqa: F401
    AsyncBlackBoxProvider,
    ClientSession,
    MockProvider,
    Request,
    SessionConfig,
)
