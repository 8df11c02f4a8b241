"""Rule modules register themselves on import; lint.py imports this
package to populate the registry."""
from repro_torch.analysis.rules import (  # noqa: F401
    rpl001_pinned,
    rpl002_donation,
    rpl003_hostsync,
    rpl004_static_args,
    rpl005_kernels,
    rpl006_imports,
)
