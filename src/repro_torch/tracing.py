"""The port's spans and counters, on the profiler's clock.

Nothing is kept unless a `torch.profiler` session is recording on the
calling thread (a session records only the thread that started it), so
the serving path pays one C call a span when nobody looks.  Under a
profiler:

* `span(name)` opens a profiler range of that name: a host event of the
  profile, on the clock of its device activity.  The profile is the
  span's only record: a reader of the trace finds the span's device
  work among the operations launched inside it;
* `count(name, value)` adds a host int or a 0-d integer tensor (added
  on the tensor's device, never read back) to a counter of the
  innermost open model step (`STEPS`).  A counter is one running sum a
  step name and counter name, so what is kept stays the same size
  however long a profiler records.

`counters()` reads the sums since the last `reset()`, with one read of
the device.

The range is `torch._C._profiler._RecordFunctionFast`: a host event only,
where `torch.profiler.record_function` also makes a device copy and takes
~14 µs of host time a span under the profiler against ~1 µs (measured on
an H100 machine), time a host-bound step's device waits for.  The
serving path (`models/model.py`, `models/blocks.py`, `models/moe.py`)
opens:

    model.prefill, model.decode_step   the bodies of `prefill` and
                                       `decode_step`
    block.attention                    a block's attention
    block.mlp, block.moe               a block's channel mix

and counts, in each MoE call: `moe.experts_run` (the experts whose
products were computed) and `moe.experts_chosen` (the distinct experts
the T * k slots chose).
"""
from __future__ import annotations

import contextlib

import torch

# the model-step spans counters are credited to
STEPS = ("model.prefill", "model.decode_step")

_enabled = torch._C._autograd._profiler_enabled
_annotate = torch._C._profiler._RecordFunctionFast
_NOOP = contextlib.nullcontext()
_step = [None]     # the innermost open model step's name
_counts: dict = {}  # {(step name or None, counter): int or 0-d tensor}


class _Step:
    """A model step's range, which names the step counters go to."""
    __slots__ = ("name", "rf", "outer")

    def __init__(self, name: str):
        self.name = name
        self.rf = _annotate(name)

    def __enter__(self):
        self.rf.__enter__()
        self.outer = _step[0]
        _step[0] = self.name
        return self

    def __exit__(self, *exc):
        _step[0] = self.outer
        self.rf.__exit__(*exc)


def enabled() -> bool:
    """Whether a profiler records on this thread: what `span` and
    `count` test, for a caller whose counts cost device work."""
    return _enabled()


def span(name: str):
    """A context manager: a profiler range named `name` while a
    profiler records, else one shared no-op context."""
    if not _enabled():
        return _NOOP
    return _Step(name) if name in STEPS else _annotate(name)


def count(name: str, value) -> None:
    """Add `value` (a host int, or a 0-d integer tensor, kept as given
    until the next is added) to the counter `name` of the innermost open
    model step; nothing without a profiler."""
    if not _enabled():
        return
    key = (_step[0], name)
    kept = _counts.get(key)
    _counts[key] = value if kept is None else kept + value


def counters() -> dict:
    """{model step's name (None outside every step): {counter: int}},
    summed since the last `reset()`."""
    kept = list(_counts.items())
    tensors = [v for _, v in kept if isinstance(v, torch.Tensor)]
    read = iter(torch.stack([t.to(tensors[0].device, torch.int64)
                             for t in tensors]).tolist() if tensors else [])
    out: dict = {}
    for (step, name), v in kept:
        out.setdefault(step, {})[name] = (next(read)
                                          if isinstance(v, torch.Tensor)
                                          else int(v))
    return out


def reset() -> None:
    """Forget every count."""
    _counts.clear()
