"""`decode_step_ms.decode`: the median device ms of the traced window's
decode steps, each the port's `model.decode_step` span (the body of
`models/model.py` `decode_step`: every layer and the head, the
sampling outside it): the busy union of the device operations launched
inside it, read from the trace."""
import statistics

from portbench.harness.spans import decode_steps, device_ms


def read(run):
    steps = decode_steps(run)
    ms = device_ms(run, steps) if steps is not None else None
    ms = [m for call in ms or () for m in call]
    return statistics.median(ms) if ms else None
