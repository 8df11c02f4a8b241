"""`setup_s`: seconds from the process's start to the first timed call:
imports, the kernels' libraries (built on a checkout's first run), the
weights drawn on the card, the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
