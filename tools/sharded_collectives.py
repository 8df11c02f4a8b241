"""Which ops of a sharded step send its collective bytes.

    PYTHONPATH=src python tools/sharded_collectives.py qwen1.5-32b:train_4k:pod \
        [mamba2-780m:train_4k:pod ...] [--top 6]

Runs each (arch:shape:mesh) combo's sharded step as the dry run does
(`repro_torch.launch.dryrun.sharded_step`: rank 0 over the `fake`
process group, local tensors on `meta`, on the CPU) and prints the
collectives grouped by kind, output shape and dtype, and the port's
lines that called them, largest first: each group's bytes (times the
reference's multiplier) and count, beside the step's total.
"""
from __future__ import annotations

import argparse
import collections
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.specs import build_spec  # noqa: E402
from repro_torch.sharding import dist as sd  # noqa: E402


class ByCaller(sd.CollectiveCounter):
    """`CollectiveCounter` that also sums each collective's bytes by
    (kind, output shape, dtype, the last three port frames)."""

    made: list = []

    def __init__(self):
        super().__init__()
        self.groups = collections.Counter()
        self.calls = collections.Counter()
        ByCaller.made.append(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = self.kinds.get(getattr(func, "overloadpacket", None))
        if out is NotImplemented or kind is None:
            return out
        frames = [f"{Path(f.filename).name}:{f.lineno}"
                  for f in traceback.extract_stack()
                  if "repro_torch" in f.filename
                  and not f.filename.endswith("dist.py")]
        key = (kind, tuple(out.shape), str(out.dtype).replace("torch.", ""),
               " ".join(frames[-3:]))
        self.groups[key] += sd._out_bytes(out) * sd.MULT[kind]
        self.calls[key] += 1
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("combos", nargs="+", help="arch:shape:mesh")
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    dryrun.CollectiveCounter = ByCaller
    for combo in args.combos:
        arch, shape, mesh_kind = combo.split(":")
        spec = build_spec(arch, shape, make_production_mesh(
            multi_pod=mesh_kind == "multipod"))
        rec = dryrun.sharded_step(spec, mesh_kind)
        counter = ByCaller.made[-1]
        print(f"{arch} {shape} {mesh_kind}: collectives "
              f"{rec['collectives']['total'] / 1e9:.4g} GB, temporaries "
              f"{rec['temp_size_in_bytes'] / 1e9:.4g} GB")
        for key, b in counter.groups.most_common(args.top):
            print(f"  {b / 1e9:10.4g} GB  x{counter.calls[key]:<4d} {key}")


if __name__ == "__main__":
    main()
