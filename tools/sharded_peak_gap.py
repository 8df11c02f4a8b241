"""Where the card's peak outgrows the dry run's tracked temporaries.

    python3 tools/sharded_peak_gap.py [--arch stablelm-1.6b] [--shape train_4k]

Runs one combo's sharded step (`repro_torch.launch.dryrun.sharded_step`'s
setup: rank 0 of the one-pod mesh over the `fake` process group) on the
card under a `LiveBytes` that, after every op, compares the caching
allocator's peak growth (`max_memory_allocated`) with its own tracked
peak, and prints each op at which the gap grows by more than 32 MiB: the
op, its inputs' shapes and the port's frames that called it.  A gap is
memory a CUDA kernel allocates below the dispatcher (a workspace or a
temporary), which no dispatch mode sees; `sharding/dist.py`'s
`CUDA_OP_TEMPS` models the ones found.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402

from repro_torch.launch.dryrun import _tensors  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.specs import build_spec, sharded_args  # noqa: E402
from repro_torch.sharding import dist as sd  # noqa: E402

STEP = 32 << 20   # report the gap each time it grows by this much


class Gap(sd.LiveBytes):
    def __init__(self, before: int):
        super().__init__()
        self.before, self.start, self.gap, self.log = before, 0, 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        card = torch.cuda.max_memory_allocated() - self.before
        gap = card - (self.peak - self.start)
        if gap > self.gap + STEP:
            frames = [f"{Path(f.filename).name}:{f.lineno}"
                      for f in traceback.extract_stack()
                      if "repro_torch" in f.filename]
            shapes = [tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            self.log.append(dict(gap=gap, op=str(func), shapes=shapes,
                                 frames=frames[-5:]))
            self.gap = gap
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sharded_peak_gap: needs a CUDA card")
    # cuBLAS's workspaces, outside the measured step
    a = torch.ones(64, 64, device="cuda", requires_grad=True)
    (a @ a).sum().backward()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    mesh = make_production_mesh()
    spec = build_spec(args.arch, args.shape, mesh)
    with sd.fake_world(mesh.size):
        dm = sd.device_mesh(mesh, "cuda")
        state = sharded_args(spec, dm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gap = Gap(torch.cuda.memory_allocated())
        for t in _tensors(state):
            gap.track(t)
        gap.start = gap.peak = gap.current
        with implicit_replication(), gap:
            spec.fn(*state)
        torch.cuda.synchronize()
        card = torch.cuda.max_memory_allocated() - gap.before
    print(dict(arch=args.arch, shape=args.shape, card_peak_bytes=card,
               tracked_temp_bytes=gap.peak - gap.start,
               device=torch.cuda.get_device_name(0)))
    for row in gap.log:
        print(row)


if __name__ == "__main__":
    main()
