"""Train the smoke decoder of an architecture for a few hundred steps
through the port's whole training stack (data pipeline -> model ->
AdamW -> checkpoint), by the same `repro_torch.launch.train.run` entry
point as the launcher; the port's counterpart of
`examples/train_100m.py`.  The loss must fall by 0.5 from ~ln(vocab):
the script asserts it does.

Usage:  python3 tools/train_100m.py [--steps 200] [--device cpu]
(the card by default).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    print(f"arch family: {get_smoke(args.arch).name}")
    with tempfile.TemporaryDirectory() as d:
        losses = run(arch=args.arch, smoke=True, steps=args.steps,
                     batch=8, seq=128, lr=3e-4, microbatches=1,
                     ckpt_dir=d, log_every=20, device=args.device)
    first, last = losses[0], sum(losses[-10:]) / 10
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps")
    if not last < first - 0.5:
        raise SystemExit("training did not reduce loss")
    print("OK: loss decreased; checkpoint written and removed with tmpdir")


if __name__ == "__main__":
    main()
