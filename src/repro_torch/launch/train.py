"""Training launcher: seeded init, the synthetic data stream, AdamW
steps and a checkpoint at the end.

Counterpart of `repro.launch.train`'s single-host path
(`tools/train_100m.py` drives it).  It runs on the card unless the
caller passes `device="cpu"` (`--device cpu`), and raises without a card
otherwise.  The model is drawn from a `torch.Generator` seeded with
`TrainConfig.seed` on the target device, as `init_model` draws it;
prefixed archs get zero prefix embeddings, as the reference passes them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --steps 50 --batch 8 --seq 256 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import TrainConfig
from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.data import DataConfig, make_batches
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import init_model
from repro_torch.training.train_step import init_train_state, train_step


def run(arch: str, smoke: bool, steps: int, batch: int, seq: int,
        lr: float, microbatches: int, ckpt_dir: str | None,
        log_every: int = 10, device=DEFAULT_DEVICE) -> list[float]:
    """Train `arch` (its smoke variant with `smoke`) for `steps` steps of
    `batch` x `seq` tokens; returns the losses, one a step.  Warmup is a
    tenth of the steps; with `ckpt_dir` the model is saved there at the
    end."""
    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get(arch)
    tc = TrainConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                     total_steps=steps, microbatches=microbatches)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(tc.seed),
                       device=dev)
    state = init_train_state(model, tc, device=dev)
    data = make_batches(DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch))

    losses = []
    t0 = time.time()
    for i, batch_np in zip(range(steps), data):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        if cfg.prefix_len:
            b["prefix_embeds"] = torch.zeros(
                (batch, cfg.prefix_len, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        state, metrics = train_step(state, b, tc)
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, state.model,
                        {"arch": cfg.name, "loss": losses[-1]})
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where to train (default: the card)")
    args = ap.parse_args(argv)
    losses = run(args.arch, args.smoke, args.steps, args.batch, args.seq,
                 args.lr, args.microbatches, args.ckpt_dir,
                 device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
