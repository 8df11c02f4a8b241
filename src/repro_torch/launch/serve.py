"""Serving launcher: the paper's deployment, the three-layer client
scheduler in front of a real model behind an opaque `submit`.

Counterpart of `repro.launch.serve`.  On the card (the default) it
builds the architecture at its published full width in bf16 from a
seeded generator; with `--device cpu` it builds the reduced variant
(`get_smoke`) the CPU runs.  Requests go through the deprecated
`ScheduledClient` shim: a wall-clock `ClientSession` over
`AsyncBlackBoxProvider` over `BlackBoxProvider`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --requests 12 --policy final_adrr_olc [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.client import default_p90
from repro_torch.config import ServeConfig
from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.core.policy import STRATEGIES, strategy
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import Model, init_model
from repro_torch.serving import BlackBoxProvider, Request, ScheduledClient
from repro_torch.sim.workload import BUCKET_TOKENS

_BUCKET_TOKENS_NP = BUCKET_TOKENS.numpy()


def make_requests(n: int, seed: int, rate_s: float = 2.0) -> list[Request]:
    """`n` requests with Poisson arrivals at `rate_s` a second, the
    paper's bucket mix and token counts scaled down 64x (the same numpy
    draws as the reference's, so the same requests)."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(n):
        t += rng.exponential(1.0 / rate_s)
        bucket = int(rng.choice(4, p=[0.5, 0.25, 0.15, 0.1]))
        lo, hi = _BUCKET_TOKENS_NP[bucket]
        true_tok = max(int(rng.uniform(lo, hi) / 64), 2)
        p50 = float(true_tok * rng.uniform(0.8, 1.2))
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, 512, size=(8,)).astype(np.int32),
            max_new=true_tok,
            p50=p50,
            bucket=bucket,
            # the tail prior of the generator's bucket quantile ratio
            p90=default_p90(p50, bucket),
            arrival_s=t,
        ))
    return reqs


def build_model(arch: str, device=DEFAULT_DEVICE) -> Model:
    """`arch` with seeded random weights: at its published width on the
    card, its reduced variant on the CPU."""
    dev = resolve_device(device)
    cfg = get(arch) if dev.type == "cuda" else get_smoke(arch)
    return init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="stablelm-1.6b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--policy", choices=list(STRATEGIES),
                    default="final_adrr_olc")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build_model(args.arch, dev)
    cfg = model.cfg
    print(f"built {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) on {dev}")
    provider = BlackBoxProvider(model, ServeConfig(max_seq=128,
                                                   temperature=0.0),
                                device=dev)
    # the model is slower per token than the provider physics the
    # deadline budgets assume; a relaxed timeout multiple demos
    # scheduling rather than wholesale abandonment
    policy = strategy(args.policy)._replace(
        timeout_mult=torch.full((4,), 30.0, dtype=torch.float32))
    client = ScheduledClient(provider, policy, device=dev)
    reqs = make_requests(args.requests, args.seed)

    t0 = time.time()
    done = client.run(reqs)
    wall = time.time() - t0

    n_done = sum(r.status == "completed" for r in done)
    n_rej = sum(r.status == "rejected" for r in done)
    lats = [r.finish_s - r.arrival_s for r in done if r.status == "completed"]
    lat_txt = (f"mean_latency={np.mean(lats):.2f}s "
               f"p95={np.percentile(lats, 95):.2f}s" if lats
               else "mean_latency=n/a")
    print(f"policy={args.policy} completed={n_done}/{len(done)} "
          f"rejected={n_rej} {lat_txt} wall={wall:.1f}s")
    return done


if __name__ == "__main__":
    main()
