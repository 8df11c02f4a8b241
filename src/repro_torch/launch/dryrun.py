"""Dry run of the production meshes.

Counterpart of `repro.launch.dryrun`.  For every (architecture x input
shape) and both production meshes (16x16 single pod, 2x16x16 multi-pod)
it builds the step's spec (`repro_torch.launch.specs.build_spec`: the
arguments on `meta`, their placements from the logical-axis rules),
records the bytes of one rank's local slice of the state (parameters,
the train step's float32 master weights and AdamW moments, the decode
step's caches) and runs the step once on `meta` under
`torch.utils.flop_counter.FlopCounterMode`, and writes one JSON record
per combo under `paper_results/dryrun_torch/`.

The reference lowers and compiles each step for 512 forced host devices
and reads XLA's memory and cost analyses and the collectives in the
HLO.  Torch has no SPMD compiler, so a record here has no temporary
(`temp_size_in_bytes`) or output bytes and no collective bytes: only
the argument bytes a rank holds, which follow from the placements
alone, and the step's FLOPs.  `flops` is the GLOBAL step's count (every
rank's work together; the remat recompute of a train step included),
counted once per (arch, shape), since it does not depend on the mesh.
A failed combo is a data point: its record has `ok` false and the
error.

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
  python -m repro_torch.launch.dryrun --summary    # a table of the records
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import SHAPES, ModelConfig
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import HBM_PER_CHIP, make_production_mesh
from repro_torch.launch.specs import (
    build_spec,
    shard_alloc_nbytes,
    shard_nbytes,
    state_leaves,
)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "paper_results", "dryrun_torch")
MESHES = ("pod", "multipod")

def step_flops(spec) -> float:
    """Run the spec's step once on `meta` and count its FLOPs."""
    with FlopCounterMode(display=False) as counter:
        spec.fn(*spec.args)
    return float(counter.get_total_flops())


def record(arch: str, shape_name: str, mesh_kind: str,
           microbatches: int = 1, flops: bool = True,
           cfg_override: ModelConfig | None = None,
           flops_cache: dict | None = None):
    """(one combo's record, its spec or None where building it failed).
    `flops=False` skips the run on `meta`; `flops_cache` (a dict the
    caller keeps across combos) keeps one count per (arch, shape,
    microbatches, config), as the count does not depend on the mesh."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "n_devices": mesh.size, "microbatches": microbatches,
           "ok": False}
    spec = None
    try:
        t0 = time.perf_counter()
        spec = build_spec(arch, shape_name, mesh, microbatches, cfg_override)
        rec["variant"] = spec.note
        rec["build_s"] = round(time.perf_counter() - t0, 3)
        leaves = list(state_leaves(spec))
        rec["n_state_tensors"] = len(leaves)
        rec["n_sharded"] = sum(any(e is not None for e in sh.spec)
                               for _, _, sh in leaves)
        rec["argument_bytes_per_device"] = shard_nbytes(spec)
        rec["argument_bytes_allocated"] = shard_alloc_nbytes(spec)
        rec["fits_hbm"] = rec["argument_bytes_per_device"] <= HBM_PER_CHIP
        if flops:
            cache = {} if flops_cache is None else flops_cache
            key = (arch, shape_name, microbatches, spec.cfg)
            if key not in cache:
                t0 = time.perf_counter()
                cache[key] = step_flops(spec)
                rec["trace_s"] = round(time.perf_counter() - t0, 3)
            rec["flops"] = cache[key]
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failed combo is a data point
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec, spec


def run_one(arch: str, shape_name: str, mesh_kind: str,
            microbatches: int = 1, save: bool = True, flops: bool = True,
            cfg_override: ModelConfig | None = None,
            out_dir: str = OUT_DIR, flops_cache: dict | None = None) -> dict:
    """One combo's record, written to `out_dir` when `save`."""
    rec, _ = record(arch, shape_name, mesh_kind, microbatches, flops,
                    cfg_override, flops_cache)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def summary(out_dir: str = OUT_DIR) -> str:
    """A markdown table of the saved records: for each arch and shape,
    GB a device (decimal) on one pod / two pods, then the step's FLOPs."""
    recs = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"])] = r

    def cell(a, s):
        rs = [recs.get((a, s, m)) for m in MESHES]
        gb = " / ".join("-" if r is None else "FAIL" if not r["ok"] else
                        f"{r['argument_bytes_per_device'] / 1e9:.4g}"
                        for r in rs)
        flops = next((r["flops"] for r in rs if r and "flops" in r), None)
        return gb if flops is None else f"{gb}; {flops:.3g}"

    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "| --- |" + " --- |" * len(SHAPES)]
    lines += [f"| {a} | " + " | ".join(cell(a, s) for s in SHAPES) + " |"
              for a in ARCHS]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--summary", action="store_true",
                    help="print a table of the saved records and exit")
    args = ap.parse_args()
    if args.summary:
        print(summary())
        return

    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    t_all = time.perf_counter()
    n_fail = 0
    flops_cache: dict = {}
    for mk in meshes:
        for a in archs:
            for s in shapes:
                fn = os.path.join(OUT_DIR, f"{a}__{s}__{mk}.json")
                if args.skip_existing and os.path.exists(fn):
                    with open(fn) as f:
                        if json.load(f).get("ok"):
                            print(f"[skip] {a} {s} {mk}")
                            continue
                t0 = time.perf_counter()
                rec = run_one(a, s, mk, args.microbatches,
                              flops_cache=flops_cache)
                n_fail += not rec["ok"]
                status = "OK " if rec["ok"] else "FAIL"
                print(f"[{status}] {a:24s} {s:12s} {mk:8s} "
                      f"{time.perf_counter() - t0:6.1f}s "
                      f"bytes/dev={rec.get('argument_bytes_per_device', 0):.4g} "
                      f"flops={rec.get('flops', 0):.3g} "
                      f"{rec.get('error', '')}",
                      flush=True)
    print(f"dryrun: {time.perf_counter() - t_all:.1f}s, {n_fail} failed",
          flush=True)


if __name__ == "__main__":
    main()
