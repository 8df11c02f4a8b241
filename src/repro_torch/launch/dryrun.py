"""Dry run of the production meshes.

Counterpart of `repro.launch.dryrun`.  For every (architecture x input
shape) and both production meshes (16x16 single pod, 2x16x16 multi-pod)
it builds the step's spec (`repro_torch.launch.specs.build_spec`: the
arguments on `meta`, their placements from the logical-axis rules),
records the bytes of one rank's local slice of the state (parameters,
the train step's float32 master weights and AdamW moments, the decode
step's caches), runs the step once on `meta` under
`torch.utils.flop_counter.FlopCounterMode`, then runs rank 0's share
of it sharded (`sharded_step`), and writes one JSON record per combo
under `paper_results/dryrun_torch/`.

The reference lowers and compiles each step for 512 forced host devices
and reads XLA's memory and cost analyses and the collectives in the
HLO.  Torch has no SPMD compiler: the port runs the step as a DTensor
program instead, as rank 0 of the production mesh over a process group
whose collectives move no data (`repro_torch.sharding.dist.
fake_world`), its local tensors on `meta`.  From that run a record
takes what the reference's takes from XLA's: `temp_size_in_bytes` (the
peak of the rank's live bytes less its state and inputs),
`output_size_in_bytes`, `bytes_per_device` = the state's bytes plus the
temporaries (which `fits_hbm` reads), and `collectives`, the bytes each
kind of collective outputs on the rank times the reference's
multiplier (an all-reduce 2x), under its keys, with their `total` and
`collective_counts`.  The placements of the activations are the
port's, fixed where DTensor would choose
(`repro_torch.sharding.dist`): the batch split over the data axes, the
weights' FSDP axes all-gathered before use, heads, MLP columns and
experts split over `model` where they divide.  `flops` is the GLOBAL
step's count (every rank's work together; the remat recompute of a
train step included), counted once per (arch, shape), since it does
not depend on the mesh.  A failed combo is a data point: its record
has `ok` false and the error.

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
                                       [--no-sharded]
  python -m repro_torch.launch.dryrun --summary    # a table of the records
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Mapping

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import SHAPES, ModelConfig
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import HBM_PER_CHIP, make_production_mesh
from repro_torch.launch.specs import (
    build_spec,
    shard_alloc_nbytes,
    shard_nbytes,
    sharded_args,
    state_leaves,
)
from repro_torch.sharding.dist import (
    CollectiveCounter,
    LiveBytes,
    device_mesh,
    fake_world,
)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "paper_results", "dryrun_torch")
MESHES = ("pod", "multipod")

def step_flops(spec) -> float:
    """Run the spec's step once on `meta` and count its FLOPs."""
    with FlopCounterMode(display=False) as counter:
        spec.fn(*spec.args)
    return float(counter.get_total_flops())


def _tensors(tree):
    """Every tensor of a tree of modules, dicts, lists and tuples (a
    DTensor as its local tensor)."""
    if isinstance(tree, torch.nn.Module):
        yield from _tensors(list(tree.parameters()))
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def sharded_step(spec, mesh_kind: str, device_type: str = "cpu") -> dict:
    """Run rank 0's share of the spec's step once, its arguments
    DTensors on the production mesh `mesh_kind` over a `fake_world` of
    that mesh's size, and return what the rank needs and sends:

      * `temp_size_in_bytes`: the peak of the live bytes during the
        step less those at its start (the local state and inputs), each
        storage rounded up to the allocator's block, as
        `repro_torch.sharding.dist.LiveBytes` tracks them (torch's
        `MemTracker` registers gradient hooks on module outputs, which
        fails in a step without autograd);
      * `output_size_in_bytes`: the step's outputs that are new
        storages (a train or decode step updates its state in place);
      * `collectives`: the bytes each kind of collective outputs on
        this rank times the reference's multiplier (`MULT`), and their
        `total`; `collective_counts`, the number of each.

    On the CPU (`device_type="cpu"`) the local tensors lie on `meta`:
    nothing is allocated and nothing is computed.  On the card
    (`"cuda"`) the local shards are real, uninitialised (integers
    zeroed) tensors and the step runs on them; the fake group leaves
    every collective's output undefined, so its values mean nothing.
    There the record also holds `device_temp_bytes`, the growth of the
    caching allocator's peak (`max_memory_allocated`) over its
    allocation at the step's start."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    t0 = time.perf_counter()
    with fake_world(mesh.size):
        dm = device_mesh(mesh, device_type)
        args = sharded_args(spec, dm,
                            "meta" if device_type == "cpu" else None)
        held = list(_tensors(args))
        mem = LiveBytes()
        for t in held:
            mem.track(t)
        start = mem.current
        counter = CollectiveCounter()
        cuda = device_type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        with implicit_replication(), mem, counter:
            out = spec.fn(*args)
        if cuda:
            torch.cuda.synchronize()
            device_temp = torch.cuda.max_memory_allocated() - before
        kept = {t.untyped_storage()._cdata for t in held}
        new = [t for t in _tensors(out)
               if t.untyped_storage()._cdata not in kept]
        out_bytes = _storage_bytes(new)
        del args, held, out, new
    rec = {"temp_size_in_bytes": mem.peak - start,
           "output_size_in_bytes": out_bytes,
           "collectives": counter.collectives(),
           "collective_counts": dict(counter.counts),
           "sharded_s": round(time.perf_counter() - t0, 3)}
    if cuda:
        rec["device_temp_bytes"] = device_temp
    return rec


def record(arch: str, shape_name: str, mesh_kind: str,
           microbatches: int = 1, flops: bool = True,
           cfg_override: ModelConfig | None = None,
           flops_cache: dict | None = None, sharded: bool = False):
    """(one combo's record, its spec or None where building it failed).
    `flops=False` skips the run on `meta`; `flops_cache` (a dict the
    caller keeps across combos) keeps one count per (arch, shape,
    microbatches, config), as the count does not depend on the mesh.
    `sharded` adds `sharded_step`'s fields on the CPU, `bytes_per_device`
    (the state's bytes plus the temporaries) and reads `fits_hbm` from
    it."""
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
        if sharded:
            rec.update(sharded_step(spec, mesh_kind))
            rec["bytes_per_device"] = (rec["argument_bytes_per_device"]
                                       + rec["temp_size_in_bytes"])
            rec["fits_hbm"] = rec["bytes_per_device"] <= HBM_PER_CHIP
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failed combo is a data point
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec, spec


def run_one(arch: str, shape_name: str, mesh_kind: str,
            microbatches: int = 1, save: bool = True, flops: bool = True,
            cfg_override: ModelConfig | None = None,
            out_dir: str = OUT_DIR, flops_cache: dict | None = None,
            sharded: bool = False) -> dict:
    """One combo's record, written to `out_dir` when `save`."""
    rec, _ = record(arch, shape_name, mesh_kind, microbatches, flops,
                    cfg_override, flops_cache, sharded)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def summary(out_dir: str = OUT_DIR) -> str:
    """A markdown table of the saved records: for each arch and shape,
    GB a device (decimal) on one pod / two pods, then the step's FLOPs;
    where the records hold the sharded step, the temporaries' GB and
    the collectives' GB on one pod / two pods after it."""
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
        out = gb if flops is None else f"{gb}; {flops:.3g}"
        if any(r and "temp_size_in_bytes" in r for r in rs):
            def gbs(key):
                return " / ".join(
                    "-" if not (r and r["ok"] and key(r) is not None) else
                    f"{key(r) / 1e9:.4g}" for r in rs)
            out += (f"; temp {gbs(lambda r: r.get('temp_size_in_bytes'))}"
                    f"; coll {gbs(lambda r: r.get('collectives', {}).get('total'))}")
        return out

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
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the sharded step (no temporary or "
                    "collective bytes)")
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
                              flops_cache=flops_cache,
                              sharded=not args.no_sharded)
                n_fail += not rec["ok"]
                status = "OK " if rec["ok"] else "FAIL"
                print(f"[{status}] {a:24s} {s:12s} {mk:8s} "
                      f"{time.perf_counter() - t0:6.1f}s "
                      f"bytes/dev={rec.get('argument_bytes_per_device', 0):.4g} "
                      f"temp={rec.get('temp_size_in_bytes', 0):.4g} "
                      f"coll={rec.get('collectives', {}).get('total', 0):.4g} "
                      f"flops={rec.get('flops', 0):.3g} "
                      f"{rec.get('error', '')}",
                      flush=True)
    print(f"dryrun: {time.perf_counter() - t_all:.1f}s, {n_fail} failed",
          flush=True)


if __name__ == "__main__":
    main()
