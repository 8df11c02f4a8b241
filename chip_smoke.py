#!/usr/bin/env python3
"""Chip check of the PyTorch port (`src/repro_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit. It builds the hand kernels from the checkout's sources,
holds each against its plain PyTorch version on the card, drives the
port's main paths and checks what comes out: the windowed scheduler
simulator, whose ordering layer ranks every class through
`sched_score_topb`, and the serving engine over three full-width models:
the dense StableLM-2-1.6B, whose prefill runs `flash_attention` and
whose every decode step runs `decode_attention`; the state-space
Mamba2-780M, whose prefill runs `ssd_intra` in every layer; the hybrid
Hymba-1.5B, which runs all three; and the rest of the model zoo at
published width (phase 11): the MoE Phi-3.5-MoE and Arctic, the dense
Qwen1.5-32B and Nemotron-4-340B (head dim 192), and InternVL2-1B and
MusicGen-large behind their modality prefixes, and StarCoder2-3B whole
behind its 4,096-token sliding window (phase 11b). The trainer (phase
12) runs under autograd through the plain versions, so it must launch no
kernel: card against CPU on three smoke configs, a seeded smoke run
whose loss falls and whose checkpoint round-trips, and StableLM-2-1.6B
steps at full width. The scheduler also runs
the paper tables' policy variants, the nonstationary provider
(brownouts, token buckets, phased arrivals) and a fleet of four
endpoints (routing, failover with requeue, per-endpoint buckets), card
against CPU and at the scale run's size. Each path is driven with every
kernel's launch count set to 0 just before it and read just after; the
kernels line carries each kernel's launches summed over the paths. The
live client session runs the same scheduler through its `ClientSession`
against a `MockProvider` (phase 5f) and a fleet of them behind
`FleetProvider` (5g, 5h), and, in the paper's deployment, in front of
the served StableLM behind `AsyncBlackBoxProvider` while the model's
worker threads run its attention kernels (7b).
Each phase prints one JSON line; any failure raises and the script
exits non-zero.  `--only=session` (or another name of `SELECTABLE`,
comma-separated) runs just those phases after the build, as a
rehearsal: it prints no kernels line and no result line.  The last lines are the card (as nvidia-smi reports
it), one JSON line of kernel measurements, and the result line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases:
  1. device: the card's name and power limit;
  2. build: nvcc of every kernel source, all started together;
  3. kernels: each scheduler kernel against its plain version on the
     card, exact equality of indices and score bits, over the main
     path's shapes and edge cases (`sched_cases`: queues of one CTA's
     tile of 4096 lanes and its edges, all masked, fewer eligible lanes
     than b, equal best scores on both sides of a tile edge), a second
     identical call over several CTAs equal to the first, and one
     device kernel a call of `sched_score_argmax` and `sched_score_topb`
     (torch.profiler); `sched_compact_topb` over slot pools of 1 to
     100,000 slots (`compact_cases`: one CTA's tile and its edges, two
     and 25 tiles, densities 0 to 1, b = 1, 16 and 128, the route row,
     all-equal scores, live scores at, below NEG and -inf), outputs
     filled with a sentinel first, a repeated call past one tile, and
     one device kernel a call at 4096 and 100,000 slots; times (CUDA
     events, median of 60 calls after warm-up) of each kernel, its plain
     version and the nearest single PyTorch call (for compaction, which
     none computes, the plain compaction and the top-b kernel after
     it);
  4. paper cell: `run_cell` (N = 160, 7,000 ticks) on the card and on
     the CPU with the same inputs — equal decision traces, equal
     terminal statuses, metrics within the tests' tolerance
     (`CELL_TOL`).  Both runs go on in
     spawned processes of their own (the card's on a card that
     processes may share, compute mode Default), started after phase 5
     and read before 5c, so that they overlap phases 5a, 5b and 5d,
     whose rates the check does not read, and none of the timed scale
     runs; the card run is timed from after a warm-up launch.  In
     phases 5a, 5b and 5d the CPU run goes on in a spawned process
     while the card runs (`card_and_cpu`), joined before the phase ends;
  5. scale: the windowed run at N = 100,000, W = 4096, B = 16 on the
     card, 600 ticks —
     `sched_score_topb` launched (K+1) times a tick, every request
     accounted for on every tick and after the drain, `sched_compact_topb`
     held against its plain version on the run's own slot pool at
     mid-run, and a window of ticks traced with `torch.profiler` for the
     device's busy time and idle share (read from the trace's device
     events, `device_activity`);
 5a. tables: the paper tables' policy variants, each on the card and on
     the CPU with the same inputs (N = 160 at 8x the rate, W = 256, B =
     4, seed 0, 500 ticks): `with_information(final_adrr_olc,
     "no_info")` with no_info
     priors, `with_bucket_policy(final_adrr_olc, "reverse")` on
     heavy/high, `per_bucket_policy()` with the bucket4 lanes,
     `multi_tenant_policy(4)` with tenant4, and `final_adrr_olc` against
     `physics_for_arch(ms_per_token=13.0)` — equal decision traces,
     severity bits, statuses and throttle counts, metrics within the
     paper cell's tolerance, (K+1) `sched_score_topb` launches a tick;
 5b. scenarios: `storm` (phased arrivals, a brownout, a token bucket)
     and `rate_crunch` (a refill that collapses mid-run) through
     `run_scenario_cell` on the card and on the CPU (N = 160 at 4x the
     rate, W = 256, B = 4, seed 0, the arrival span plus 200 ticks of
     drain) — equal decisions, severity bits, statuses and bounces (at
     least one), equal phase metrics (NaN as NaN), per-phase
     completions and sheds printed;
 5c. scenario_scale: `storm` at the scale run's size (N = 100,000, W =
     4096, B = 16, K = 2, 800 ticks, the population offered over the
     N = 160 span at 2.5x the rate, so that the brownout keeps its share
     of 2,000 ticks) on the card: every request terminal after the drain,
     bounces counted, every real admit's service equal to the physics
     at the inflight count it saw and the tick's comfort scale, slower
     inside the brownout at equal inflight, the phase counts, and a
     window of ticks inside the brownout traced for the idle share;
 5d. fleet: `fleet_failover` through `run_scenario_cell` (P = 4,
     endpoint 0 down over 0.35-0.65 of the arrival span) and a fleet
     with every mechanism on (speeds 0.5, 1, 1, 2, the same failure, a
     0.3 brownout on endpoint 1 over 0.5-0.85, a per-endpoint bucket of
     0.4 grant/s with burst 6), N = 160 at 4x the rate, W = 256, B = 4,
     the arrival span plus 200 ticks, on the card and on the CPU: equal
     decisions, severity bits, statuses, endpoints, fleet state
     (inflight, requeues, bounces, bucket bits) and phase metrics, (K+1)
     `sched_score_topb` launches a tick (the route term as its fifth
     feature row), requeues on endpoint 0 only, bounces in the second
     cell; the first cell's recovery (phase 2's completion rate over
     phase 0's) printed;
 5e. fleet_scale: `fleet_failover` at the scale run's size (N =
     100,000, W = 4096, B = 16, K = 2, P = 4, 600 ticks with the
     arrivals offered 2,000 / 600 times as fast, so that the fail window
     keeps its share of 2,000 ticks, untraced):
     (K+1) launches a tick, requeues on endpoint 0 only, no request in
     flight on endpoint 0 at a tick inside its fail window, the fleet's
     inflight counts equal to a recount by endpoint on the last tick,
     completions on endpoints 1-3 inside the window, ticks/s;
 5f. session: the live client (`repro_torch.client`).  session_parity:
     `ClientSession` over `MockProvider` in virtual time, `balanced`/
     medium at N = 48, W = 64, B = 4, 600 polls, seeds 0 and 1, and
     `storm` through `MockProvider.from_scenario` at N = 160, 4x the
     rate, W = 256, 1,004 polls: the card's session equal to the same
     session on the CPU and to the port's windowed `run_sim` on the card
     in actions, the request of every live grant, severity bits, each
     request's status and 429 bounces at the horizon and every
     completion's finish bits, (K+1) `sched_score_topb` launches a poll;
     session_recovery: `silent_drop`, `stuck_tail` and `dup_storm` at
     N = 32 (arrivals and schedules over 1,600 ticks) with
     `ResilienceConfig(timeout_mult=3.0, max_resubmits=3)`, polled to
     drain (at most 9,000 polls), held to the reference's gates
     (completion >= 0.99, nothing unfinished, resubmits where a fault
     fired, the duplicate storm completed with duplicates discarded, no
     double retire), `stuck_tail` in a card process of its own and the
     other two in another; session_scale: W = 4096, B = 16,
     K = 2, 100,000
     requests arrived at t = 0 under `benchmarks/client_bench.py`'s
     policy and fast physics, 300 untraced polls (polls/s, completions,
     the `enable_profiling` breakdown), 40 traced (device ops, busy ms
     and idle share a poll), 20 under `torch.cuda.set_sync_debug_mode`
     (device-to-host syncs a poll, printed, not gated), and N = 1,000
     drained at the same W and B for the per-request rate ratio.  The
     CPU sessions, the card's engine runs and the recovery runs go on in
     spawned processes while this one runs the card's sessions; the
     scale run starts after all of them have ended;
 5g. fleet_session: `ClientSession` in virtual time over
     `FleetProvider.from_fleet_scenario` for `fleet_failover` and
     `fleet_skew` (P = 4, N = 160 at 4x the rate, W = 256, B = 4, the
     arrival span plus 200 polls), on the card and on the CPU: equal
     actions, the request of every live grant, severity bits, statuses,
     bounces, finish bits, `n_routed` after every poll and `n_refused`;
     (K+1) `sched_score_topb` launches a poll; `fleet_failover` routes
     nothing to endpoint 0 inside its fail window while what endpoint 0
     held drains; `fleet_skew` routes the most to its fast endpoint; a
     one-endpoint fleet over 5f's `balanced` seed-0 provider equal to the
     bare provider's session and to the card's windowed `run_sim`.  It
     times no rate, so it runs beside phase 4's processes;
 5h. fleet_session_scale: a session over `fleet_failover`'s four
     endpoints (the schedules of 5g at 8x the rate, fast physics with
     comfort 4) at W = 4096, B = 16, K = 2, 100,000 requests arrived at
     t = 0, 300 timed polls and 20 under
     `torch.cuda.set_sync_debug_mode`: (K+1)
     launches a poll, nothing routed to endpoint 0 inside its window,
     polls/s, the `enable_profiling` split, `n_routed`, syncs a poll;
  6. attention_kernels: `flash_attention` and `decode_attention` against
     their plain versions on the card at StableLM-2-1.6B's geometry
     (H = KV = 32, hd = 64, bf16; flash also at B = 4 and with fewer
     queries than keys), StarCoder2-3B's (H = 24, KV = 2, hd = 128,
     windows 64 and 4096), Hymba-1.5B's (H = 25, KV = 5, hd = 64; flash
     past its window 1024; decode at its local ring cache past the
     window, its global cache mid-decode and its batch of 4) and hd =
     32, plus float32 cases (decode also with 32 query heads on one KV
     head, at Hymba's batch of 4 and at StableLM's, whose splits run
     the ring through 10 tiles) and a decode cache whose one valid slot
     is the last; bf16 flash also within one bf16 ulp of its rounding's
     emulation (P rounded to bf16 before P V; plus the emulation's
     allowance for weights that ex2.approx rounds the other way), bf16
     decode within one bf16 ulp of the plain version (both round
     float32 once); times of the kernel, its plain version and `torch.nn.functional.scaled_dot_product_attention`
     (the library yardstick, never called by the port), beside the
     bound; flash's earlier CUDA-core times beside its present ones.
     The zoo's geometries (Arctic (56, 8, 128), Phi-3.5-MoE (32, 8,
     128), Qwen1.5 (40, 40, 128), Nemotron-4 (96, 8, 192), InternVL2
     (14, 2, 64) and MusicGen (32, 32, 64)) run in bf16 and float32 at
     phase 11's prompts and caches.  Every case is timed, float32 ones
     against the CUDA cores' float32 peak;
  7. serve: `stablelm-1.6b` at full width in bf16 with seeded random
     weights answers 6 requests (prompts of 8-1,024 tokens, 8 or 16 new
     tokens each) through `BlackBoxProvider.submit` and
     one batch of 4 through `generate` (greedy, max_seq 2048); the
     launch counts must be 24 a prompt and 24 a decode step; prefill
     and teacher-forced decode logits on the kernels are held against
     the plain versions on the card; prefill and decode times, tokens/s
     and peak memory are reported;
 7b. deployment: phase 7's model, still on the card, behind the client
     scheduler.  Run 1 is the launcher's path: `launch.serve.main`
     (`make_requests(12, seed=0)`, `ScheduledClient`, a wall-clock
     `ClientSession`, `AsyncBlackBoxProvider` with 4 workers,
     `BlackBoxProvider`, `ServeConfig(max_seq=128, temperature=0)`).
     Run 2 is `examples/serve_blackbox.py`'s flow: a `ClientSession`
     over `AsyncBlackBoxProvider(max_inflight=2)`, 16 requests, the
     session's clock at 2x the wall's.  Every request terminal, nothing
     left in flight, every completed output `max_new` tokens equal to
     the same prompt's sequential `submit` afterwards; two generations
     at once at least once, run 2 throttled; exactly 24
     `flash_attention` launches a generation started and 24
     `decode_attention` a decode step (the worker threads' launches),
     and (K+1) `sched_score_topb` a device-stepped poll; completed and
     rejected counts, latency mean and P95, tokens/s across the workers,
     polls and the `enable_profiling` split printed;
  8. ssd_kernel: `ssd_intra` against its plain version on the card at
     the serve runs' shapes (Mamba2-780M: H = 48, P = 64, N = 128, a
     1024-, 8-, 37- and 300-token prompt and a batch of 4 x 256;
     Hymba-1.5B: H = 50, N = 16, 300, 1536 and 2048 tokens and 4 x 256)
     and at two shapes of no served model: one whose every tail is odd
     (37 tokens, H = 5, P = 8, N = 24) and one with N = 201, past a
     tile of B's columns (150 tokens, H = 3, P = 16), each with dt as
     the seeded model gives it and with dt from Mamba2's published
     range, whose slow decay makes the whole chunk count, within 1e-4
     abs/rel on y and state (each case's share of that tolerance
     printed); the heads a CTA and the CTAs the kernel plans; times of
     the kernel and its plain version (no single PyTorch call computes
     it) beside its bound, the larger of the bytes' and its route's
     (the three products in 3xTF32 on the tensor cores, the rest in
     float32), and beside every operation as float32 on the CUDA cores
     (`bound_f32_ms`, the earlier body's route); one device kernel a
     call (torch.profiler, taken before phase 4) at the kernels line's
     shape;
  9. serve_ssm: `mamba2-780m` (48 SSM layers) as phase 7, the same six
     requests and batch; 48 `ssd_intra` launches a prompt, none a
     decode step, no attention;
 10. serve_hybrid: `hymba-1.5b` (32 hybrid layers, window 1024, global
     layers 0, 15, 31) answers prompts of 300 and 1536 tokens (past the
     window), 8 new each, and the batch of 4; 32 `flash_attention` and
     32 `ssd_intra` launches a prompt, 32 `decode_attention` a decode
     step;
 11. serve_zoo: one model at a time, each freed before the next, at
     its published width in bf16 (`ZOO_RUNS`): `phi3.5-moe-42b-a6.6b`
     (8 of 32 layers), `arctic-480b` (2 of 35, by 80 GB),
     `qwen1.5-32b` (16 of 64), `nemotron-4-340b` (4 of 96, by 80 GB),
     `internvl2-1b` (24, whole) and `musicgen-large` (48, whole), the
     prefixed two with seeded prefix embeddings (256 and 64
     positions); prompts of 37 and 512 tokens and the batch of 4 x 256,
     16 new tokens each, max_seq 1024; checks and figures as phase 7's,
     with L `flash_attention` launches a prompt and L
     `decode_attention` a step, and the greedy replay gated; in the MoE
     models the routing flips held by MOE_FLIP_RATIO, none in float32.
     Arctic's and Nemotron's float32 copies do not fit beside them
     (declared in `ZOO_RUNS`): their bf16 rule and float32 check run on
     a one-layer model of its own after the served model is freed;
11b. serve_starcoder2: `starcoder2-3b` whole (30 layers, GQA 24/2 at
     head dim 128, biases on every linear) in bf16: prompts of 37 and
     5,000 tokens, the second past the 4,096-token window, so the ring
     cache wraps in prefill and again in decode, and the batch of 4 x
     256, 16 new tokens each; checks and figures as phase 7's, with 30
     `flash_attention` launches a prompt and 30 `decode_attention` a
     step, the float32 copy beside the model;
 12. train: the trainer (`repro_torch.training`), every kernel's launch
     count 0 across the phase (training runs the plain versions under
     autograd; checked).  (a) `stablelm`, `phi35-moe` (the aux loss,
     capacity drops) and `mamba2` smoke configs in float32, drawn on the
     CPU and copied to the card, 3 `train_step`s on each device over the
     same pipeline batches: losses and grad norms within 1e-4 relative;
     a `microbatches=4` step against the whole batch on the card (loss
     within 1e-4 relative, parameters within 1e-4).  (b)
     `launch.train.run` on `stablelm-smoke` at the reference test's lr
     3e-3, 60 steps of 8 x 64: the last 10 losses' mean at least 0.3
     below the first 10's; its checkpoint restored on the card bit for
     bit, and a bf16 train state (float32 master and moments, the step)
     saved and restored bit for bit.  (c) `stablelm-1.6b` at its
     published width and depth, bf16 parameters, float32 master and
     moments, remat on, batches of 4 x 1024 from the pipeline: 2 warm-up
     and 8 timed steps (ms a step, tokens/s, peak memory, each step's
     loss and grad norm, all finite), one step traced (device ops, busy
     ms, idle share), host syncs in a step counted, and one
     `microbatches=4` step's peak memory beside the whole batch's;
 13. dryrun: the dry run of the production meshes
     (`repro_torch.launch.dryrun`), every kernel's launch count 0 across
     the phase (it allocates and runs nothing on the card but the
     shards; checked).  (a) For all 80 (arch x shape x mesh) combos,
     one pod of 16 x 16 and two of 2 x 16 x 16 devices, the placements
     from the logical-axis rules and one device's bytes of the state
     (`argument_bytes_per_device`: bf16 parameters, a train step's
     float32 master weights and moments, a decode step's caches), each
     within the card's 80 GB; the step run once on `meta` and its FLOPs
     counted for `stablelm-1.6b`'s four shapes.  (b) For each combo in
     turn, rank 0's local slices allocated on the card
     (`materialize_shard`) and freed.  (c) Each allocation equal to the
     prediction with every tensor rounded up to the caching allocator's
     512-byte block (expandable segments on for the phase, so no block
     is kept whole past its request); the five largest combos printed.
 13b. dryrun_sharded: the dry run's sharded step
     (`repro_torch.launch.dryrun.sharded_step`) for `stablelm-1.6b`
     train_4k and decode_32k on the one-pod mesh, as rank 0 of 256 over
     a process group whose collectives move no data.  First the estimate
     on the host (local tensors on `meta`): the rank's temporary bytes
     and its collectives.  Then the same step on the card: rank 0's real
     local shards (uninitialised), a CUDA device mesh, the same fake
     group; the caching allocator's peak over its allocation at the
     step's start within DRYRUN_SHARDED_RTOL of the estimate's
     temporaries (plus DRYRUN_SHARDED_SLACK bytes), and the collectives'
     counts and bytes equal to the estimate's.  Values are not checked
     (the fake group leaves collective outputs undefined; the CPU tests
     hold them against four gloo ranks).  Every kernel's launch count 0
     across the phase.
 14. sync_free: the card's half of the lint's host-sync rule (RPL003,
     `repro_torch.analysis`).  For every function of the lint manifest's
     `sync-free` and `capture-candidates` lists, driven where its caller
     calls it (`SYNC_FREE_RUNS`): one warm call, then SYNC_FREE_REPS
     calls under `torch.cuda.set_sync_debug_mode("warn")`, counting the
     warnings that name a synchronizing operation.  The windowed
     `sim_tick` and the `schedule_batch` it calls at the scale runs'
     width (W = 4096, B = 16, K = 2) with N = 10,000 requests arrived at
     t = 0 (the scale runs' 100,000 cut in depth), launching
     `sched_score_topb` (K+1) times a tick; the session's `_fused_tick`
     inside `ClientSession.poll` at that width over `MockProvider` (the
     poll's designed syncs lie outside it), and the whole poll, the
     capture candidate; `decode_step` at StableLM-2-1.6B's published
     width in bf16, 2 of its 24 layers, launching `decode_attention` a
     layer a step.  Prints each function's static sites (file:line,
     from the lint), runtime syncs, seconds and launches.  A `sync-free`
     function must show neither; a capture candidate must show static
     sites; `.item()` and the poll's summary pull, once a poll, must
     count (the counter's own checks).
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import multiprocessing
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12   # H100 SXM float32, outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
REPS = 60


# phases `--only=a,b` runs (after the build) for a rehearsal
SELECTABLE = {"paper_cell": "phase_paper_cell", "tables": "phase_tables",
              "scenarios": "phase_scenarios",
              "scenario_scale": "phase_scenario_scale",
              "fleet": "phase_fleet", "fleet_scale": "phase_fleet_scale",
              "session": "phase_session",
              "fleet_session": "phase_fleet_session",
              "fleet_session_scale": "phase_fleet_session_scale",
              "deployment": "phase_deployment",
              "attention_kernels": "phase_attention_kernels",
              "serve_zoo": "phase_serve_zoo",
              "serve_starcoder2": "phase_serve_starcoder2",
              "train": "phase_train", "dryrun": "phase_dryrun",
              "dryrun_sharded": "phase_dryrun_sharded",
              "sync_free": "phase_sync_free"}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> None:
    check((ROOT / "src" / "repro_torch").is_dir(),
          "src/repro_torch not found: run from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    dev = torch.device("cuda")
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", kind=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # --- 2. build --------------------------------------------------------
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()])

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, dev, *args)
        seconds[name] = time.perf_counter() - t0
        return out

    only = [a.split("=", 1)[1] for a in sys.argv[1:]
            if a.startswith("--only=")]
    if only:
        # a rehearsal of some scheduler phases: no kernels line and no
        # result line, so it never stands for the whole check
        names = only[0].split(",")
        for name in names:
            check(name in SELECTABLE, f"--only: no phase {name!r}; "
                  f"selectable: {sorted(SELECTABLE)}")
            timed(name, globals()[SELECTABLE[name]])
        emit(phase="seconds", **seconds)
        print(f"chip_smoke: only {names} ran; no result line", flush=True)
        return

    kernels = timed("kernels", phase_kernels)
    ssd_per_call = timed("ssd_kernels_per_call", ssd_kernels_per_call)
    scale = timed("scale", phase_scale, kernels)
    # phase 4 runs beside phases 5a, 5b and 5d, which time no rate; the
    # timed scale runs (5, 5c, 5e, 5f) run without it
    paper_cell = start_paper_cell(torch, dev)
    tables = timed("tables", phase_tables)
    scenarios = timed("scenarios", phase_scenarios)
    fleet = timed("fleet", phase_fleet)
    fleet_session = timed("fleet_session", phase_fleet_session)
    # the wait for phase 4's end
    cell_launches = timed("paper_cell", phase_paper_cell, paper_cell)
    scenario_scale = timed("scenario_scale", phase_scenario_scale)
    fleet_scale = timed("fleet_scale", phase_fleet_scale)
    session = timed("session", phase_session)
    fleet_session_scale = timed("fleet_session_scale",
                                phase_fleet_session_scale)
    # the scheduler's main-path launches: the scale run and these eight
    kernels["sched_score_topb"]["launches"] += (
        tables + scenarios + scenario_scale + fleet + fleet_scale + session
        + fleet_session + fleet_session_scale)
    kernels.update(timed("attention_kernels", phase_attention_kernels))
    keep = {}
    served = timed("serve", phase_serve, kernels, keep)
    # phase 7's model, still on the card, behind the client scheduler
    deployed = timed("deployment", phase_deployment, kernels,
                     keep.pop("model"))
    kernels.update(timed("ssd_kernel", phase_ssd_kernel, ssd_per_call))
    served_ssm = timed("serve_ssm", phase_serve_ssm, kernels)
    served_hybrid = timed("serve_hybrid", phase_serve_hybrid, kernels)
    served_zoo = timed("serve_zoo", phase_serve_zoo, kernels)
    served_starcoder2 = timed("serve_starcoder2", phase_serve_starcoder2,
                              kernels)
    trained = timed("train", phase_train)
    dry = timed("dryrun", phase_dryrun)
    dry_sharded = timed("dryrun_sharded", phase_dryrun_sharded)
    synced = timed("sync_free", phase_sync_free)
    for name, n in synced.items():
        kernels[name]["launches"] += n
    emit(phase="seconds", **seconds)

    print(smi, flush=True)
    emit(kernels=[kernels[k] for k in
                  ("sched_score_topb", "sched_score_argmax",
                   "sched_compact_topb", "flash_attention",
                   "decode_attention", "ssd_intra")])
    check(cell_launches > 0 and scale > 0 and tables > 0 and scenarios > 0
          and scenario_scale > 0 and fleet > 0 and fleet_scale > 0
          and session > 0 and fleet_session > 0 and fleet_session_scale > 0
          and served > 0 and deployed > 0 and served_ssm > 0
          and served_hybrid > 0 and served_zoo > 0
          and served_starcoder2 > 0 and min(synced.values()) > 0,
          "main path launched no kernel")
    check(trained == 0, "training launched a kernel")
    check(dry == 0, "the dry run launched a kernel")
    check(dry_sharded == 0, "the sharded dry run launched a kernel")
    emit(ok=True, device={"platform": "gpu", "kind": kind,
                          "count": torch.cuda.device_count()})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=REPS):
    """Median device time of one call: each call sits between two CUDA
    events, queued behind a spin kernel so the events bracket device
    work, not the host's enqueue."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(n_bytes, n_ops, peak_ops=PEAK_F32_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SCHED_TILE = 4096   # lanes per CTA of top-b and argmax (ops.TILE)
SCHED_SIZES = (256, 2048, 4096, 100_000)
# one CTA's tile and its edges: n = tile - 1 and tile take one CTA,
# tile + 1 and 2 tile + 1 a grid whose last CTA merges the others' lists
SCHED_EDGES = (SCHED_TILE - 1, SCHED_TILE, SCHED_TILE + 1, 2 * SCHED_TILE + 1)
SCHED_PROFILED = (256, 4096, 100_000)   # kernels a call, by the profiler


def sched_feats(torch, gen, dev, n, density, route=False, ties=False,
                tie_at=(), ramp=False):
    """Seeded (wait, cost, urgency, mask, weights, route) on `dev`: all
    lanes equal with `ties`; scores rising with i % 1024 with `ramp`; the
    lanes `tie_at` given one equal score above every other lane's."""
    if ties:
        one = torch.ones(n)
        x = [one * 7, one * 3, one]
    elif ramp:
        x = [(torch.arange(n) % 1024).float() * 10, torch.ones(n),
             torch.zeros(n)]
    else:
        x = [torch.rand(n, generator=gen) * 5e3,
             torch.rand(n, generator=gen) * 3000 + 0.5,
             torch.rand(n, generator=gen) * 2]
    mask = torch.rand(n, generator=gen) < density
    w = torch.tensor([1.0, 0.8, 0.5, 650.0] + ([400.0] if route else []))
    r = torch.rand(n, generator=gen) * 3 if route else None
    for i in tie_at:
        x[0][i], x[1][i], x[2][i], mask[i] = 1e4, 1.0, 0.0, True
        if r is not None:
            r[i] = 0.0
    return [t.to(dev) if t is not None else None for t in (*x, mask, w, r)]


def sched_cases(torch, dev):
    """Phase 3's cases of `sched_score_topb` and `sched_score_argmax`:
    (kernel, label, b, features); b is None for argmax."""
    gen = torch.Generator().manual_seed(1234)
    cases = []

    def add(name, b, n, density, **kw):
        label = f"n={n} b={b} density={density}" + "".join(
            f" {k}={v}" for k, v in kw.items())
        cases.append((name, label, b,
                      sched_feats(torch, gen, dev, n, density, **kw)))
    # n = 256 and 2048 take one CTA; 256 with b = 4 is the paper cell's
    # shape, 4096 and 100,000 the scale run's and the dense path's
    for n in SCHED_SIZES:
        for b in (1, 4, 16, 128):
            for density in (0.1, 0.9):
                for route in (False, True):
                    add("sched_score_topb", b, n, density, route=route)
        add("sched_score_topb", 64, n, 1.0, ties=True)
        add("sched_score_topb", 64, n, 0.0005)           # b > eligible
        for route in (False, True):
            add("sched_score_argmax", None, n, 0.5, route=route)
    for n in SCHED_EDGES:
        for b in (1, 16, 32, 128):
            add("sched_score_topb", b, n, 0.5)
        add("sched_score_topb", 16, n, 0.0)              # all masked
        add("sched_score_topb", 16, n, 0.0005)           # b > eligible
        add("sched_score_argmax", None, n, 0.5)
        add("sched_score_argmax", None, n, 0.0)
    # scores rising with i % 1024: far more keys than CAP pass the
    # kernel's filter, so every warp sorts and the CTA merges
    for n in (SCHED_TILE, 3 * SCHED_TILE + 7):
        for b in (4, 16, 32):
            add("sched_score_topb", b, n, 1.0, ramp=True)
    # more lists than one round of the last CTA takes (TILE / L)
    add("sched_score_topb", 128, 40 * SCHED_TILE + 5, 0.5)
    add("sched_score_topb", 16, 257 * SCHED_TILE, 0.5)
    # equal best scores on both sides of a tile edge: the lower index
    # ranks first
    t = SCHED_TILE
    for n, lanes in ((t + 1, (t - 1, t)), (2 * t + 1, (t - 1, 2 * t)),
                     (100_000, (3 * t - 1, 3 * t, 5 * t + 7))):
        for route in (False, True):
            for b in (1, 16):
                add("sched_score_topb", b, n, 0.5, route=route, tie_at=lanes)
            add("sched_score_argmax", None, n, 0.5, route=route,
                tie_at=lanes)
    return cases


def sched_want(ref, name, b, f):
    """The plain version's answer to one of `sched_cases`."""
    wait, cost, urg, mask, w, r = f
    if name == "sched_score_argmax":
        return ref.sched_score_argmax_ref(wait, cost, urg, mask, w, r)
    return ref.sched_score_topb_ref(wait, cost, urg, mask, w, b, r)


def same_bits(torch, a, b):
    """Equal tensors, float32 compared bit for bit."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# slot pools of `sched_compact_topb`: one CTA's tile and its edges, two
# tiles, and the dense path's 100,000 slots (25 tiles)
COMPACT_WIDTHS = (1, 7, SCHED_TILE - 1, SCHED_TILE, SCHED_TILE + 1,
                  2 * SCHED_TILE, 100_000)
COMPACT_TIMED = (SCHED_TILE, 100_000)
COMPACT_GUARD = 256   # lanes past the compacted ids that must stay unwritten


def compact_pool(torch, gen, dev, w, density, **kw):
    """A seeded slot pool (slot_req, alive, wait, cost, urgency, weights,
    route) on `dev`, features as `sched_feats` makes them."""
    wait, cost, urg, alive, wts, r = sched_feats(torch, gen, dev, w, density,
                                                 **kw)
    req = torch.randperm(3 * w, generator=gen)[:w].to(torch.int32).to(dev)
    return req, alive, wait, cost, urg, wts, r


def below_neg_pool(torch, dev, w):
    """Slots 0, 2, w/2 and w-1 dead, so the sentinel lanes are the last
    four; every live slot scores -3e30, below NEG, except slot 1 (an
    ordinary score), slot w/2 + 1 (one that rounds to NEG exactly: it
    ties the sentinel lanes and ranks first by its lower index) and slot
    w - 2 (-inf).  `lax.top_k` over the compacted pool ranks: slot 1,
    slot w/2 + 1, the four sentinel lanes, then the -3e30 slots in
    order, -inf last."""
    alive = torch.ones(w, dtype=torch.bool)
    alive[[0, 2, w // 2, w - 1]] = False
    urg = torch.full((w,), -3e30)
    urg[[1, w // 2 + 1, w - 2]] = torch.tensor([0.0, -1e30, -float("inf")])
    one = torch.ones(w)
    wts = torch.tensor([1.0, 1.0, 1.0, 100.0])
    return [t.to(dev) for t in (torch.arange(w, dtype=torch.int32), alive,
                                one, one.clone(), urg, wts)] + [None]


def compact_cases(torch, dev):
    """Phase 3's cases of `sched_compact_topb`: (label, b, pool)."""
    gen = torch.Generator().manual_seed(2468)
    cases = []

    def add(w, b, density, **kw):
        label = f"W={w} b={b} density={density}" + "".join(
            f" {k}={v}" for k, v in kw.items())
        cases.append((label, min(b, w),
                      compact_pool(torch, gen, dev, w, density, **kw)))
    for w in COMPACT_WIDTHS:
        for b in (1, 16, 128):
            for density in (0.0, 0.05, 0.6, 1.0):
                add(w, b, density)
            add(w, b, 0.6, route=True)
        add(w, 64, 1.0, ties=True)   # all equal: the lowest positions
    for w in (8, 2 * SCHED_TILE + 8):
        for b in (4, 8):
            cases.append((f"W={w} b={b} below NEG", b,
                          below_neg_pool(torch, dev, w)))
    return cases


def compact_call(torch, lib, pool, b, workspace=None, fill=True):
    """`lib`'s sched_compact_topb on `pool`, as `ops.sched_compact_topb`
    calls it (`workspace(w)` gives its (keys, counters, status); None
    calls a one-CTA build of the earlier signature, without them).  With
    `fill` the outputs start as a sentinel (-7, NaN), so a lane left
    unwritten shows, and COMPACT_GUARD lanes past the ids must keep it.
    Returns (compacted, n_live, idx, score) and whether the guard held."""
    req, alive, wait, cost, urg, wts, r = pool
    w, dev = req.shape[0], req.device
    make = torch.full if fill else (lambda shape, _, **kw: torch.empty(
        shape, **kw))
    ids = make((w + COMPACT_GUARD,), -7, dtype=torch.int32, device=dev)
    n_live = make((), -7, dtype=torch.int32, device=dev)
    idx = make((b,), -7, dtype=torch.int32, device=dev)
    score = make((b,), float("nan"), dtype=torch.float32, device=dev)
    ptrs = [None if t is None else t.data_ptr()
            for t in (req, alive, wait, cost, urg, r, wts)]
    outs = [t.data_ptr() for t in (ids, n_live, idx, score)]
    stream = torch.cuda.current_stream().cuda_stream
    if workspace is None:
        rc = lib.sched_compact_topb(*ptrs, w, b, *outs, stream)
    else:
        ws = [t.data_ptr() for t in workspace(w)]
        rc = lib.sched_compact_topb(*ptrs, w, b, *ws, *outs, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"sched_compact_topb: CUDA error {rc}: {msg}")
    guard = not fill or bool((ids[w:] == -7).all())
    return (ids[:w], n_live, idx, score), guard


def compact_bound(w, b, route=False):
    """`sched_compact_topb`'s bound: the ids, alive and 3-4 float32 rows
    and the weights read once, the compacted ids, n_live and the b ranks
    written; 9 float32 operations a slot."""
    nf = 4 if route else 3
    return bound(w * (4 + 1 + 4 * nf) + 4 * (nf + 1) + w * 4 + 4 + b * 8,
                 w * 9)


def kernels_per_call(torch, fn, calls=10):
    """Device kernels a call of `fn` launches, by torch.profiler over
    `calls` calls (the trace can miss the first kernel event)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / calls


def phase_kernels(torch, dev):
    from repro_torch.kernels.sched_score import ops, ref

    check(ops.TILE == SCHED_TILE, "chip_smoke SCHED_TILE disagrees with "
          "ops.TILE")
    gen = torch.Generator().manual_seed(4321)

    def feats(n, density, route=False):
        return sched_feats(torch, gen, dev, n, density, route)

    def same(a, b):
        return same_bits(torch, a, b)

    err = {"sched_score_topb": 0.0, "sched_score_argmax": 0.0,
           "sched_compact_topb": 0.0}

    def note_err(name, got_score, want_score):
        # equal infinities differ by 0, not NaN
        diff = torch.where(got_score == want_score, 0.0,
                           (got_score - want_score).abs())
        err[name] = max(err[name], float(diff.max()))
    cases = 0
    for name, label, b, f in sched_cases(torch, dev):
        wait, cost, urg, mask, w, r = f
        if name == "sched_score_argmax":
            got = ops.sched_score_argmax(wait, cost, urg, mask, w, r)
        else:
            got = ops.sched_score_topb(wait, cost, urg, mask, w, b, r)
        want = sched_want(ref, name, b, f)
        check(all(map(same, got, want)), f"{name} {label}")
        note_err(name, got[1], want[1])
        cases += 1
    # back to back: a second identical call over several CTAs must give
    # the same bits (the last CTA sets the done counter back to 0)
    for n in SCHED_EDGES[2:] + (100_000,):
        wait, cost, urg, mask, w, _ = feats(n, 0.5)
        for call in (lambda: ops.sched_score_topb(wait, cost, urg, mask, w,
                                                  16),
                     lambda: ops.sched_score_argmax(wait, cost, urg, mask,
                                                    w)):
            first, second = call(), call()
            check(all(map(same, first, second)),
                  f"sched_score n={n}: a repeated call differs")
            cases += 1
    # compaction: outputs filled with a sentinel first, and the lanes
    # past the ids must keep it; a second identical call past one tile
    # must repeat the first (the ticket, done counter and epoch are set
    # for the next call)
    lib = ops._lib()

    def compact(pool, b):
        return compact_call(torch, lib, pool, b,
                            lambda n: ops._compact_workspace(n, dev))
    for label, b, pool in compact_cases(torch, dev):
        req, alive, wait, cost, urg, w, r = pool
        want = ref.sched_compact_topb_ref(req, alive, wait, cost, urg, w, b,
                                          r)
        got, guard = compact(pool, b)
        check(guard and all(map(same, got, want)),
              f"sched_compact_topb {label}")
        note_err("sched_compact_topb", got[3], want[3])
        cases += 1
        if req.shape[0] > SCHED_TILE and b == 16:
            again, guard = compact(pool, b)
            check(guard and all(map(same, got, again)),
                  f"sched_compact_topb {label}: a repeated call differs")
            cases += 1
    torch.cuda.synchronize()
    per_call = {}
    for n in SCHED_PROFILED:
        wait, cost, urg, mask, w, _ = feats(n, 0.5)
        per_call[f"sched_score_argmax n={n}"] = kernels_per_call(
            torch, lambda: ops.sched_score_argmax(wait, cost, urg, mask, w))
        per_call[f"sched_score_topb n={n} b=16"] = kernels_per_call(
            torch, lambda: ops.sched_score_topb(wait, cost, urg, mask, w, 16))
    for n in COMPACT_TIMED:
        pool = compact_pool(torch, gen, dev, n, 0.6)
        per_call[f"sched_compact_topb W={n} b=16"] = kernels_per_call(
            torch, lambda: ops.sched_compact_topb(*pool[:6], 16))
    emit(phase="kernels_vs_plain", cases=cases, exact=True,
         kernels_per_call=per_call)
    check(all(round(v) == 1 for v in per_call.values()),
          f"sched_score: a call launched other than one kernel: {per_call}")

    # times at the main path's shapes: the windowed tick ranks a (4096,)
    # pool with b = 16 (K+1 times a tick); n = 100,000 is the dense path
    out = {}
    rows = []
    # the paper cell ranks n = 256 with b = 4
    wait, cost, urg, mask, w, _ = feats(256, 0.5)
    scores = ref.scores_ref(wait, cost, urg, mask, w)
    t_b, by = bound(256 * (3 * 4 + 1) + w.numel() * 4 + 4 * 8, 256 * 9)
    rows.append(dict(
        name="sched_score_topb", n=256, b=4,
        ms=device_ms(torch, lambda: ops.sched_score_topb(
            wait, cost, urg, mask, w, 4)),
        plain_ms=device_ms(torch, lambda: ref.sched_score_topb_ref(
            wait, cost, urg, mask, w, 4)),
        library_ms=device_ms(torch, lambda: torch.topk(scores, 4)),
        bound_ms=t_b, bound_by=by))
    for n in (4096, 100_000):
        wait, cost, urg, mask, w, _ = feats(n, 0.5)
        scores = ref.scores_ref(wait, cost, urg, mask, w)
        in_bytes = n * (3 * 4 + 1) + w.numel() * 4
        t_b, by = bound(in_bytes + 16 * 8, n * 9)
        row = dict(
            name="sched_score_topb", n=n, b=16,
            ms=device_ms(torch, lambda: ops.sched_score_topb(
                wait, cost, urg, mask, w, 16)),
            plain_ms=device_ms(torch, lambda: ref.sched_score_topb_ref(
                wait, cost, urg, mask, w, 16)),
            library_ms=device_ms(torch, lambda: torch.topk(scores, 16)),
            bound_ms=t_b, bound_by=by)
        rows.append(row)
        t_b, by = bound(in_bytes + 8, n * 9)
        rows.append(dict(
            name="sched_score_argmax", n=n, b=1,
            ms=device_ms(torch, lambda: ops.sched_score_argmax(
                wait, cost, urg, mask, w)),
            plain_ms=device_ms(torch, lambda: ref.sched_score_argmax_ref(
                wait, cost, urg, mask, w)),
            library_ms=device_ms(torch, lambda: torch.argmax(scores)),
            bound_ms=t_b, bound_by=by))
    # compaction: no single PyTorch call computes it; `unfused_ms` is the
    # plain compaction (cumsum + scatter) and then the top-b kernel over
    # the compacted pool
    for n in COMPACT_TIMED:
        pool = compact_pool(torch, gen, dev, n, 0.6)
        t_b, by = compact_bound(n, 16)
        rows.append(dict(
            name="sched_compact_topb", n=n, b=16,
            ms=device_ms(torch, lambda: ops.sched_compact_topb(
                *pool[:6], 16)),
            plain_ms=device_ms(torch, lambda: ref.sched_compact_topb_ref(
                *pool[:6], 16)),
            library_ms=None,
            unfused_ms=device_ms(torch, lambda: unfused_compact_topb(
                torch, ops, ref, pool, 16)),
            bound_ms=t_b, bound_by=by))
    for row in rows:
        emit(phase="kernel_time", **row)
    src = "src/repro_torch/kernels/sched_score/sched_score.cu"
    ref_py = "src/repro/kernels/sched_score/sched_score.py"
    replaces = {"sched_score_topb": f"{ref_py}:382",
                "sched_score_argmax": f"{ref_py}:116",
                "sched_compact_topb": f"{ref_py}:318"}
    for row in rows:
        if row["n"] != 4096:
            continue  # the line carries the windowed main path's shape
        name = row["name"]
        out[name] = dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=0, max_abs_err=err[name], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"])
        if "unfused_ms" in row:
            out[name]["unfused_ms"] = row["unfused_ms"]
    return out


def unfused_compact_topb(torch, ops, ref, pool, b):
    """The two-pass path on the card: the plain compaction, then the
    top-b kernel over the compacted pool."""
    req, alive, wait, cost, urg, w, r = pool
    creq, n_live, mask, cwait, ccost, curg, croute = ref.compact_pool_ref(
        req, alive, wait, cost, urg, r)
    return (creq, n_live,
            *ops.sched_score_topb(cwait, ccost, curg, mask, w, b, croute))


# ---------------------------------------------------------------------------
# 4. the paper cell, card against CPU
# ---------------------------------------------------------------------------

CELL_TOL = dict(rtol=1e-5, atol=1e-6)   # metrics, card against CPU


def _as_torch(torch, obj):
    """numpy leaves (as a CPU job sends them back) -> CPU tensors."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if hasattr(obj, "_fields"):
        return type(obj)(*(_as_torch(torch, v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_as_torch(torch, v) for v in obj)
    return obj


def _jobs_child(conn, device, jobs):
    """A spawned process's body: each `(job, args)` of `jobs` as
    `job(torch, device, *args)` (one thread on the CPU), the results
    sent back with numpy leaves and their seconds, or the first error."""
    import torch

    from repro_torch.bridge import to_numpy

    if device == "cpu":
        torch.set_num_threads(1)
    try:
        out = []
        for job, args in jobs:
            t0 = time.perf_counter()
            res = job(torch, device, *args)
            if device == "cuda":
                torch.cuda.synchronize()
            res = ({k: to_numpy(v) for k, v in res.items()}
                   if isinstance(res, dict) else to_numpy(res))
            out.append((res, time.perf_counter() - t0))
        conn.send(("ok", out))
    except BaseException as e:  # the parent raises it: report, not hang
        conn.send(("error", repr(e)))
    finally:
        conn.close()


class Spawned:
    """`jobs` run one after another in a spawned process of their own on
    `device` while the caller goes on; `result()` joins it and returns
    [(result, seconds)] or raises the child's error.  The process is a
    daemon, so a failing script does not wait for it."""

    def __init__(self, device, jobs):
        ctx = multiprocessing.get_context("spawn")
        self.recv, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_jobs_child, args=(send, device, jobs),
                                daemon=True)
        self.proc.start()
        send.close()
        self.what = f"{device}: " + ", ".join(
            f"{job.__name__}{args}" for job, args in jobs)

    def result(self):
        try:
            try:
                msg = self.recv.recv()
            except EOFError:
                msg = ("error", "the process died")
        finally:
            self.proc.join(timeout=60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
            self.recv.close()
        check(msg[0] == "ok", f"the spawned run failed ({self.what}): "
              f"{msg[1]}")
        return msg[1]


def card_and_cpu(torch, job, cases):
    """`job(torch, device, *args)` for each `args` of `cases`, one after
    another on the card and, at the same time in one spawned process,
    on the CPU: for each case, each result with its seconds and, for the
    card, the `sched_score_topb` launches (counted from 0 just before
    the run; the CPU runs the plain version).  The host is what paces
    both runs, and the machine has cores to spare; one process for all
    the cases starts the CPU once."""
    from repro_torch.kernels.sched_score import ops

    cpu = Spawned("cpu", [(job, args) for args in cases])
    cards = []
    for args in cases:
        ops.reset_launches()
        t0 = time.perf_counter()
        card = job(torch, "cuda", *args)
        torch.cuda.synchronize()
        cards.append((card, time.perf_counter() - t0,
                      ops.LAUNCHES["sched_score_topb"]))
    return [(card, (_as_torch(torch, out), cpu_secs, None))
            for card, (out, cpu_secs) in zip(cards, cpu.result())]


def same_run(torch, what, card, cpu):
    """Card against CPU: equal decision traces (actions and request ids),
    severity traces equal in bits, equal terminal statuses and throttle
    counts, metrics within `CELL_TOL`."""
    (mg, (fg, tg)), (mc, (fc, tc)) = card, cpu
    tg = [x.cpu() for x in tg]
    check(torch.equal(tg[0], tc[0]) and torch.equal(tg[1], tc[1]),
          f"{what}: decision traces differ between card and CPU")
    check(torch.equal(tg[2].view(torch.int32), tc[2].view(torch.int32)),
          f"{what}: severity traces differ between card and CPU")
    check(torch.equal(fg.req.status.cpu(), fc.req.status),
          f"{what}: terminal statuses differ")
    check(torch.equal(fg.req.n_throttles.cpu(), fc.req.n_throttles)
          and int(fg.provider.n_throttled) == int(fc.provider.n_throttled),
          f"{what}: throttle counts differ")
    for f in mg._fields:
        a = getattr(mg, f).cpu().double().numpy()
        b = getattr(mc, f).double().numpy()
        check(np.allclose(a, b, equal_nan=True, **CELL_TOL),
              f"{what}: metric {f} {a} vs {b}")


# the cell's last request finishes at tick 4,527, so 7,000 ticks give
# the metrics of `main_policy.py`'s 14,000
PAPER_TICKS = 7000


def paper_cell_run(torch, d):
    from repro_torch.core.policy import strategy
    from repro_torch.sim import SimConfig, WorkloadConfig, run_cell

    wl = WorkloadConfig(n_requests=160, mix="balanced", congestion="high")
    cfg = SimConfig(n_ticks=PAPER_TICKS, k_slots=4, window=256)
    metrics, runs = run_cell(strategy("final_adrr_olc"), wl, seeds=1,
                             sim_cfg=cfg, device=d, collect_decisions=True)
    return metrics, runs[0]


def card_job(torch, d, job, *args):
    """`job(torch, d, *args)`, the `sched_score_topb` launches it made and
    its seconds, both counted from just before it, after one warm-up
    launch has made the process's CUDA context and loaded the kernels'
    library: a card run for a spawned process."""
    from repro_torch.kernels.sched_score import ops

    n = 256
    z = torch.zeros(n, device=d)
    ops.sched_score_topb(z, z, z, torch.ones(n, dtype=torch.bool, device=d),
                         torch.ones(4, device=d), 4)
    if d == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = job(torch, d, *args)
    if d == "cuda":
        torch.cuda.synchronize()
    return {"out": out, "launches": ops.LAUNCHES["sched_score_topb"],
            "seconds": time.perf_counter() - t0}


def start_paper_cell(torch, dev):
    """Phase 4's card and CPU runs, each in a spawned process of its own,
    so that the card's 7,000 ticks overlap the phases the caller runs
    until `phase_paper_cell` reads them (host-bound, the card idle >90%;
    this adds one busy process beside each of them)."""
    return (Spawned(dev.type, [(card_job, (paper_cell_run,))]),
            Spawned("cpu", [(paper_cell_run, ())]))


def phase_paper_cell(torch, dev, started=None):
    card_p, cpu_p = started or start_paper_cell(torch, dev)
    ((g, _),) = card_p.result()
    ((cpu, secs_c),) = cpu_p.result()
    card, launches = _as_torch(torch, g["out"]), int(g["launches"])
    secs_g = float(g["seconds"])
    cpu = _as_torch(torch, cpu)
    k = 2
    check(launches == (k + 1) * PAPER_TICKS,
          f"paper cell: {launches} sched_score_topb launches, want "
          f"{(k + 1) * PAPER_TICKS}")
    same_run(torch, "paper cell", card, cpu)
    mg = card[0]
    emit(phase="paper_cell", n_requests=160, n_ticks=PAPER_TICKS, window=256,
         k_slots=4, decisions_equal=True, statuses_equal=True,
         sched_score_topb_launches=launches,
         short_p95_ms=float(mg.short_p95_ms[0]),
         completion_rate=float(mg.completion_rate[0]),
         satisfaction=float(mg.satisfaction[0]),
         goodput_rps=float(mg.goodput_rps[0]),
         card_seconds=secs_g, cpu_seconds=secs_c,
         card_ticks_per_s=PAPER_TICKS / secs_g)
    return launches


# ---------------------------------------------------------------------------
# 5. the scale run on the card
# ---------------------------------------------------------------------------

TRACE_FROM, TRACE_TICKS = 200, 40   # the scale run's traced window
# ticks of the scale runs 5 and 5e, few to keep the script within its
# time limit on a slow host (5c takes its own, SCENARIO_SCALE)
SCALE_TICKS = 600


def scale_span(n, n_ticks):
    """The arrival scale of a scale-sized scenario (5c, 5e): N requests
    offered over the N = 160 span made 2,000 / n_ticks times shorter,
    so that its brownout and fail windows keep the share of the run
    they had at 2,000 ticks."""
    return n / 160 * (2000 / n_ticks)


def device_activity(torch, prof):
    """(busy µs, device ops, µs by name) of a finished profile: its device
    events (kernels, memcpy, memset) read straight from the trace's
    events, without the per-op tables `key_averages` builds, which cost
    tens of seconds a window (`tools/trace_activities.py` holds the two
    readings against each other)."""
    cuda = torch.autograd.DeviceType.CUDA
    busy_us, n_ops, per_name = 0.0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        us = e.duration_ns() / 1e3
        if us > 0:
            busy_us += us
            n_ops += 1
            per_name[e.name()] = per_name.get(e.name(), 0.0) + us
    return busy_us, n_ops, per_name


class TickTrace:
    """`torch.profiler` over ticks [start, start + ticks) of a run, driven
    from the run's `on_tick`; `fields` reads the device's busy time and
    idle share a tick from the trace (`device_activity`).  The profiler
    records host and device activity; `cpu=False` records the device's
    only, which lost device events in some runs
    (`tools/trace_activities.py`)."""

    def __init__(self, torch, start, ticks=TRACE_TICKS, cpu=True):
        self.torch, self.start, self.ticks = torch, start, ticks
        self.cpu = cpu
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if cpu:
            acts.insert(0, torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.clock = {}

    def tick(self, t):
        clock = self.clock
        if t == self.start - 1:
            self.torch.cuda.synchronize()
            clock["enter"] = time.perf_counter()
            self.prof.start()
            clock["t0"] = time.perf_counter()
        elif t == self.start + self.ticks - 1:
            self.torch.cuda.synchronize()
            clock["t1"] = time.perf_counter()
            self.prof.stop()
            clock["exit"] = time.perf_counter()

    def fields(self, what, secs, n_ticks):
        """The run's untraced rate and the traced window's figures."""
        t_read = time.perf_counter()
        busy_us, n_device_ops, per_name = device_activity(self.torch,
                                                          self.prof)
        read_s = time.perf_counter() - t_read
        check(n_device_ops > 0, f"{what}: the trace shows no device work")
        clock, n = self.clock, self.ticks
        wall_ms = (clock["t1"] - clock["t0"]) * 1e3 / n
        untraced_s = secs - (clock["exit"] - clock["enter"])
        busy_ms = busy_us / 1e3 / n
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        return dict(
            ticks_per_s_untraced=(n_ticks - n) / untraced_s,
            traced_ticks=n, traced_from=self.start,
            traced_activities="cpu+cuda" if self.cpu else "cuda",
            traced_wall_ms_per_tick=wall_ms,
            traced_device_busy_ms_per_tick=busy_ms,
            traced_device_idle_share=1.0 - busy_ms / wall_ms,
            traced_device_ops_per_tick=n_device_ops / n,
            trace_stop_seconds=clock["exit"] - clock["t1"],
            trace_read_seconds=read_s,
            traced_top_device_us_per_tick=[
                [name[:60], us / n] for name, us in top])


def phase_scale(torch, dev, kernels):
    from repro_torch.core.ordering import _wait_and_urgency
    from repro_torch.core.overload import ADMIT
    from repro_torch.core.policy import strategy
    from repro_torch.core.types import COMPLETED, INFLIGHT, PENDING
    from repro_torch.device import to_device
    from repro_torch.kernels.sched_score import ops, ref
    from repro_torch.sim import (SimConfig, WorkloadConfig, default_physics,
                                 generate, run_sim)
    from repro_torch.sim.engine import _retire_window, _window_view

    n, w, b, k = 100_000, 4096, 16, 2
    cfg = SimConfig(n_ticks=SCALE_TICKS, k_slots=b, window=w)
    wl = WorkloadConfig(n_requests=n, mix="balanced", congestion="high",
                        arrival_scale=n / 160, class_map="paper2")
    batch, jitter = generate(wl, torch.Generator().manual_seed(0),
                             device=dev)
    policy = strategy("final_adrr_olc")
    occupancy = torch.zeros(cfg.n_ticks, dtype=torch.int32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    slots = torch.arange(w, dtype=torch.int32, device=dev)
    broken = torch.zeros((), dtype=torch.bool, device=dev)
    trace = TickTrace(torch, TRACE_FROM)
    snap = {}

    def on_tick(t, state, win):
        occupancy[t] = win.n_live
        # on the device, no host sync: the live prefix holds admitted ids,
        # strictly increasing (none twice), the tail the sentinel n; every
        # admitted request outside the window is terminal (none lost); and
        # no request past the admission pointer has been touched
        req, status = win.slot_req, state.req.status
        live = slots < win.n_live
        in_order = (req[1:] > req[:-1]) | ~live[1:]
        in_range = torch.where(live, (req >= 0) & (req < win.arr_ptr),
                               req == n)
        in_win = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill_(
            0, req.long(), True)[:n]
        admitted = ids < win.arr_ptr
        open_ = (status == PENDING) | (status == INFLIGHT)
        lost = admitted & ~in_win & open_
        early = ~admitted & ((status != PENDING)
                             | torch.isfinite(state.req.submit_ms))
        broken.logical_or_(~(in_order.all() & in_range.all())
                           | lost.any() | early.any())
        if t == cfg.n_ticks // 2:
            snap["state"], snap["win"] = state, win
        trace.tick(t)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, (actions, _, _) = run_sim(
        policy, batch, jitter, default_physics(), cfg, device=dev,
        on_tick=on_tick, collect_decisions=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["sched_score_topb"] == (k + 1) * cfg.n_ticks,
          f"scale: {launches['sched_score_topb']} sched_score_topb "
          f"launches, want {(k + 1) * cfg.n_ticks}")
    for name, count in launches.items():
        kernels[name]["launches"] = count

    check(not bool(broken), "scale: on some tick the window held a request "
          "twice, out of order or not yet admitted, lost an open request, "
          "or a request past the admission pointer was touched")
    status = final.req.status
    counts = torch.bincount(status.long(), minlength=5).tolist()
    check(counts[PENDING] == 0 and counts[INFLIGHT] == 0,
          f"scale: requests left live after the drain: {counts}")
    check(int(final.provider.inflight) == 0,
          "scale: the provider holds requests after the drain")
    n_admits = int((actions == ADMIT).sum())
    n_submitted = int(torch.isfinite(final.req.submit_ms).sum())
    check(n_admits == n_submitted,
          f"scale: {n_admits} ADMIT decisions but {n_submitted} requests "
          "handed to the provider")
    check(int(final.sched.n_completed_obs) == counts[COMPLETED],
          "scale: completions observed != requests completed")

    # the slot pool the next tick would compact, held against the plain
    # version: slot ids, survivors of the retire pass, score features
    win = snap["win"]
    policy_d, phys_d = to_device((policy, default_physics()), dev)
    now = torch.tensor((cfg.n_ticks // 2 + 2) * cfg.dt_ms,
                       dtype=torch.float32, device=dev)
    state = snap["state"]._replace(now_ms=now)
    _, alive = _retire_window(policy_d, phys_d, batch, state, win)
    view, _, _ = _window_view(batch, state.req, win.slot_req)
    wait, urg = _wait_and_urgency(view, now)
    wts = torch.stack([policy_d.ord_w_wait, policy_d.ord_w_size,
                       policy_d.ord_w_urg, policy_d.ord_ref_tokens])
    args = (win.slot_req, alive, wait, view.p50, urg, wts, b)
    got = ops.sched_compact_topb(*args)
    want = ref.sched_compact_topb_ref(*args)
    check(all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                          else x, y.view(torch.int32)
                          if y.dtype == torch.float32 else y)
              for x, y in zip(got, want)),
          "scale: sched_compact_topb differs from its plain version on the "
          "run's slot pool")

    occ = occupancy.float()
    emit(phase="scale", n_requests=n, window=w, k_slots=b, classes=k,
         n_ticks=cfg.n_ticks, seconds=secs,
         occupancy_mean=float(occ.mean()), occupancy_max=int(occ.max()),
         status_counts=counts, admits=n_admits,
         sched_score_topb_launches=launches["sched_score_topb"],
         compact_snapshot_live=int(alive.sum()), compact_snapshot_exact=True,
         **trace.fields("scale", secs, cfg.n_ticks))
    return launches["sched_score_topb"]


# ---------------------------------------------------------------------------
# 5a. the paper tables' policy variants, card against CPU
# ---------------------------------------------------------------------------

# ticks of the table cells (few, for the script's time limit) and the
# arrival rate that lands their traffic inside them
TABLE_TICKS = 500
TABLE_RATE = 8.0


def table_cells():
    """name -> (policy, workload, physics or None): the information
    ladder's no_info rung, the reverse overload shape on heavy/high, the
    4-lane per-bucket and 4-tenant schemes, and a provider at 13 ms a
    token.  N = 160 at TABLE_RATE, 8x (its arrivals land in 400 ticks);
    heavy/high at twice that, and the slower provider's load
    renormalized to its knee as `benchmarks/arch_physics.py` does, so
    each cell's traffic lands inside the horizon."""
    from repro_torch.core import policy as pol
    from repro_torch.sim import WorkloadConfig
    from repro_torch.sim.provider import physics_for_arch
    from repro_torch.sim.workload import _MEAN_TOKENS

    def wl(**kw):
        return WorkloadConfig(**{**dict(n_requests=160, mix="balanced",
                                        congestion="high",
                                        arrival_scale=TABLE_RATE), **kw})

    final = pol.final_adrr_olc()
    mean = _MEAN_TOKENS["balanced"]
    arch_scale = TABLE_RATE * (90.0 + 6.5 * mean) / (90.0 + 13.0 * mean)
    return {
        "info_no_info": (pol.with_information(final, "no_info"),
                         wl(information="no_info"), None),
        "shape_reverse": (pol.with_bucket_policy(final, "reverse"),
                          wl(mix="heavy", arrival_scale=2 * TABLE_RATE),
                          None),
        "per_bucket": (pol.per_bucket_policy(), wl(class_map="bucket4"),
                       None),
        "tenant4": (pol.multi_tenant_policy(4), wl(class_map="tenant4"),
                    None),
        "arch_13ms": (final, wl(arrival_scale=arch_scale),
                      physics_for_arch(ms_per_token=13.0)),
    }


def table_run(torch, d, name):
    from repro_torch.sim import SimConfig, run_cell

    policy, wl, phys = table_cells()[name]
    cfg = SimConfig(n_ticks=TABLE_TICKS, k_slots=4, window=256)
    metrics, runs = run_cell(policy, wl, seeds=1, phys=phys, sim_cfg=cfg,
                             device=d, collect_decisions=True)
    return metrics, runs[0]


def phase_tables(torch, dev):
    from repro_torch.core.overload import ADMIT, DEFER, REJECT
    from repro_torch.core.policy import n_classes

    total, cells = 0, {}
    variants = table_cells()
    runs = card_and_cpu(torch, table_run, [(name,) for name in variants])
    for (name, (policy, _, _)), run in zip(variants.items(), runs):
        (card, secs_g, launches), (cpu, secs_c, _) = run
        k = n_classes(policy)
        check(launches == (k + 1) * TABLE_TICKS,
              f"tables {name}: {launches} sched_score_topb launches, want "
              f"{(k + 1) * TABLE_TICKS}")
        same_run(torch, f"tables {name}", card, cpu)
        total += launches
        m, (_, (actions, _, _)) = card
        actions = actions.cpu()
        cells[name] = dict(
            classes=k, launches=launches, card_seconds=secs_g,
            cpu_seconds=secs_c,
            admits=int((actions == ADMIT).sum()),
            defers=int((actions == DEFER).sum()),
            rejects=int((actions == REJECT).sum()),
            completion_rate=float(m.completion_rate[0]),
            short_p95_ms=float(m.short_p95_ms[0]),
            satisfaction=float(m.satisfaction[0]))
    emit(phase="tables", n_requests=160, n_ticks=TABLE_TICKS, window=256,
         k_slots=4, decisions_equal=True, statuses_equal=True,
         sched_score_topb_launches=total, cells=cells)
    return total


# ---------------------------------------------------------------------------
# 5b. scenarios with provider dynamics, card against CPU
# ---------------------------------------------------------------------------

SCENARIO_DRAIN_TICKS = 200


def scenario_cfg(sc, n, scale):
    """The N = 160 cells' horizon: the arrival span plus the drain."""
    from repro_torch.sim import SimConfig
    from repro_torch.sim.scenarios import arrival_span_ms

    return SimConfig(n_ticks=math.ceil(arrival_span_ms(sc, n, scale) / 25.0)
                     + SCENARIO_DRAIN_TICKS, k_slots=4, window=256)


def scenario_run(torch, d, sc, n, scale):
    """`sc` through `run_scenario_cell` at N = n, `arrival_scale` scale:
    ((metrics, (final, trace)), phase metrics)."""
    from repro_torch.core.policy import strategy
    from repro_torch.sim import run_scenario_cell

    m, pm, runs = run_scenario_cell(
        strategy("final_adrr_olc"), sc, seeds=1, n_requests=n,
        sim_cfg=scenario_cfg(sc, n, scale), arrival_scale=scale, device=d,
        collect_decisions=True)
    return (m, runs[0]), pm


def phase_scenarios(torch, dev):
    from repro_torch.sim.scenarios import get_scenario

    n, scale, k = 160, 4.0, 2
    total, rows = 0, {}
    names = ("storm", "rate_crunch")
    runs = card_and_cpu(torch, scenario_run,
                        [(get_scenario(name), n, scale) for name in names])
    for name, run in zip(names, runs):
        sc = get_scenario(name)
        cfg = scenario_cfg(sc, n, scale)
        ((card, pm_g), secs_g, launches), ((cpu, pm_c), secs_c, _) = run
        check(launches == (k + 1) * cfg.n_ticks,
              f"scenarios {name}: {launches} sched_score_topb launches, "
              f"want {(k + 1) * cfg.n_ticks}")
        same_run(torch, f"scenarios {name}", card, cpu)
        for f in pm_g._fields:
            a, b = getattr(pm_g, f).cpu().numpy(), getattr(pm_c, f).numpy()
            check(np.array_equal(a, b, equal_nan=True),
                  f"scenarios {name}: phase metric {f} {a} vs {b}")
        throttled = int(card[1][0].provider.n_throttled)
        check(throttled > 0, f"scenarios {name}: the limiter never bounced")
        total += launches
        rows[name] = dict(
            n_ticks=cfg.n_ticks, launches=launches, card_seconds=secs_g,
            cpu_seconds=secs_c, n_throttled=throttled,
            phase_arrived=pm_g.n_arrived[0].tolist(),
            phase_completed=pm_g.n_completed[0].tolist(),
            phase_shed=pm_g.shed_by_bucket[0].sum(dim=-1).tolist(),
            phase_abandoned=pm_g.n_abandoned[0].tolist(),
            phase_throttled=pm_g.n_throttled[0].tolist())
    emit(phase="scenarios", n_requests=n, arrival_scale=scale, window=256,
         k_slots=4, decisions_equal=True, statuses_equal=True,
         phase_metrics_equal=True, sched_score_topb_launches=total,
         scenarios=rows)
    return total


# ---------------------------------------------------------------------------
# 5c. the storm scenario at the scale run's size, on the card
# ---------------------------------------------------------------------------

# the traced window lies inside the flash crowd and the brownout
# (ticks 386-642 of the scale-sized storm; the run ends at 799)
SCENARIO_TRACE_FROM = 480


def brownout_check(torch, phys, batch, jitter, final, actions, req_idx,
                   infl_after, comfort, dt_ms):
    """Each real admit's observed load multiplier (its service over the
    unloaded latency and jitter) against the physics at the inflight
    count the grant saw and the tick's comfort scale; then, at each
    inflight level past the browned-out knee met both inside and outside
    the brownout, the mean multiplier inside against outside.  The
    inflight a grant saw is the tick's count before dispatch (after the
    tick, less its real admits) plus the ADMIT decisions before it in
    the batch, bounced ones included, as `schedule_batch` counts."""
    from repro_torch.core.overload import ADMIT
    from repro_torch.sim.provider import load_multiplier, unloaded_latency_ms

    n = batch.n
    t_all = actions.shape[0]
    nows = (torch.arange(1, t_all + 1, dtype=torch.float32,
                         device=actions.device) * dt_ms)
    admit = actions == ADMIT
    rid = torch.clamp(req_idx, 0, n - 1).long()
    real = admit & (final.req.submit_ms[rid] == nows[:, None])
    before = infl_after - real.sum(dim=1, dtype=torch.int32)
    prior = torch.cumsum(admit.int(), dim=1) - admit.int()
    seen = (before[:, None] + prior)[real]
    scale = comfort[:, None].expand_as(real)[real]
    rows = rid[real]
    observed = ((final.req.finish_ms[rows] - nows[:, None].expand_as(
        real)[real]) / jitter[rows]) / unloaded_latency_ms(
        phys, batch.true_tokens[rows])
    want = load_multiplier(phys, seen, scale)
    rel = float(((observed - want).abs() / want).max())
    check(rel < 1e-4, f"scenario_scale: an admit's service is off its "
          f"physics by {rel:.3g} (relative)")
    inside = scale < 1.0
    knee = float(phys.comfort_concurrency) * float(scale.min())
    levels = {}
    for lvl in torch.unique(seen).tolist():
        at = seen == lvl
        a_in, a_out = observed[at & inside], observed[at & ~inside]
        if lvl > knee and a_in.numel() and a_out.numel():
            levels[int(lvl)] = (float(a_in.mean()), float(a_out.mean()),
                                a_in.numel(), a_out.numel())
    check(levels and all(i > o for i, o, _, _ in levels.values()),
          f"scenario_scale: the brownout did not slow service at equal "
          f"inflight: {levels}")
    return dict(admits_checked=int(real.sum()), max_rel_err=rel,
                admits_in_brownout=int(inside.sum()),
                multiplier_in_out_by_inflight={
                    k: [v[0], v[1]] for k, v in sorted(levels.items())})


# N, W, B and ticks of the scale-sized storm: the scale run's N, W and
# B; more ticks than SCALE_TICKS, so that the brownout check meets
# admits inside and outside the brownout at equal inflight
SCENARIO_SCALE = (100_000, 4096, 16, 800)


def phase_scenario_scale(torch, dev):
    from repro_torch.core.policy import strategy
    from repro_torch.core.types import INFLIGHT, PENDING
    from repro_torch.device import to_device
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim import (SimConfig, compute_phase_metrics,
                                 default_physics, generate, run_sim)
    from repro_torch.sim.scenarios import build, get_scenario

    (n, w, b, n_ticks), k = SCENARIO_SCALE, 2
    cfg = SimConfig(n_ticks=n_ticks, k_slots=b, window=w)
    wl, sched, dyn, edges = build(get_scenario("storm"), n, cfg.n_ticks,
                                  cfg.dt_ms, limiter_classes=k,
                                  arrival_scale=scale_span(n, n_ticks))
    batch, jitter = generate(wl, torch.Generator().manual_seed(0),
                             device=dev, sched=sched)
    policy, phys = strategy("final_adrr_olc"), default_physics()
    infl_after = torch.zeros(cfg.n_ticks, dtype=torch.int32, device=dev)
    trace = TickTrace(torch, SCENARIO_TRACE_FROM)

    def on_tick(t, state, win):
        infl_after[t] = state.provider.inflight
        trace.tick(t)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, (actions, req_idx, _) = run_sim(
        policy, batch, jitter, phys, cfg, dyn, device=dev, on_tick=on_tick,
        collect_decisions=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.LAUNCHES["sched_score_topb"]
    check(launches == (k + 1) * cfg.n_ticks,
          f"scenario_scale: {launches} sched_score_topb launches, want "
          f"{(k + 1) * cfg.n_ticks}")
    counts = torch.bincount(final.req.status.long(), minlength=5).tolist()
    check(counts[PENDING] == 0 and counts[INFLIGHT] == 0,
          f"scenario_scale: requests left live after the drain: {counts}")
    throttled = int(final.provider.n_throttled)
    check(throttled > 0 and throttled == int(final.req.n_throttles.sum()),
          f"scenario_scale: {throttled} bounces, "
          f"{int(final.req.n_throttles.sum())} on the requests")
    phys_d, dyn_d = to_device((phys, dyn), dev)
    brownout = brownout_check(torch, phys_d, batch, jitter, final, actions,
                              req_idx, infl_after, dyn_d.comfort_scale,
                              cfg.dt_ms)
    pm = compute_phase_metrics(batch, final, edges, k)
    emit(phase="scenario_scale", scenario="storm", n_requests=n, window=w,
         k_slots=b, classes=k, n_ticks=cfg.n_ticks,
         arrival_scale=scale_span(n, n_ticks),
         seconds=secs, sched_score_topb_launches=launches,
         status_counts=counts, n_throttled=throttled,
         phase_edges_ms=edges.tolist(),
         phase_arrived=pm.n_arrived.tolist(),
         phase_completed=pm.n_completed.tolist(),
         phase_shed=pm.shed_by_bucket.sum(dim=-1).tolist(),
         phase_abandoned=pm.n_abandoned.tolist(),
         phase_throttled=pm.n_throttled.tolist(),
         brownout=brownout,
         **trace.fields("scenario_scale", secs, cfg.n_ticks))
    return launches


# ---------------------------------------------------------------------------
# 5d. the fleet axis, card against CPU
# ---------------------------------------------------------------------------

def fleet_cells():
    """name -> Scenario: the registry's `fleet_failover`, and the same
    traffic on a fleet with every mechanism on, widened as the
    reference's `benchmarks/fleet_sweep.py` widens its fleet."""
    from repro_torch.sim.scenarios import FleetSpec, get_scenario

    base = get_scenario("fleet_failover")
    return {
        "fleet_failover": base,
        "fleet_all_on": base._replace(name="fleet_all_on", fleet=FleetSpec(
            p=4, speed_mult=(0.5, 1.0, 1.0, 2.0),
            fail_windows=((0, 0.35, 0.65),),
            brownouts=((1, 0.5, 0.85, 0.3),), tb_rate_rps=0.4,
            tb_burst=6.0)),
    }


def recovery(pm):
    """Phase 2's completion rate over phase 0's (the arrivals after the
    fail window against those before it), as the reference's
    `benchmarks/fleet_sweep.py` `_recovery` defines it."""
    arrived = pm.n_arrived[0].double().cpu()
    completed = pm.n_completed[0].double().cpu()
    pre = float(completed[0] / max(float(arrived[0]), 1.0))
    post = float(completed[-1] / max(float(arrived[-1]), 1.0))
    return post / pre if pre > 0 else float("nan")


def phase_fleet(torch, dev):
    n, scale, k = 160, 4.0, 2
    total, rows = 0, {}
    cells = fleet_cells()
    runs = card_and_cpu(torch, scenario_run,
                        [(sc, n, scale) for sc in cells.values()])
    for (name, sc), run in zip(cells.items(), runs):
        cfg = scenario_cfg(sc, n, scale)
        ((card, pm_g), secs_g, launches), ((cpu, pm_c), secs_c, _) = run
        check(launches == (k + 1) * cfg.n_ticks,
              f"fleet {name}: {launches} sched_score_topb launches, want "
              f"{(k + 1) * cfg.n_ticks}")
        same_run(torch, f"fleet {name}", card, cpu)
        for f in pm_g._fields:
            a, b = getattr(pm_g, f).cpu().numpy(), getattr(pm_c, f).numpy()
            check(np.array_equal(a, b, equal_nan=True),
                  f"fleet {name}: phase metric {f} {a} vs {b}")
        fg, fc = card[1][0], cpu[1][0]
        check(torch.equal(fg.req.endpoint.cpu(), fc.req.endpoint),
              f"fleet {name}: endpoints differ between card and CPU")
        for f in ("inflight", "n_requeued", "n_throttled", "tb_tokens"):
            a, b = getattr(fg.fleet, f).cpu(), getattr(fc.fleet, f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            check(torch.equal(a, b), f"fleet {name}: FleetState.{f} differs "
                  f"between card and CPU")
        requeued = fg.fleet.n_requeued.cpu()
        throttled = fg.fleet.n_throttled.cpu()
        check(int(requeued[0]) > 0 and int(requeued[1:].sum()) == 0,
              f"fleet {name}: requeues {requeued.tolist()}, want them on "
              f"endpoint 0 only")
        if name == "fleet_all_on":
            check(int(throttled.sum()) > 0,
                  f"fleet {name}: the per-endpoint buckets never bounced")
        status = fg.req.status.cpu()
        sent = torch.isfinite(fg.req.submit_ms.cpu())
        total += launches
        rows[name] = dict(
            n_ticks=cfg.n_ticks, launches=launches, card_seconds=secs_g,
            cpu_seconds=secs_c, card_ticks_per_s=cfg.n_ticks / secs_g,
            n_requeued=requeued.tolist(), n_throttled=throttled.tolist(),
            admitted_by_endpoint=torch.bincount(
                fg.req.endpoint.cpu()[sent].long(), minlength=4).tolist(),
            status_counts=torch.bincount(status.long(),
                                         minlength=5).tolist(),
            completion_rate=float(card[0].completion_rate[0]),
            recovery=recovery(pm_g),
            phase_arrived=pm_g.n_arrived[0].tolist(),
            phase_completed=pm_g.n_completed[0].tolist(),
            phase_throttled=pm_g.n_throttled[0].tolist())
    emit(phase="fleet", n_requests=n, arrival_scale=scale, window=256,
         k_slots=4, endpoints=4, decisions_equal=True, statuses_equal=True,
         endpoints_equal=True, fleet_state_equal=True,
         phase_metrics_equal=True, sched_score_topb_launches=total,
         cells=rows)
    return total


# ---------------------------------------------------------------------------
# 5e. fleet_failover at the scale run's size, on the card
# ---------------------------------------------------------------------------

# N, W, B and ticks of the scale-sized fleet: the scale run's
FLEET_SCALE = (100_000, 4096, 16, SCALE_TICKS)
# endpoint 0's fail window at `scale_span`: ticks 337-599 of 600, as
# 1124-1999 of 2,000


def phase_fleet_scale(torch, dev):
    from repro_torch.core.policy import strategy
    from repro_torch.core.types import COMPLETED, INFLIGHT, PENDING
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim import SimConfig, default_physics, generate, run_sim
    from repro_torch.sim.scenarios import build, build_fleet, get_scenario

    (n, w, b, n_ticks), k = FLEET_SCALE, 2
    cfg = SimConfig(n_ticks=n_ticks, k_slots=b, window=w)
    sc = get_scenario("fleet_failover")
    scale = scale_span(n, n_ticks)
    wl, sched, dyn, _ = build(sc, n, cfg.n_ticks, cfg.dt_ms,
                              limiter_classes=k, arrival_scale=scale)
    check(dyn is None, "fleet_scale: a fleet scenario built provider dynamics")
    phys = default_physics()
    fleet = build_fleet(sc, phys, cfg.n_ticks, cfg.dt_ms, n, k, scale)
    p = fleet.phys.base_ms.shape[0]
    down = (fleet.dyn.avail[:, 0] < 0.5).nonzero().flatten()
    check(down.numel() > 0, "fleet_scale: the fail window misses the run")
    first, last = int(down[0]), int(down[-1])
    probe_t = (first + last) // 2
    batch, jitter = generate(wl, torch.Generator().manual_seed(0),
                             device=dev, sched=sched)
    probe = {}

    def by_endpoint(state):
        live = state.req.status == INFLIGHT
        return torch.bincount(state.req.endpoint[live].long(), minlength=p)

    def on_tick(t, state, win):
        # device work only: the counts are read after the run
        if t == probe_t:
            probe["ep0"] = ((state.req.status == INFLIGHT)
                            & (state.req.endpoint == 0)).sum()
            probe["ep0_fleet"] = state.fleet.inflight[0].clone()
        if t == cfg.n_ticks - 1:
            probe["last"] = (state.fleet.inflight.clone(), by_endpoint(state))

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = run_sim(strategy("final_adrr_olc"), batch, jitter, phys, cfg,
                    fleet=fleet, device=dev, on_tick=on_tick)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.LAUNCHES["sched_score_topb"]
    check(launches == (k + 1) * cfg.n_ticks,
          f"fleet_scale: {launches} sched_score_topb launches, want "
          f"{(k + 1) * cfg.n_ticks}")
    requeued = final.fleet.n_requeued.cpu()
    check(int(requeued[0]) > 0 and int(requeued[1:].sum()) == 0,
          f"fleet_scale: requeues {requeued.tolist()}, want them on "
          f"endpoint 0 only")
    check(int(probe["ep0"]) == 0 and int(probe["ep0_fleet"]) == 0,
          f"fleet_scale: {int(probe['ep0'])} requests in flight on the "
          f"down endpoint 0 at tick {probe_t}")
    infl_last, recount_last = (x.cpu() for x in probe["last"])
    check(torch.equal(infl_last, recount_last.to(torch.int32)),
          f"fleet_scale: FleetState.inflight {infl_last.tolist()} against "
          f"a recount {recount_last.tolist()} on the last tick")
    check(torch.equal(final.fleet.inflight.cpu(),
                      by_endpoint(final).cpu().to(torch.int32)),
          "fleet_scale: FleetState.inflight differs from a recount after "
          "the drain")
    counts = torch.bincount(final.req.status.long(), minlength=5).tolist()
    check(counts[PENDING] == 0 and counts[INFLIGHT] == 0,
          f"fleet_scale: requests left live after the drain: {counts}")
    window_ms = ((first + 1) * cfg.dt_ms, cfg.n_ticks * cfg.dt_ms)
    fin = final.req.finish_ms
    in_window = ((final.req.status == COMPLETED) & (fin >= window_ms[0])
                 & (fin <= window_ms[1]))
    done_in_window = torch.bincount(final.req.endpoint[in_window].long(),
                                    minlength=p).cpu()
    check(bool((done_in_window[1:] > 0).all()),
          f"fleet_scale: completions inside the fail window by endpoint "
          f"{done_in_window.tolist()}")
    sent = torch.isfinite(final.req.submit_ms)
    emit(phase="fleet_scale", scenario="fleet_failover", n_requests=n,
         window=w, k_slots=b, classes=k, endpoints=p, n_ticks=cfg.n_ticks,
         arrival_scale=scale, seconds=secs, ticks_per_s=cfg.n_ticks / secs,
         sched_score_topb_launches=launches, fail_ticks=[first, last],
         probe_tick=probe_t, n_requeued=requeued.tolist(),
         completed_in_window_by_endpoint=done_in_window.tolist(),
         admitted_by_endpoint=torch.bincount(
             final.req.endpoint[sent].long(), minlength=p).tolist(),
         status_counts=counts,
         n_throttles=int(final.req.n_throttles.sum()))
    return launches


# ---------------------------------------------------------------------------
# 5f. the live client session, card against CPU and against the engine
# ---------------------------------------------------------------------------

# name -> (workload or scenario, seed, polls, window, arrival scale, N);
# the storm's polls are its arrival span plus SCENARIO_DRAIN_TICKS
SESSION_PARITY = {
    "balanced_s0": ("balanced", 0, 600, 64, 1.0, 48),
    "balanced_s1": ("balanced", 1, 600, 64, 1.0, 48),
    "storm": ("storm", 0, 1004, 256, 4.0, 160),
}
SESSION_FAULTS = ("silent_drop", "stuck_tail", "dup_storm")
# N, the horizon the arrivals and schedules are built over, the cap on
# polls (the reference's horizon for these gates; a run stops at drain)
RECOVERY = (32, 1600, 9000)
RECOVERY_RES = dict(timeout_mult=3.0, max_resubmits=3)
# the recovery run with a card process of its own (the longest: seed 0's
# xlong request waits out a ~70 s client deadline, ~3,800 polls); the
# other two share one
RECOVERY_APART = "stuck_tail"
# N, W, B, K, untraced polls, traced polls, sync-counted polls; and the
# small run of the N-independence ratio
SESSION_SCALE = (100_000, 4096, 16, 2, 300, 40, 20)
SESSION_SCALE_SMALL = 1000


def session_requests(torch, name, seed, n, n_ticks, scale):
    """The case's arrivals from the port's generator (on the CPU, so the
    card and CPU runs see one batch): `balanced`/medium stationary, or a
    registry scenario through `scenarios.build`.  Returns (batch,
    jitter, dynamics or None, requests)."""
    from repro_torch.client import Request
    from repro_torch.sim import WorkloadConfig, generate
    from repro_torch.sim.scenarios import build, get_scenario

    sched = dyn = None
    if name == "balanced":
        wl = WorkloadConfig(n_requests=n, mix="balanced", congestion="medium")
    else:
        wl, sched, dyn, _ = build(get_scenario(name), n, n_ticks, 25.0,
                                  limiter_classes=2, arrival_scale=scale)
    batch, jitter = generate(wl, torch.Generator().manual_seed(seed),
                             device="cpu", sched=sched)
    a = [x.numpy() for x in batch]
    j = jitter.numpy()
    reqs = [Request(rid=i, prompt=None, max_new=float(a[3][i]),
                    p50=float(a[4][i]), bucket=int(a[1][i]),
                    p90=float(a[5][i]), cls=int(a[2][i]),
                    arrival_s=float(a[0][i]) / 1e3, jitter=float(j[i]))
            for i in range(batch.n)]
    return batch, jitter, dyn, reqs


_STATUS = {"pending": 0, "inflight": 1, "completed": 2, "rejected": 3,
           "abandoned": 4}


def session_parity_run(torch, d, case, one_endpoint_fleet=False):
    """The port's `ClientSession` over `MockProvider` (`from_scenario`
    for a scenario) on `d`, `polls` virtual polls: the decision trace,
    each request's status, bounces and finish time at the horizon, and,
    on the card, `sched_score_topb` launches over the polls (counted
    from 0 after the session's warm-up) and device-stepped polls.  With
    `one_endpoint_fleet` the provider sits behind a `FleetProvider` of
    one endpoint (phase 5g)."""
    from repro_torch.client import (ClientSession, FleetProvider,
                                    MockProvider, SessionConfig)
    from repro_torch.core.policy import strategy
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim import FleetPhysics, default_physics
    from repro_torch.sim.scenarios import get_scenario

    name, seed, polls, window, scale, n = SESSION_PARITY[case]
    _, _, _, reqs = session_requests(torch, name, seed, n, polls, scale)
    phys = default_physics()
    prov = (MockProvider(phys, dt_ms=25.0) if name == "balanced" else
            MockProvider.from_scenario(get_scenario(name), n, polls, 25.0, 2,
                                       arrival_scale=scale))
    if one_endpoint_fleet:
        prov = FleetProvider([prov], FleetPhysics(*(a[None] for a in phys)))
    sess = ClientSession(prov, strategy("final_adrr_olc"),
                         SessionConfig(window=window, max_grants=4,
                                       dt_ms=25.0),
                         clock="virtual", phys=phys, device=d)
    prof = sess.enable_profiling()
    for r in reqs:
        sess.submit(r)
    ops.reset_launches()
    acts, rids, sevs = [], [], []
    for _ in range(polls):
        r = sess.poll()
        acts.append(r.actions)
        rids.append(r.req_rids)
        sevs.append(r.severity)
    launches = ops.LAUNCHES["sched_score_topb"]
    out = sess.requests()
    return dict(
        actions=np.stack(acts), rids=np.stack(rids),
        severity=np.asarray(sevs, np.float32),
        status=np.asarray([_STATUS[r.status] for r in out], np.int32),
        n_throttles=np.asarray([r.n_throttles for r in out], np.int32),
        finish=np.asarray([np.float32(r.finish_s * 1e3) for r in out],
                          np.float32),
        n_throttled=np.asarray(sess.stats.n_throttled),
        n_completed=np.asarray(sess.stats.n_completed),
        launches=np.asarray(launches), stepped=np.asarray(prof["polls"]))


def session_engine_run(torch, d, case):
    """The port's windowed `run_sim` on the same batch and provider
    schedules: its decision trace, and each request's status and bounces
    at the last tick (read in `on_tick`)."""
    from repro_torch.core.policy import strategy
    from repro_torch.sim import SimConfig, default_physics, run_sim

    name, seed, polls, window, scale, n = SESSION_PARITY[case]
    batch, jitter, dyn, _ = session_requests(torch, name, seed, n, polls,
                                             scale)
    last = {}

    def on_tick(t, state, win):
        if t == polls - 1:
            last["status"] = state.req.status.clone()
            last["n_throttles"] = state.req.n_throttles.clone()
            last["n_throttled"] = state.provider.n_throttled.clone()

    final, (actions, req_idx, severity) = run_sim(
        strategy("final_adrr_olc"), batch, jitter, default_physics(),
        SimConfig(n_ticks=polls, k_slots=4, window=window), dyn,
        collect_decisions=True, device=d, on_tick=on_tick)
    return dict(actions=actions, rids=req_idx, severity=severity,
                status=last["status"], n_throttles=last["n_throttles"],
                n_throttled=last["n_throttled"], finish=final.req.finish_ms)


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def same_session(what, a, b, ids_live):
    """Two runs' decision traces, severity bits, statuses and bounces at
    the horizon, and completions' finish bits (`a` a session's)."""
    check(np.array_equal(_np(a["actions"]), _np(b["actions"])),
          f"{what}: actions differ")
    live = ids_live
    check(np.array_equal(_np(a["rids"])[live], _np(b["rids"])[live]),
          f"{what}: the request of a live grant differs")
    check(np.array_equal(_np(a["severity"]).view(np.int32),
                         _np(b["severity"]).view(np.int32)),
          f"{what}: severity bits differ")
    check(np.array_equal(_np(a["status"]), _np(b["status"])),
          f"{what}: statuses at the horizon differ")
    check(np.array_equal(_np(a["n_throttles"]), _np(b["n_throttles"]))
          and int(_np(a["n_throttled"])) == int(_np(b["n_throttled"])),
          f"{what}: 429 bounces differ")
    done = _np(a["status"]) == 2
    check(np.array_equal(_np(a["finish"])[done].view(np.int32),
                         _np(b["finish"])[done].view(np.int32)),
          f"{what}: finish times of the completions differ")


def recovery_run(torch, d, name):
    """`name` from the registry at RECOVERY's size on `d`, with the
    watchdog (`RECOVERY_RES`), polled until every request is terminal
    (at most the cap): the figures the gates read, and on the card the
    `sched_score_topb` launches over the polls (counted from 0 after the
    session's warm-up)."""
    from repro_torch.client import (ClientSession, MockProvider,
                                    ResilienceConfig, SessionConfig)
    from repro_torch.core.policy import final_adrr_olc
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim.scenarios import get_scenario

    n, horizon, cap = RECOVERY
    _, _, _, reqs = session_requests(torch, name, 0, n, horizon, 1.0)
    prov = MockProvider.from_scenario(get_scenario(name), n, horizon, 25.0, 2)
    sess = ClientSession(prov, final_adrr_olc(), SessionConfig(),
                         clock="virtual",
                         resilience=ResilienceConfig(**RECOVERY_RES),
                         device=d)
    for r in reqs:
        sess.submit(r)
    ops.reset_launches()
    t0 = time.perf_counter()
    polls = 0
    while sess.unfinished and polls < cap:
        sess.poll()
        polls += 1
    secs = time.perf_counter() - t0
    out = sess.requests()
    st = sess.stats
    terminal = sum(r.status in ("completed", "abandoned", "rejected")
                   for r in out)
    return dict(
        polls=polls, seconds=secs, polls_per_s=polls / secs,
        launches=ops.LAUNCHES["sched_score_topb"],
        completion=sum(r.status == "completed" for r in out) / len(out),
        unfinished=sess.unfinished,
        double_retires=st.n_completed + st.n_abandoned + st.n_rejected
        - terminal,
        resubmitted=st.n_resubmitted, gave_up=st.n_gave_up,
        dup_discarded=st.n_dup_discarded, late_discarded=st.n_late_discarded,
        throttled=st.n_throttled, dropped=prov.n_dropped, stuck=prov.n_stuck,
        duped=prov.n_duped)


def check_recovery(name, r, k):
    """The reference's gates (`tests/test_faults.py`) on one run."""
    what = f"session_recovery {name}"
    check(r["dropped"] + r["stuck"] + r["duped"] > 0,
          f"{what}: no fault fired")
    check(r["completion"] >= 0.99 and r["unfinished"] == 0,
          f"{what}: completion {r['completion']}, {r['unfinished']} "
          f"unfinished after {r['polls']} polls")
    check(r["double_retires"] == 0,
          f"{what}: {r['double_retires']} double retires")
    if r["dropped"] + r["stuck"]:
        check(r["resubmitted"] > 0, f"{what}: the watchdog never resubmitted")
    if name == "dup_storm":
        check(r["dup_discarded"] > 0 and r["completion"] == 1.0,
              f"{what}: dup_discarded {r['dup_discarded']}, completion "
              f"{r['completion']}")
    check(r["launches"] == (k + 1) * r["polls"],
          f"{what}: {r['launches']} launches over {r['polls']} polls")


def scale_session(torch, dev, n, w, b):
    """`benchmarks/client_bench.py`'s throughput shape on the card: its
    policy (`adaptive_drr`, overload control off, caps and timeouts
    lifted) and fast physics (service far below a tick, so a poll's own
    cost is what is measured), N requests all arrived at t = 0."""
    from repro_torch.client import (ClientSession, MockProvider, Request,
                                    SessionConfig)
    from repro_torch.core.policy import strategy
    from repro_torch.sim import default_physics

    policy = strategy("adaptive_drr")._replace(
        timeout_mult=torch.full((4,), 1e9),
        class_cap=torch.full((2,), 1e9),
        max_inflight=torch.tensor(1e9))
    phys = default_physics(base_ms=1.0, ms_per_token=0.0,
                           comfort_concurrency=1e9)
    sess = ClientSession(MockProvider(phys, dt_ms=25.0), policy,
                         SessionConfig(window=w, max_grants=b, dt_ms=25.0),
                         clock="virtual", phys=phys, device=dev)
    for i in range(n):
        sess.submit(Request(rid=i, prompt=None, max_new=8.0, p50=8.0,
                            bucket=i % 4, arrival_s=0.0))
    return sess


def phase_session(torch, dev):
    """Phase 5f (module docstring)."""
    import warnings

    from repro_torch.kernels.sched_score import ops

    k = 2
    total = 0
    t_phase = time.perf_counter()
    cases = list(SESSION_PARITY)
    beside = [n for n in SESSION_FAULTS if n != RECOVERY_APART]
    # while this process runs the card's sessions, spawned processes run
    # the CPU's sessions, the card's engine runs, two recovery runs, and
    # the longest recovery run
    cpu = Spawned("cpu", [(session_parity_run, (c,)) for c in cases])
    engine = Spawned(dev.type, [(session_engine_run, (c,)) for c in cases])
    faults = Spawned(dev.type, [(recovery_run, (n,)) for n in beside])
    apart = Spawned(dev.type, [(recovery_run, (RECOVERY_APART,))])
    card = {}
    for c in cases:
        t0 = time.perf_counter()
        card[c] = session_parity_run(torch, dev.type, c)
        card[c]["seconds"] = time.perf_counter() - t0
    cpu_out = cpu.result()
    eng_out = engine.result()
    recov = {n: r for n, (r, _) in zip(beside, faults.result())}
    ((recov[RECOVERY_APART], _),) = apart.result()
    parity = {}
    for c, (cres, csecs), (eres, esecs) in zip(cases, cpu_out, eng_out):
        g = card[c]
        polls = SESSION_PARITY[c][2]
        live = _np(eres["actions"]) != -1
        check(int(live.sum()) > 10, f"session {c}: an idle trace")
        same_session(f"session {c}: card vs CPU", g, cres, live)
        same_session(f"session {c}: card session vs card run_sim", g, eres,
                     live)
        stepped, launches = int(g["stepped"]), int(g["launches"])
        check(launches == (k + 1) * stepped and stepped == polls,
              f"session {c}: {launches} sched_score_topb launches over "
              f"{stepped} device-stepped polls of {polls}, want "
              f"{k + 1} a poll")
        if c == "storm":
            check(int(g["n_throttled"]) > 0,
                  f"session {c}: the limiter never bounced")
        total += launches
        parity[c] = dict(
            polls=polls, card_seconds=g["seconds"], cpu_seconds=csecs,
            card_engine_seconds=esecs,
            card_polls_per_s=polls / g["seconds"],
            launches=launches, launches_per_poll=launches / polls,
            completed=int(g["n_completed"]), n_throttled=int(g["n_throttled"]),
            status_counts=np.bincount(g["status"], minlength=5).tolist())
    emit(phase="session_parity", equal_to_cpu=True,
         equal_to_card_run_sim=True, cases=parity)
    for name in SESSION_FAULTS:
        r = {key: (v.item() if isinstance(v, np.ndarray) else v)
             for key, v in recov[name].items()}
        recov[name] = r
        check_recovery(name, r, k)
        total += int(r["launches"])
    emit(phase="session_recovery", n_requests=RECOVERY[0],
         horizon_ticks=RECOVERY[1], cap_polls=RECOVERY[2], **RECOVERY_RES,
         own_process=RECOVERY_APART, other_process=beside,
         runs={n: recov[n] for n in SESSION_FAULTS},
         seconds_parity_and_recovery=time.perf_counter() - t_phase)

    n, w, b, k, n_untraced, n_traced, n_sync = SESSION_SCALE
    t_build = time.perf_counter()
    sess = scale_session(torch, dev, n, w, b)
    build_s = time.perf_counter() - t_build
    ops.reset_launches()
    prof = sess.enable_profiling()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_untraced):
        sess.poll()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    done_untraced = sess.stats.n_completed
    breakdown = {kk: v / prof["polls"] * 1e3 for kk, v in prof.items()
                 if kk != "polls"}
    tp = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    tp.start()
    t1 = time.perf_counter()
    for _ in range(n_traced):
        sess.poll()
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t1
    tp.stop()
    busy_us, n_ops, per_name = device_activity(torch, tp)
    check(n_ops > 0, "session_scale: the trace shows no device work")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(n_sync):
                sess.poll()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(x.message) for x in caught)
    launches = ops.LAUNCHES["sched_score_topb"]
    polls = n_untraced + n_traced + n_sync
    check(launches == (k + 1) * prof["polls"] and prof["polls"] == polls,
          f"session_scale: {launches} launches over {prof['polls']} "
          f"device-stepped polls of {polls}")
    check(sess.stats.n_completed > 0, "session_scale: nothing completed")
    total += launches
    wall_ms = traced_s * 1e3 / n_traced
    busy_ms = busy_us / 1e3 / n_traced
    rate_big = done_untraced / secs
    small = scale_session(torch, dev, SESSION_SCALE_SMALL, w, b)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    small.drain(max_polls=20 * (SESSION_SCALE_SMALL // b + 50))
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t2
    check(small.stats.n_completed == SESSION_SCALE_SMALL,
          f"session_scale: the N = {SESSION_SCALE_SMALL} run completed "
          f"{small.stats.n_completed}")
    rate_small = SESSION_SCALE_SMALL / small_s
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    emit(phase="session_scale", n_requests=n, window=w, max_grants=b,
         classes=k, submit_seconds=build_s, untraced_polls=n_untraced,
         untraced_seconds=secs, polls_per_s=n_untraced / secs,
         completed_untraced=done_untraced,
         completed=sess.stats.n_completed,
         breakdown_ms_per_poll=breakdown,
         traced_polls=n_traced, traced_wall_ms_per_poll=wall_ms,
         traced_device_busy_ms_per_poll=busy_ms,
         traced_device_idle_share=1.0 - busy_ms / wall_ms,
         traced_device_ops_per_poll=n_ops / n_traced,
         traced_top_device_us_per_poll=[[nm[:60], us / n_traced]
                                        for nm, us in top],
         sync_counted_polls=n_sync, syncs_per_poll=syncs / n_sync,
         sched_score_topb_launches=launches,
         small_n=SESSION_SCALE_SMALL, small_polls=small.stats.n_polls,
         small_seconds=small_s,
         per_request_rate=rate_big, small_per_request_rate=rate_small,
         rate_ratio_big_over_small=rate_big / rate_small,
         phase_seconds=time.perf_counter() - t_phase)
    return total


# ---------------------------------------------------------------------------
# 5g. the live fleet: a session over FleetProvider, card against CPU
# ---------------------------------------------------------------------------

# the fleet sessions' cells: 5d's size (N = 160 at 4x, W = 256, B = 4,
# the arrival span plus SCENARIO_DRAIN_TICKS polls); the P = 1 case is
# 5f's first
FLEET_SESSIONS = ("fleet_failover", "fleet_skew")
FLEET_SESSION_N, FLEET_SESSION_RATE = 160, 4.0
FLEET_SESSION_P1 = "balanced_s0"


def fleet_session_run(torch, d, name):
    """The port's `ClientSession` in virtual time over
    `FleetProvider.from_fleet_scenario(name)` on `d`: the decision trace,
    each request's status, bounces and finish time at the horizon, the
    adapter's `n_routed` after every poll, endpoint 0's outstanding count
    and whether it was down at every poll, `n_refused`, and on the card
    the `sched_score_topb` launches over the polls and device-stepped
    polls."""
    from repro_torch.client import ClientSession, FleetProvider, SessionConfig
    from repro_torch.core.policy import strategy
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim.scenarios import get_scenario

    n, scale = FLEET_SESSION_N, FLEET_SESSION_RATE
    sc = get_scenario(name)
    polls = scenario_cfg(sc, n, scale).n_ticks
    _, _, _, reqs = session_requests(torch, name, 0, n, polls, scale)
    fp = FleetProvider.from_fleet_scenario(sc, n, polls, 25.0, 2,
                                           arrival_scale=scale)
    sess = ClientSession(fp, strategy("final_adrr_olc"),
                         SessionConfig(window=256, max_grants=4, dt_ms=25.0),
                         clock="virtual", device=d)
    prof = sess.enable_profiling()
    for r in reqs:
        sess.submit(r)
    ops.reset_launches()
    acts, rids, sevs, routed, ep0, down = [], [], [], [], [], []
    for _ in range(polls):
        r = sess.poll()
        acts.append(r.actions)
        rids.append(r.req_rids)
        sevs.append(r.severity)
        routed.append(fp.n_routed.copy())
        ep0.append(fp.inflight_by_endpoint()[0])
        row = fp._avail_row(r.now_ms)
        down.append(row is not None and row[0] < 0.5)
    launches = ops.LAUNCHES["sched_score_topb"]
    out = sess.requests()
    return dict(
        actions=np.stack(acts), rids=np.stack(rids),
        severity=np.asarray(sevs, np.float32),
        status=np.asarray([_STATUS[r.status] for r in out], np.int32),
        n_throttles=np.asarray([r.n_throttles for r in out], np.int32),
        finish=np.asarray([np.float32(r.finish_s * 1e3) for r in out],
                          np.float32),
        n_throttled=np.asarray(sess.stats.n_throttled),
        n_completed=np.asarray(sess.stats.n_completed),
        routed=np.stack(routed), ep0_inflight=np.asarray(ep0),
        ep0_down=np.asarray(down), n_refused=np.asarray(fp.n_refused),
        launches=np.asarray(launches), stepped=np.asarray(prof["polls"]),
        polls=np.asarray(polls))


def phase_fleet_session(torch, dev):
    """Phase 5g (module docstring)."""
    k = 2
    total = 0
    t_phase = time.perf_counter()
    # while this process runs the first fleet session and the P = 1
    # fleet on the card, spawned processes run the CPU's fleet sessions,
    # the card's second fleet session and the P = 1 case's engine run,
    # and the P = 1 case's bare session on the card
    here, rest = FLEET_SESSIONS[0], FLEET_SESSIONS[1:]
    cpu = Spawned("cpu", [(fleet_session_run, (nm,))
                          for nm in FLEET_SESSIONS])
    side = Spawned(dev.type, [(fleet_session_run, (nm,)) for nm in rest]
                   + [(session_engine_run, (FLEET_SESSION_P1,))])
    apart = Spawned(dev.type, [(session_parity_run, (FLEET_SESSION_P1,))])
    t0 = time.perf_counter()
    card = {here: fleet_session_run(torch, dev.type, here)}
    card[here]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = session_parity_run(torch, dev.type, FLEET_SESSION_P1,
                             one_endpoint_fleet=True)
    one_s = time.perf_counter() - t0
    cpu_out = cpu.result()
    side_out = side.result()
    for nm, (g, secs) in zip(rest, side_out):
        card[nm] = dict(g, seconds=secs)
    ((eng, _),) = side_out[len(rest):]
    ((bare, _),) = apart.result()
    cells = {}
    for nm, (c, csecs) in zip(FLEET_SESSIONS, cpu_out):
        g = card[nm]
        polls = int(g["polls"])
        live = g["actions"] != -1
        check(int(live.sum()) > 10, f"fleet_session {nm}: an idle trace")
        same_session(f"fleet_session {nm}: card vs CPU", g, c, live)
        check(np.array_equal(g["routed"], _np(c["routed"]))
              and int(g["n_refused"]) == int(_np(c["n_refused"])),
              f"fleet_session {nm}: n_routed or n_refused differ between "
              f"card and CPU")
        stepped, launches = int(g["stepped"]), int(g["launches"])
        check(launches == (k + 1) * stepped and stepped == polls,
              f"fleet_session {nm}: {launches} sched_score_topb launches "
              f"over {stepped} device-stepped polls of {polls}")
        routed = g["routed"]
        row = dict(polls=polls, card_seconds=g["seconds"],
                   cpu_seconds=csecs, card_polls_per_s=polls / g["seconds"],
                   launches=launches, n_routed=routed[-1].tolist(),
                   n_refused=int(g["n_refused"]),
                   completed=int(g["n_completed"]),
                   status_counts=np.bincount(g["status"],
                                             minlength=5).tolist())
        if nm == "fleet_failover":
            down = np.nonzero(g["ep0_down"])[0]
            check(down.size > 0, f"fleet_session {nm}: the fail window "
                  f"misses the run")
            first, last = int(down[0]), int(down[-1])
            r0 = routed[:, 0]
            check(r0[last] == r0[first - 1] > 0,
                  f"fleet_session {nm}: n_routed[0] went from "
                  f"{r0[first - 1]} to {r0[last]} inside the fail window "
                  f"(polls {first}-{last})")
            ep0 = g["ep0_inflight"]
            check(ep0[first - 1] > 0 and ep0[last] == 0,
                  f"fleet_session {nm}: endpoint 0 held {ep0[first - 1]} "
                  f"at the window's start and {ep0[last]} at its end")
            check(r0[-1] > r0[last], f"fleet_session {nm}: endpoint 0 took "
                  f"nothing after its window")
            row.update(fail_polls=[first, last],
                       ep0_inflight_at_fail=int(ep0[first - 1]),
                       ep0_routed_in_window=int(r0[last] - r0[first - 1]))
        if nm == "fleet_skew":
            check(int(np.argmax(routed[-1])) == 0,
                  f"fleet_session {nm}: n_routed {routed[-1].tolist()}, "
                  f"want the most on endpoint 0 (speed 0.5)")
        total += launches
        cells[nm] = row
    live = _np(eng["actions"]) != -1
    check(int(live.sum()) > 10, "fleet_session P = 1: an idle trace")
    same_session("fleet_session P = 1: fleet vs bare child", one, bare, live)
    same_session("fleet_session P = 1: fleet vs card run_sim", one, eng,
                 live)
    for r in (one, bare):
        check(int(r["launches"]) == (k + 1) * int(r["stepped"]),
              f"fleet_session P = 1: {int(r['launches'])} launches over "
              f"{int(r['stepped'])} polls")
        total += int(r["launches"])
    emit(phase="fleet_session", n_requests=FLEET_SESSION_N,
         arrival_scale=FLEET_SESSION_RATE, window=256, max_grants=4,
         endpoints=4, equal_to_cpu=True, cells=cells,
         p1=dict(case=FLEET_SESSION_P1, polls=SESSION_PARITY[
             FLEET_SESSION_P1][2], equal_to_bare_child=True,
             equal_to_card_run_sim=True, card_seconds=one_s,
             completed=int(one["n_completed"])),
         sched_score_topb_launches=total,
         phase_seconds=time.perf_counter() - t_phase)
    return total


# the fleet session at scale: N, W, B, K, timed polls, sync-counted polls;
# the endpoints' schedules are `fleet_failover`'s at N = 160 and
# FLEET_SESSION_SCALE_RATE, so the fail window (polls 141-261) lies
# inside the timed polls
FLEET_SESSION_SCALE = (100_000, 4096, 16, 2, 300, 20)
FLEET_SESSION_SCALE_RATE = 8.0


def phase_fleet_session_scale(torch, dev):
    """5g's scale run: a session over `fleet_failover`'s four endpoints
    (fast physics, comfort 4, so that routing spreads) at W = 4096,
    B = 16, N requests arrived at t = 0, under `scale_session`'s policy;
    untraced."""
    import warnings

    from repro_torch.client import (ClientSession, FleetProvider, Request,
                                    SessionConfig)
    from repro_torch.core.policy import strategy
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim import default_physics
    from repro_torch.sim.scenarios import get_scenario

    n, w, b, k, n_timed, n_sync = FLEET_SESSION_SCALE
    t_phase = time.perf_counter()
    policy = strategy("adaptive_drr")._replace(
        timeout_mult=torch.full((4,), 1e9),
        class_cap=torch.full((2,), 1e9),
        max_inflight=torch.tensor(1e9))
    phys = default_physics(base_ms=1.0, ms_per_token=0.0)
    polls = n_timed + n_sync
    fp = FleetProvider.from_fleet_scenario(
        get_scenario("fleet_failover"), FLEET_SESSION_N, polls, 25.0, k,
        phys=phys, arrival_scale=FLEET_SESSION_SCALE_RATE)
    sess = ClientSession(fp, policy,
                         SessionConfig(window=w, max_grants=b, dt_ms=25.0),
                         clock="virtual", phys=phys, device=dev)
    t0 = time.perf_counter()
    for i in range(n):
        sess.submit(Request(rid=i, prompt=None, max_new=8.0, p50=8.0,
                            bucket=i % 4, arrival_s=0.0))
    submit_s = time.perf_counter() - t0
    ops.reset_launches()
    prof = sess.enable_profiling()
    routed0, down = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        r = sess.poll()
        routed0.append(int(fp.n_routed[0]))
        row = fp._avail_row(r.now_ms)
        down.append(bool(row[0] < 0.5))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    breakdown = {kk: v / prof["polls"] * 1e3 for kk, v in prof.items()
                 if kk != "polls"}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(n_sync):
                sess.poll()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(x.message) for x in caught)
    launches = ops.LAUNCHES["sched_score_topb"]
    check(launches == (k + 1) * prof["polls"] and prof["polls"] == polls,
          f"fleet_session_scale: {launches} launches over {prof['polls']} "
          f"device-stepped polls of {polls}")
    idx = np.nonzero(down)[0]
    check(idx.size > 0, "fleet_session_scale: the fail window misses the "
          "timed polls")
    first, last = int(idx[0]), int(idx[-1])
    check(routed0[last] == routed0[first - 1],
          f"fleet_session_scale: n_routed[0] went from {routed0[first - 1]} "
          f"to {routed0[last]} inside the fail window")
    check(bool((fp.n_routed > 0).all()) and sess.stats.n_completed > 0,
          f"fleet_session_scale: n_routed {fp.n_routed.tolist()}, "
          f"{sess.stats.n_completed} completed")
    emit(phase="fleet_session_scale", scenario="fleet_failover",
         n_requests=n, window=w, max_grants=b, classes=k, endpoints=fp.p,
         submit_seconds=submit_s, timed_polls=n_timed, timed_seconds=secs,
         polls_per_s=n_timed / secs, breakdown_ms_per_poll=breakdown,
         fail_polls=[first, last], n_routed=fp.n_routed.tolist(),
         n_refused=fp.n_refused, completed=sess.stats.n_completed,
         sync_counted_polls=n_sync, syncs_per_poll=syncs / n_sync,
         sched_score_topb_launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# 6. the attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_TOL = {"bfloat16": 3e-2, "float32": 3e-5}   # atol = rtol, as the CPU tests
# flash_attention's bf16 body against its rounding's emulation
# (`flash_attention_mma_ref`): both round the output to bf16 from float32
# values that differ only in the order of float32 sums and the
# exponential, so they lie one bf16 ulp apart (rtol 2^-7 covers one ulp
# at any magnitude; atol covers outputs near 0), except where the card's
# ex2.approx moves a weight across a bf16 rounding boundary: the
# emulation's `slack` adds, per element, one bf16 ulp of each such weight
# times |v| over the row sum (a row of few keys with a dominant weight
# moved 4 ulps of its output at Qwen1.5's geometry)
MMA_TOL = dict(atol=1e-3, rtol=2.0 ** -7)
# decode_attention's bf16 body against the plain version: both compute
# in float32 (TF32 off) and round once to bf16, so they lie one bf16
# ulp apart at most; atol covers outputs near 0
DECODE_TOL = dict(atol=1e-4, rtol=2.0 ** -7)
FA_SRC = "src/repro_torch/kernels/flash_attention/flash_attention.cu"
DA_SRC = "src/repro_torch/kernels/decode_attention/decode_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:78"
DA_REPLACES = "src/repro/kernels/decode_attention/decode_attention.py:66"
# (H, KV, hd) of each geometry: StableLM-2-1.6B, StarCoder2-3B,
# Hymba-1.5B's attention heads, a small hd = 32 one, multi-query
# attention with more query heads a KV head (32) than a decode CTA
# serves (16), and the rest of the model zoo: Arctic (G = 7, run in a
# decode CTA of 8), Phi-3.5-MoE, Qwen1.5-32B (MHA), Nemotron-4-340B (hd
# 192, G = 12), InternVL2-1B (G = 7) and MusicGen-large
ATTN_GEOMETRY = {"stablelm": (32, 32, 64), "starcoder2": (24, 2, 128),
                 "hymba": (25, 5, 64), "hd32": (8, 2, 32),
                 "mqa": (32, 1, 64), "arctic": (56, 8, 128),
                 "phi35moe": (32, 8, 128), "qwen15": (40, 40, 128),
                 "nemotron": (96, 8, 192), "internvl2": (14, 2, 64),
                 "musicgen": (32, 32, 64)}
# the kernels line carries the serve run's shapes: a 1024-token prompt,
# and a decode step halfway through the 2048-slot cache
FA_LINE = ("stablelm", 1, 1024, 1024, 0)
DA_LINE = ("stablelm", 2048, 1024)
# flash: (geometry, B, Sq, Skv, window, dtype); every path of the bf16
# body: the serve runs' prompts, their B = 4 batch, fewer queries than
# keys, hd 32, 64 and 128, windows that bite and Hymba's prefill past
# its window
FLASH_CASES = ([("stablelm", 1, s, s, 0, "bfloat16")
                for s in (1, 37, 512, 1024, 2048)]
               + [("stablelm", 4, 256, 256, 0, "bfloat16"),
                  ("stablelm", 1, 37, 100, 0, "bfloat16"),
                  ("hd32", 1, 130, 130, 50, "bfloat16"),
                  ("hymba", 1, 1536, 1536, 1024, "bfloat16"),
                  ("starcoder2", 1, 2048, 2048, 64, "bfloat16"),
                  ("starcoder2", 1, 2048, 2048, 4096, "bfloat16"),
                  ("starcoder2", 1, 5000, 5000, 4096, "bfloat16"),
                  ("stablelm", 1, 512, 512, 0, "float32"),
                  ("starcoder2", 1, 700, 700, 64, "float32"),
                  ("hd32", 1, 130, 130, 50, "float32")]
               # the zoo's serve_zoo prompts: 512 tokens, the batch of 4 x
               # 256, and the prefixed models' 256 + 512 and 64 + 512
               + [(g, 1, 512, 512, 0, dt)
                  for g in ("arctic", "phi35moe", "qwen15", "nemotron")
                  for dt in ("bfloat16", "float32")]
               + [("nemotron", 1, 37, 37, 0, "bfloat16"),
                  ("nemotron", 4, 256, 256, 0, "bfloat16"),
                  ("nemotron", 1, 37, 100, 0, "float32"),
                  ("internvl2", 1, 768, 768, 0, "bfloat16"),
                  ("internvl2", 1, 768, 768, 0, "float32"),
                  ("musicgen", 1, 576, 576, 0, "bfloat16"),
                  ("musicgen", 1, 576, 576, 0, "float32")])
# device ms of this kernel's earlier bf16 body, which converted its
# inputs to float32 and ran both products on the CUDA cores (PERF.md
# section 6, H100 80GB HBM3, 700 W), printed beside the present times
FLASH_CUDA_CORE_MS = {("stablelm", 1, 1, 1, 0): 0.0135,
                      ("stablelm", 1, 37, 37, 0): 0.0163,
                      ("stablelm", 1, 512, 512, 0): 0.0990,
                      ("stablelm", 1, 1024, 1024, 0): 0.26371,
                      ("stablelm", 1, 2048, 2048, 0): 0.8556,
                      ("starcoder2", 1, 2048, 2048, 64): 0.2040,
                      ("starcoder2", 1, 2048, 2048, 4096): 1.5507}
# decode: (geometry, B, S, valid prefix length, "ring" or "last", dtype);
# "last": a ring cache holding one live slot, the last (S = 2048 makes it
# the last key of a 32-key tile, the one the kernel's any-valid test of
# a tile reads last); Hymba's cases as its serve run meets them: the
# local ring cache past its window, the global cache of the 1536-token
# prompt mid-decode, and the batch of 4 x 256 tokens; float32 at
# StableLM's batch of 4 (10 live tiles in a split, so the 3-stage ring
# refills its stages many times) and Hymba's (8 heads a CTA) holds those
# paths within ATTN_TOL's 3e-5
DECODE_CASES = ([("stablelm", 1, s, n, "bfloat16")
                 for s in (128, 1000, 2048) for n in (1, s // 2, s)]
                + [("stablelm", 4, 2048, 300, "bfloat16"),
                   ("stablelm", 1, 2048, "last", "bfloat16"),
                   ("starcoder2", 1, 64, 64, "bfloat16"),
                   ("starcoder2", 1, 4096, 4096, "bfloat16"),
                   ("starcoder2", 1, 4096, "ring", "bfloat16"),
                   ("hymba", 1, 1024, 1024, "bfloat16"),
                   ("hymba", 1, 2048, 1544, "bfloat16"),
                   ("hymba", 4, 2048, 272, "bfloat16"),
                   ("stablelm", 1, 2048, 1024, "float32"),
                   ("stablelm", 4, 2048, 300, "float32"),
                   ("starcoder2", 2, 1000, 999, "float32"),
                   ("hymba", 4, 2048, 272, "float32"),
                   ("mqa", 2, 1000, 999, "float32")]
                # the zoo: serve_zoo's 1024-slot caches after a 512-token
                # prompt (and its prefix), the batch of 4 x 256 and a ring
                # mid-wrap at hd 192
                + [(g, 1, 1024, 529, dt)
                   for g in ("arctic", "phi35moe", "qwen15", "nemotron")
                   for dt in ("bfloat16", "float32")]
                + [("nemotron", 4, 1024, 272, "bfloat16"),
                   ("nemotron", 4, 1024, 272, "float32"),
                   ("nemotron", 1, 1024, "ring", "bfloat16"),
                   ("internvl2", 1, 1024, 785, "bfloat16"),
                   ("internvl2", 1, 1024, 785, "float32"),
                   ("musicgen", 1, 1024, 593, "bfloat16"),
                   ("musicgen", 1, 1024, 593, "float32")])


def decode_valid(torch, S, n, dev):
    """The (S,) bool mask of a DECODE_CASES row."""
    j = torch.arange(S, device=dev)
    if n == "ring":   # a ring cache mid-wrap: every third slot stale
        return (j % 3) != 1
    if n == "last":
        return j == S - 1
    return j < n


def attn_close(torch, got, want, dtype):
    """Max abs error, and whether |got - want| <= tol * (1 + |want|)."""
    tol = ATTN_TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= tol + tol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    return float(err.max()), ok


def mma_close(torch, got, want, tol=MMA_TOL, slack=None):
    """Max abs error, the largest share of `tol` (MMA_TOL or DECODE_TOL,
    plus `slack`, the emulation's per-element allowance for weights that
    the card's ex2.approx rounds to bf16 the other way) that it uses, and
    whether |got - want| <= atol + rtol * |want| (+ slack) everywhere."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    if slack is not None:
        lim = lim + slack
    share = err / lim
    ok = bool((share <= 1).all()) and bool(torch.isfinite(g).all())
    return float(err.max()), float(share.max()), ok


def flash_pairs(S, window):
    """Valid (query, key) pairs of causal attention over S query
    positions (keys past the last query are never valid)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_work(B, Sq, Skv, H, KV, hd, window, elt=2):
    """Bytes (q read once, the output written once, k and v read once
    over the keys a stored row can attend to: the first min(Sq, Skv))
    and operations (4 hd a valid pair and head) of one flash_attention
    call."""
    n_keys = min(Sq, Skv)
    n_bytes = 2 * B * Sq * H * hd * elt + 2 * B * n_keys * KV * hd * elt
    return n_bytes, 4 * hd * H * B * flash_pairs(Sq, window)


def decode_work(B, S, H, KV, hd, n_valid, elt=2):
    """Bytes (q read once, the output written once, k and v read once
    over the valid slots, the mask once) and operations (4 hd a valid
    key and head) of one decode_attention call."""
    n_bytes = 2 * B * H * hd * elt + 2 * B * n_valid * KV * hd * elt + S
    return n_bytes, 4 * B * H * hd * n_valid


def sdpa_flash(torch, q, k, v, window):
    """`scaled_dot_product_attention` computing what flash_attention
    does, on (B, S, H, hd) tensors: is_causal (whose diagonal starts at
    key 0 for Sq < Skv too) where no window bites, else the band as a
    mask; the yardstick, never called by the port."""
    import torch.nn.functional as F

    Sq, Skv, H, KV = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not 0 < window < Sq:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=KV != H)
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)


def phase_attention_kernels(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    gen = torch.Generator(device=dev).manual_seed(4321)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dts[dtype])

    rows, err = [], {"flash_attention": 0.0, "decode_attention": 0.0}
    line = {}

    def record(name, case, got, want, dtype, **timing):
        e, ok = attn_close(torch, got, want, dtype)
        check(ok, f"{name} {case}: differs from its plain version "
                  f"(max abs err {e})")
        err[name] = max(err[name], e)
        row = dict(name=name, **case, max_abs_err=e, **timing)
        rows.append(row)
        return row

    before = []
    for g, B, Sq, Skv, window, dtype in FLASH_CASES:
        H, KV, hd = ATTN_GEOMETRY[g]
        q = rand((B, Sq, H, hd), dtype)
        k, v = rand((B, Skv, KV, hd), dtype), rand((B, Skv, KV, hd), dtype)
        case = dict(geometry=g, B=B, Sq=Sq, Skv=Skv, H=H, KV=KV, hd=hd,
                    window=window, dtype=dtype)
        got = fa.flash_attention(q, k, v, window=window)
        want = fa_ref.flash_attention_ref(q, k, v, window=window)
        bf16 = dtype == "bfloat16"
        timing = {}
        if bf16:
            mma, mma_slack = fa_ref.flash_attention_mma_ref(
                q, k, v, window=window)
            e, share, ok = mma_close(torch, got, mma, slack=mma_slack)
            check(ok, f"flash_attention {case}: differs from its bf16 "
                      f"rounding's emulation (max abs err {e}, {share} of "
                      f"the tolerance)")
            timing = dict(mma_max_abs_err=e, mma_tolerance_share=share)
        # the bound of the body's route: bf16 tensor cores, float32
        # CUDA cores
        t_b, by = bound(*flash_work(B, Sq, Skv, H, KV, hd, window,
                                    q.element_size()),
                        PEAK_BF16_OPS_PER_S if bf16
                        else PEAK_F32_OPS_PER_S)
        lib = sdpa_flash(torch, q, k, v, window)
        lib_err = float((lib().transpose(1, 2).float()
                         - want.float()).abs().max())
        timing.update(
            ms=device_ms(torch, lambda: fa.flash_attention(
                q, k, v, window=window)),
            plain_ms=device_ms(torch, lambda: fa_ref.flash_attention_ref(
                q, k, v, window=window), reps=10),
            library_ms=device_ms(torch, lib), library_max_abs_err=lib_err,
            bound_ms=t_b, bound_by=by)
        row = record("flash_attention", case, got, want, dtype, **timing)
        key = (g, B, Sq, Skv, window)
        if bf16:
            before.append(dict(case, ms=row["ms"], cuda_core_ms=(
                FLASH_CUDA_CORE_MS.get(key, "not measured"))))
        if key == FA_LINE and bf16:
            line["flash_attention"] = row

    for g, B, S, n, dtype in DECODE_CASES:
        H, KV, hd = ATTN_GEOMETRY[g]
        q = rand((B, H, hd), dtype)
        k, v = rand((B, S, KV, hd), dtype), rand((B, S, KV, hd), dtype)
        valid = decode_valid(torch, S, n, dev)
        n_valid = int(valid.sum())
        case = dict(geometry=g, B=B, S=S, H=H, KV=KV, hd=hd,
                    n_valid=n_valid, dtype=dtype)
        got = da.decode_attention(q, k, v, valid)
        want = da_ref.decode_attention_ref(q, k, v, valid)
        bf16 = dtype == "bfloat16"
        timing = {}
        if bf16:
            e, share, ok = mma_close(torch, got, want, DECODE_TOL)
            check(ok, f"decode_attention {case}: more than one bf16 ulp "
                      f"from its plain version (max abs err {e}, {share} "
                      f"of DECODE_TOL)")
            timing = dict(decode_tolerance_share=share)
        if n_valid > 0:   # a cache with no valid key: SDPA gives NaN
            t_b, by = bound(*decode_work(B, S, H, KV, hd, n_valid,
                                         q.element_size()),
                            PEAK_BF16_OPS_PER_S if bf16
                            else PEAK_F32_OPS_PER_S)
            qt = q[:, :, None, :]
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            mask = valid[None, None, None, :]

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)
            lib_err = float((lib()[:, :, 0].float()
                             - want.float()).abs().max())
            timing.update(
                ms=device_ms(torch, lambda: da.decode_attention(
                    q, k, v, valid)),
                plain_ms=device_ms(torch, lambda: da_ref.decode_attention_ref(
                    q, k, v, valid), reps=20),
                library_ms=device_ms(torch, lib), library_max_abs_err=lib_err,
                bound_ms=t_b, bound_by=by)
        row = record("decode_attention", case, got, want, dtype, **timing)
        if (g, S, n, B) == (*DA_LINE, 1) and bf16:
            line["decode_attention"] = row
    torch.cuda.synchronize()
    for row in rows:
        emit(phase="attention_kernel", **row)
    for row in before:
        emit(phase="flash_attention_vs_cuda_core", **row)
    emit(phase="attention_kernels", cases=len(rows),
         max_abs_err=err, tolerance=ATTN_TOL, mma_tolerance=MMA_TOL,
         decode_tolerance=DECODE_TOL)
    out = {}
    for name, src, rep in (("flash_attention", FA_SRC, FA_REPLACES),
                           ("decode_attention", DA_SRC, DA_REPLACES)):
        row = line[name]
        out[name] = dict(
            name=name, route="cuda", source=src, replaces=rep, launches=0,
            max_abs_err=err[name], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"])
    return out


# ---------------------------------------------------------------------------
# 7. the serving path at full width
# ---------------------------------------------------------------------------

SERVE_ARCH = "stablelm-1.6b"
SERVE_PROMPTS = (8, 37, 128, 300, 512, 1024)   # tokens, one request each
# new tokens of each, few for the script's time limit
SERVE_MAX_NEW = (8, 8, 8, 16, 8, 16)
SERVE_BATCH = (4, 256, 16)                      # B, prompt tokens, max_new
# kernels against plain versions inside the full-width model.  In float32
# the two differ only in the order of the kernels' sums (1e-6 on their
# outputs), so logits of order 1 must agree within 1e-3.  In bf16 each
# one-ulp difference of a kernel's output is carried on through the
# later layers' bf16 roundings, so the two paths differ by bf16 rounding
# noise.  The bounds there rest on the run's own noise floor f, the
# largest gap between the plain bf16 logits and float32 arithmetic on
# the same weights.  The kernels' bf16 logits must lie within 2 f of the
# plain bf16 logits (as two bf16 paths that each sit within f of float32
# would), and within SERVE_BF16_F32_RATIO * f of float32: as close to
# float32 as the plain bf16 path, up to that ratio.  On an H100 the
# ratio read 1.084 (prefill) and 1.147 (decode) for StableLM, the
# largest over the run's seven prompts (PERF.md section 6); it is held
# at 1.5 for every served model.
SERVE_F32_TOL = 1e-3
SERVE_BF16_F32_RATIO = 1.5
# room the float32 runs' activations need beside a float32 copy of the
# weights (twice their bf16 bytes)
F32_HEADROOM = 4_000_000_000
# MoE routing flips (see serve_model): the bf16 router can flip a
# token's experts on a one-ulp difference upstream, so the kernel path's
# flips against the plain path are held against a yardstick of the same
# run, the plain path with every nonzero element of its attention
# outputs moved one bf16 ulp up or down at random (seeded): a
# difference of the size that a sound kernel's rounding makes.  The
# kernels' flips may be at most MOE_FLIP_RATIO times the yardstick's; in
# float32 there must be none.
MOE_FLIP_RATIO = 2
SERVED_KERNELS = ("flash_attention", "decode_attention", "ssd_intra")


def serve_requests(rng, vocab, prompts, max_news=None):
    """One (prompt tokens, max_new) per prompt length.  Without
    `max_news`, max_new is drawn from the paper's length buckets scaled
    down 64x as the reference's launcher scales them, held between 8
    and 64 tokens."""
    from repro_torch.sim.workload import BUCKET_TOKENS

    buckets = [0, 1, 2, 3, 2, 3]
    out = []
    for i, S in enumerate(prompts):
        if max_news is None:
            lo, hi = BUCKET_TOKENS[buckets[i]].tolist()
            max_new = int(np.clip(int(rng.uniform(lo, hi) / 64), 8, 64))
        else:
            max_new = max_news[i]
        out.append((rng.integers(0, vocab, size=S, dtype=np.int32), max_new))
    return out


def launch_counters():
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd

    return {"flash_attention": fa, "decode_attention": da, "ssd_intra": ssd}


def one_ulp_off(torch, x, gen):
    """x (bf16) with each nonzero element moved one ulp up or down at
    random (drawn from `gen`): the MoE routing flips' yardstick."""
    check(x.dtype == torch.bfloat16, f"one_ulp_off: {x.dtype}")
    step = torch.randint(0, 2, x.shape, generator=gen, device=x.device,
                         dtype=torch.int16) * 2 - 1
    return torch.where(x == 0, x,
                       (x.view(torch.int16) + step).view(torch.bfloat16))


def serve_model(torch, dev, kernels, *, phase, arch, max_seq, requests, rng,
                batch_shape, per_prompt, per_step, trace_request, f32_copy,
                keep=None, n_layers=None):
    """Build `arch` at full width in bf16 from a seeded CUDA generator
    (`n_layers` of its layers when given: a cut of depth only), answer
    `requests` through `BlackBoxProvider.submit` (through `generate` with
    seeded prefix embeddings, for an arch with a modality prefix) and
    one batch of `batch_shape` (B, prompt tokens, max_new; tokens drawn
    from `rng`) through `generate`, with
    every kernel's launch count set to 0 just before and read just
    after.  `per_prompt` and `per_step` give the launches a prefill and
    a decode step of each kernel the path runs; every kernel of
    `SERVED_KERNELS` must show exactly that many (0 where not named).
    Then holds the kernels' logits against the plain versions' in the
    model, teacher-forced on the generated tokens (and, in an MoE model,
    on the kernel bf16 run's routing, with the flips held apart by
    MOE_FLIP_RATIO): in bf16 (the e <= 2f, g <= SERVE_BF16_F32_RATIO * f
    rule) and in float32 (within SERVE_F32_TOL) on a float32 copy of
    the same weights.  `f32_copy` declares whether that copy is made
    beside the model (and the run fails if it does not fit, with
    `F32_HEADROOM`); without it, the served model's bf16 logits are
    printed, and after it is freed the bf16 rule and the float32 check
    run on a seeded one-layer model of the same width, in bf16 and then
    cast to float32 in place.  The kernel path's teacher-forced argmax
    must replay every generated token.  Times prefill, decode and the
    batch, traces decode steps after requests[trace_request], emits one
    line and adds the launches to `kernels`.  Returns the number of
    launches; with `keep` (a dict) the model stays on the card as
    `keep["model"]`."""
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get
    from repro_torch.models import Model, decode_step, init_model, prefill
    from repro_torch.serving import BlackBoxProvider, generate

    counters = launch_counters()
    cfg = get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    sc = ServeConfig(max_seq=max_seq)
    P = cfg.prefix_len

    def prefix(batch):
        """Seeded prefix embeddings (batch, P, d_model) in bf16, scaled as
        the CPU tests' (None without a prefix)."""
        if not P:
            return None
        x = rng.standard_normal((batch, P, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(x * np.float32(0.02)).to(
            dev, torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    B, S_b, new_b = batch_shape
    batch = rng.integers(0, cfg.vocab, size=(B, S_b), dtype=np.int32)
    provider = BlackBoxProvider(model, sc, device=dev)
    prefixes = [prefix(1) for _ in requests]
    batch_prefix = prefix(B)

    def answer(prompt, max_new, pe):
        if pe is None:
            return provider.submit(prompt, max_new)
        return generate(model, sc, prompt[None], max_new, device=dev,
                        prefix_embeds=pe)[0].cpu().numpy()

    # one short answer first, so that the counted run's times do not
    # carry the first calls' set-up (cuBLAS handles, library loading)
    answer(requests[0][0][:8], 2, prefixes[0])

    # the main path, counted
    for ops in counters.values():
        ops.reset_launches()
    torch.cuda.synchronize()
    answers, submit_s = [], []
    for (prompt, max_new), pe in zip(requests, prefixes):
        t0 = time.perf_counter()
        answers.append(answer(prompt, max_new, pe))
        submit_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    batch_out = generate(model, sc, batch, new_b, device=dev,
                         prefix_embeds=batch_prefix).cpu().numpy()
    batch_s = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k, ops in counters.items()}
    n_prompts = len(requests) + 1
    n_steps = sum(m - 1 for _, m in requests) + new_b - 1
    for name in SERVED_KERNELS:
        want = (per_prompt.get(name, 0) * n_prompts
                + per_step.get(name, 0) * n_steps)
        check(launches[name] == want,
              f"{phase}: {launches[name]} {name} launches, want {want} "
              f"({per_prompt.get(name, 0)} a prompt x {n_prompts}, "
              f"{per_step.get(name, 0)} a decode step x {n_steps})")
        if name in per_prompt or name in per_step:
            kernels[name]["launches"] += launches[name]
    for (prompt, max_new), out in zip(requests, answers):
        check(out.shape == (max_new,) and out.dtype == np.int32
              and out.min() >= 0 and out.max() < cfg.vocab,
              f"{phase}: answer of shape {out.shape} for max_new {max_new}")
    check(batch_out.shape == (B, new_b)
          and batch_out.min() >= 0 and batch_out.max() < cfg.vocab,
          f"{phase}: batch answer shape {batch_out.shape}")
    peak_bytes = torch.cuda.max_memory_allocated()

    # kernels against plain versions in the model, teacher-forced on the
    # generated tokens (launches here are outside the counted run), in
    # bf16 and in float32 on the same (bf16-valued) weights: on a float32
    # copy of the served model where `f32_copy` declares one (it must
    # fit), else on a seeded one-layer model of the same width, below
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32_bytes = 2 * param_bytes + F32_HEADROOM
    # the memory PyTorch could still use: the driver's free bytes and
    # what the allocator holds unused
    avail = (torch.cuda.mem_get_info(dev)[0]
             + torch.cuda.memory_reserved(dev)
             - torch.cuda.memory_allocated(dev))
    moe = cfg.moe is not None

    def logits_run(m, prompt2d, generated, impl, pe):
        if pe is not None:
            pe = pe.to(m.embed.dtype)
        lg, caches = prefill(m, torch.from_numpy(prompt2d).to(dev),
                             sc.max_seq, impl, prefix_embeds=pe)
        out = [lg[:, -1]]
        pos = P + prompt2d.shape[1]
        for i in range(generated.shape[1] - 1):
            tok = torch.from_numpy(generated[:, i:i + 1].copy()).to(dev)
            lg, caches = decode_step(m, tok, pos + i, caches, impl)
            out.append(lg[:, -1])
        # (B, n_new, vocab): the alignment padding's -inf columns dropped
        return torch.stack(out, 1)[..., :cfg.vocab]

    def max_diff(a, b):
        return float((a - b).abs().max())

    # MoE routing.  The router rounds its logits to bf16 (the
    # reference's semantics), so a one-ulp difference upstream can flip
    # a token's experts, and with a capacity move its batch mates' drops:
    # a discontinuity that the logit bounds do not model.  So every run
    # of a comparison takes the kernel bf16 run's routing (`pinned`),
    # and the flips are counted apart: each MoE call still routes for
    # itself first (`MoE.route` wrapped for the run's length only), and
    # the tokens whose own top-k differs from the pinned one are counted
    # (MOE_FLIP_RATIO holds them).
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.moe import MoE

    def routed(m, *args, pinned=None, ulp_seed=None):
        """logits_run, with (the Routing each MoE call used, each call's
        own top-k experts, sorted); with `ulp_seed`, the plain attention
        versions' outputs moved one bf16 ulp at random."""
        used, own, route = [], [], MoE.route
        fa, da = fa_ref.flash_attention_ref, da_ref.decode_attention_ref

        def wrapped(self, xt):
            r, probs = route(self, xt)
            own.append(r.expert_idx.sort(-1).values)
            if pinned is not None:
                r = pinned[len(used)]
            used.append(r)
            return r, probs
        MoE.route = wrapped
        if ulp_seed is not None:
            gen = torch.Generator(device=dev).manual_seed(ulp_seed)
            fa_ref.flash_attention_ref = (
                lambda *a, **k: one_ulp_off(torch, fa(*a, **k), gen))
            da_ref.decode_attention_ref = (
                lambda *a, **k: one_ulp_off(torch, da(*a, **k), gen))
        try:
            out = logits_run(m, *args)
        finally:
            MoE.route = route
            fa_ref.flash_attention_ref, da_ref.decode_attention_ref = fa, da
        return out, used, own

    def flips(a, b):
        return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))

    moe_flips = {"bf16": 0, "bf16_one_ulp": 0, "float32": 0,
                 "token_layers": 0}
    spans = {"prefill": slice(0, 1), "decode": slice(1, None)}

    def bf16_pass(m):
        """Each run's bf16 logits through the kernels and the plain
        versions (in an MoE model also the plain versions one ulp off,
        for the flips' yardstick), on the kernel run's routing."""
        out = []
        for i, (prompt2d, generated, pe) in enumerate(runs):
            k16, routes, k_own = routed(m, prompt2d, generated, "kernel",
                                        pe)
            p16, _, p_own = routed(m, prompt2d, generated, "plain", pe,
                                   pinned=routes)
            check(all(bool(torch.isfinite(x).all()) for x in (k16, p16)),
                  f"{phase}: non-finite bf16 logits")
            if moe:
                _, _, u_own = routed(m, prompt2d, generated, "plain", pe,
                                     pinned=routes, ulp_seed=i)
                moe_flips["bf16"] += flips(k_own, p_own)
                moe_flips["bf16_one_ulp"] += flips(p_own, u_own)
                moe_flips["token_layers"] += sum(x.shape[0] for x in k_own)
            out.append((k16, p16, routes))
        return out

    err = {"prefill": 0.0, "decode": 0.0, "float32": 0.0}
    floor = {"prefill": None, "decode": None}
    ratio = {"prefill": 0.0, "decode": 0.0}
    gap_f32 = {"prefill": 0.0, "decode": 0.0}
    mean_err = {"prefill": [], "decode": []}

    def f32_pass(m32, bf16_runs):
        """The float32 pair on `bf16_runs`' routing, within
        SERVE_F32_TOL, and the bf16 rule on the same weights."""
        for (prompt2d, generated, pe), (k16, p16, routes) in zip(
                runs, bf16_runs):
            k32, _, k_own = routed(m32, prompt2d, generated, "kernel", pe,
                                   pinned=routes)
            p32, _, p_own = routed(m32, prompt2d, generated, "plain", pe,
                                   pinned=routes)
            moe_flips["float32"] += flips(k_own, p_own)
            check(all(bool(torch.isfinite(x).all()) for x in (k32, p32)),
                  f"{phase}: non-finite float32 logits")
            err["float32"] = max(err["float32"], max_diff(k32, p32))
            for part, sl in spans.items():
                if k16[:, sl].shape[1] == 0:
                    continue
                e = max_diff(k16[:, sl], p16[:, sl])
                f = max_diff(p16[:, sl], p32[:, sl])
                g = max_diff(k16[:, sl], p32[:, sl])
                check(e <= 2 * f,
                      f"{phase}: bf16 {part} logits of the kernels differ "
                      f"from the plain versions' by {e}, more than twice "
                      f"the bf16 noise floor {f}, prompt {prompt2d.shape}")
                check(g <= SERVE_BF16_F32_RATIO * f,
                      f"{phase}: bf16 {part} logits of the kernels differ "
                      f"from float32 by {g}, more than "
                      f"{SERVE_BF16_F32_RATIO} times the plain bf16 path's "
                      f"{f}, prompt {prompt2d.shape}")
                ratio[part] = max(ratio[part], g / f)
                gap_f32[part] = max(gap_f32[part], g)
                mean_err[part].append(float((k16[:, sl] - p16[:, sl]).abs()
                                            .mean()))
                err[part] = max(err[part], e)
                floor[part] = f if floor[part] is None else min(floor[part],
                                                                f)

    runs = [(p[None], a[None], pe)
            for (p, _), a, pe in zip(requests, answers, prefixes)]
    runs.append((batch, batch_out, batch_prefix))
    served = bf16_pass(model)
    served_e = {part: max(max_diff(k16[:, sl], p16[:, sl])
                          for k16, p16, _ in served if k16[:, sl].shape[1])
                for part, sl in spans.items()}
    replay_equal = sum(int((k16.argmax(-1).cpu().numpy() == generated)
                           .sum())
                       for (k16, _, _), (_, generated, _) in zip(served,
                                                                 runs))
    replay_total = sum(m for _, m in requests) + B * new_b
    check(replay_equal == replay_total,
          f"{phase}: the kernel path's teacher-forced logits replay "
          f"{replay_equal} of {replay_total} generated tokens")
    if f32_copy:
        check(f32_bytes <= avail,
              f"{phase}: {arch}'s float32 copy needs {f32_bytes} bytes "
              f"beside the model, {avail} free")
        model32 = Model(cfg32, dev)
        with torch.no_grad():
            for p32, p16 in zip(model32.parameters(), model.parameters()):
                p32.copy_(p16)
        f32_pass(model32, served)
        del model32
    del served

    # times: prefill alone per prompt length (median of 3), decode per
    # token from each request's submit time less its prefill
    prefill_ms = {}
    for (prompt, _), pe in zip(requests, prefixes):
        x = torch.from_numpy(prompt[None]).to(dev)
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(model, x, sc.max_seq, prefix_embeds=pe)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        prefill_ms[len(prompt)] = statistics.median(ts)
    decode_ms = [(s * 1e3 - prefill_ms[len(p)]) / (m - 1)
                 for (p, m), s in zip(requests, submit_s)]
    trace = trace_decode(torch, model, decode_step, prefill, sc,
                         requests[trace_request][0], dev,
                         prefixes[trace_request])
    n_tokens = sum(m for _, m in requests)
    f32_alone = None
    if not f32_copy:
        # the bf16 rule and the float32 check on a model of its own: one
        # layer, seeded, in bf16, then the same weights cast to float32
        # in place, one tensor at a time (a float32 copy beside the bf16
        # weights does not fit one of Arctic's layers)
        if keep is None:
            del provider, model
        gc.collect()
        torch.cuda.empty_cache()
        cfg1 = dataclasses.replace(cfg, n_layers=1)
        model1 = init_model(cfg1, torch.Generator(device=dev).manual_seed(1),
                            device=dev)
        one = bf16_pass(model1)
        with torch.no_grad():
            for p in model1.parameters():
                p.data = p.data.float()
        model1.cfg = dataclasses.replace(cfg1, dtype="float32")
        f32_pass(model1, one)
        f32_alone = dict(n_layers=1, param_bytes=sum(
            p.numel() * p.element_size() for p in model1.parameters()))
        del model1, one
        torch.cuda.empty_cache()
    check(floor["prefill"] is not None and floor["decode"] is not None,
          f"{phase}: the bf16 rule held no prefill or no decode logits")
    check(err["float32"] <= SERVE_F32_TOL,
          f"{phase}: float32 logits of the kernels differ from the plain "
          f"versions' by {err['float32']} (tolerance {SERVE_F32_TOL})")
    if moe:
        check(moe_flips["float32"] == 0,
              f"{phase}: {moe_flips['float32']} float32 routing flips of "
              f"the kernels against the plain versions (want 0)")
        check(moe_flips["bf16"]
              <= MOE_FLIP_RATIO * moe_flips["bf16_one_ulp"],
              f"{phase}: {moe_flips['bf16']} bf16 routing flips of the "
              f"kernels against the plain versions, more than "
              f"{MOE_FLIP_RATIO} times the {moe_flips['bf16_one_ulp']} of "
              f"the plain versions one ulp off")
    emit(phase=phase, arch=cfg.name, n_layers=cfg.n_layers,
         prefix_len=P, params=n_params,
         param_bytes=param_bytes, dtype=cfg.dtype, max_seq=sc.max_seq,
         init_seconds=init_s, requests=[
             dict(prompt=len(p), max_new=m, submit_s=s)
             for (p, m), s in zip(requests, submit_s)],
         batch=dict(B=B, prompt=S_b, max_new=new_b, seconds=batch_s,
                    tokens_per_s=B * new_b / batch_s),
         launches=launches, prefill_ms=prefill_ms,
         decode_ms_per_token=decode_ms,
         decode_ms_per_token_median=statistics.median(decode_ms),
         tokens_per_s=n_tokens / sum(submit_s),
         max_memory_allocated=peak_bytes,
         bf16_rule_on=("the served model" if f32_copy
                       else "a one-layer model of its own"),
         logit_max_abs_err_bf16={k: err[k] for k in ("prefill", "decode")},
         logit_max_abs_err_bf16_served=served_e,
         logit_mean_abs_err_bf16={k: statistics.mean(v)
                                  for k, v in mean_err.items()},
         logit_bf16_vs_f32_floor_min=floor,
         logit_bf16_kernel_vs_f32_max=gap_f32,
         logit_bf16_kernel_vs_plain_f32_gap_ratio_max=ratio,
         bf16_f32_ratio_bound=SERVE_BF16_F32_RATIO,
         logit_max_abs_err_f32=err["float32"], f32_tolerance=SERVE_F32_TOL,
         f32_copy=f32_copy, f32_copy_bytes=f32_bytes, free_bytes=avail,
         f32_model_of_its_own=f32_alone,
         moe_routing_flips_kernel_vs_plain=moe_flips if moe else None,
         moe_flip_ratio_bound=MOE_FLIP_RATIO if moe else None,
         decode_trace=trace, greedy_replay_equal=replay_equal,
         greedy_replay_total=replay_total)
    if keep is not None:
        keep["model"] = model
    return sum(launches.values())


def phase_serve(torch, dev, kernels, keep=None):
    """stablelm-1.6b: 24 flash_attention launches a prompt, 24
    decode_attention launches a decode step, no ssd_intra."""
    from repro_torch.configs import get

    L = get(SERVE_ARCH).n_layers
    rng = np.random.default_rng(0)
    requests = serve_requests(rng, get(SERVE_ARCH).vocab, SERVE_PROMPTS,
                              SERVE_MAX_NEW)
    return serve_model(
        torch, dev, kernels, phase="serve", arch=SERVE_ARCH, max_seq=2048,
        requests=requests, rng=rng, batch_shape=SERVE_BATCH,
        per_prompt={"flash_attention": L}, per_step={"decode_attention": L},
        trace_request=2, keep=keep, f32_copy=True)


# ---------------------------------------------------------------------------
# 7b. the paper's deployment: the scheduler in front of the served model
# ---------------------------------------------------------------------------

# run 1: the launcher's requests; run 2: `examples/serve_blackbox.py`'s
# flow (16 requests, a provider that 429s past two in flight, the
# session's clock at twice the wall's)
DEPLOY_RUN1 = 12
DEPLOY_RUN2 = (16, 2, 2.0)   # requests, max_inflight, time_scale


class Recorder:
    """A blocking provider's `submit` seen from inside the black box:
    every generation's prompt, max_new and output, and the most
    generations that ran at once."""

    def __init__(self, provider):
        import threading

        self.provider = provider
        self.lock = threading.Lock()
        self.calls = []
        self.running = 0
        self.peak = 0

    def submit(self, prompt, max_new):
        with self.lock:
            self.running += 1
            self.peak = max(self.peak, self.running)
        try:
            out = self.provider.submit(prompt, max_new)
        finally:
            with self.lock:
                self.running -= 1
        with self.lock:
            self.calls.append((np.asarray(prompt).copy(), int(max_new), out))
        return out


def recording_session(sessions):
    """A `ClientSession` that counts `sched_score_topb` from the end of
    its warm-up, turns on `enable_profiling` and adds itself to
    `sessions`: put in `repro_torch.serving.blackbox`'s namespace, it
    lets the check read the session `ScheduledClient.run` builds."""
    from repro_torch.client import ClientSession
    from repro_torch.kernels.sched_score import ops

    class RecordingSession(ClientSession):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            ops.reset_launches()
            self.prof = self.enable_profiling()
            sessions.append(self)

    return RecordingSession


def deployment_summary(what, reqs, rec, sess, prof, secs, L, counts):
    """One run's checks and figures: every request terminal, nothing in
    flight, `flash_attention` 24 a generation started, `decode_attention`
    24 a decode step, `sched_score_topb` K + 1 a device-stepped poll."""
    from repro_torch.kernels.sched_score import ops as sched_ops

    k = 2
    names = [r.status for r in reqs]
    check(all(st in ("completed", "rejected", "abandoned") for st in names),
          f"deployment {what}: statuses {names}")
    check(sess.provider.inflight() == 0 and sess.unfinished == 0,
          f"deployment {what}: {sess.provider.inflight()} left in flight")
    gens = len(rec.calls)
    steps = sum(m - 1 for _, m, _ in rec.calls)
    want = {"flash_attention": L * gens, "decode_attention": L * steps}
    for name, n in want.items():
        check(counts[name] == n, f"deployment {what}: {counts[name]} {name} "
              f"launches, want {n} ({gens} generations, {steps} decode "
              f"steps)")
    polls = prof["polls"]
    sched = sched_ops.LAUNCHES["sched_score_topb"]
    check(polls > 0 and sched == (k + 1) * polls,
          f"deployment {what}: {sched} sched_score_topb launches over "
          f"{polls} device-stepped polls")
    done = [r for r in reqs if r.status == "completed"]
    lat = np.asarray([r.finish_s - r.arrival_s for r in done])
    tokens = sum(m for _, m, _ in rec.calls)
    return dict(
        requests=len(reqs), completed=len(done),
        rejected=names.count("rejected"), abandoned=names.count("abandoned"),
        latency_mean_s=float(lat.mean()) if len(lat) else None,
        latency_p95_s=float(np.percentile(lat, 95)) if len(lat) else None,
        generations=gens, tokens=tokens, seconds=secs,
        tokens_per_s=tokens / secs, peak_generations_at_once=rec.peak,
        session_peak_inflight=sess.stats.peak_inflight,
        polls=sess.stats.n_polls, device_stepped_polls=polls,
        idle_sleeps=sess.stats.n_idle_sleeps,
        throttled=sess.stats.n_throttled,
        breakdown_ms_per_poll={kk: v / polls * 1e3
                               for kk, v in prof.items() if kk != "polls"},
        flash_attention_launches=counts["flash_attention"],
        decode_attention_launches=counts["decode_attention"],
        sched_score_topb_launches=sched)


def phase_deployment(torch, dev, kernels=None, model=None):
    """Phase 7b (module docstring).  `model` is phase 7's StableLM when it
    is still on the card; else (`--only=deployment`) it is built as phase
    7 builds it."""
    import warnings
    from unittest import mock

    from repro_torch.client import (AsyncBlackBoxProvider, ClientSession,
                                    SessionConfig)
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get
    from repro_torch.core.policy import strategy
    from repro_torch.kernels.sched_score import ops as sched_ops
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    from repro_torch.serving import BlackBoxProvider
    from repro_torch.serving import blackbox as serving_blackbox

    t_phase = time.perf_counter()
    counters = launch_counters()
    if model is None:
        model = init_model(get(SERVE_ARCH),
                           torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    L = model.cfg.n_layers
    sc = ServeConfig(max_seq=128, temperature=0.0)
    engine = BlackBoxProvider(model, sc, device=dev)
    engine.submit(np.zeros(8, np.int32), 2)   # first calls' set-up
    torch.cuda.synchronize()

    def counts():
        return {nm: counters[nm].LAUNCHES[nm]
                for nm in ("flash_attention", "decode_attention")}

    def reset():
        for nm in ("flash_attention", "decode_attention"):
            counters[nm].reset_launches()

    # run 1: the launcher's main, its model the one on the card, its
    # provider seen through a Recorder and its session recorded
    made, sessions = [], []

    def recorded_provider(m, s, device):
        made.append(Recorder(BlackBoxProvider(m, s, device=device)))
        return made[-1]

    reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with mock.patch.object(serve, "build_model", lambda a, d: model), \
                mock.patch.object(serve, "BlackBoxProvider",
                                  recorded_provider), \
                mock.patch.object(serving_blackbox, "ClientSession",
                                  recording_session(sessions)):
            reqs1 = serve.main(["--arch", SERVE_ARCH, "--requests",
                                str(DEPLOY_RUN1), "--device", dev.type])
    torch.cuda.synchronize()
    secs1 = time.perf_counter() - t0
    check(len(sessions) == 1 and len(made) == 1,
          f"deployment run 1: {len(sessions)} sessions, {len(made)} "
          f"providers")
    rec1 = made[0]
    run1 = deployment_summary("run 1", reqs1, rec1, sessions[0],
                              sessions[0].prof, secs1, L, counts())

    # run 2: a ClientSession over AsyncBlackBoxProvider(max_inflight=2)
    n2, cap2, scale2 = DEPLOY_RUN2
    rec2 = Recorder(engine)
    prov2 = AsyncBlackBoxProvider(rec2, max_workers=4, max_inflight=cap2)
    policy = strategy("final_adrr_olc")._replace(
        timeout_mult=torch.full((4,), 30.0, dtype=torch.float32))
    sess2 = ClientSession(prov2, policy,
                          SessionConfig(window=max(32, n2), max_grants=4,
                                        time_scale=scale2),
                          clock="wall", device=dev)
    sched_ops.reset_launches()
    prof2 = sess2.enable_profiling()
    reset()
    t0 = time.perf_counter()
    try:
        for r in serve.make_requests(n2, seed=0):
            sess2.submit(r)
        reqs2 = sess2.drain()
    finally:
        prov2.shutdown()
    torch.cuda.synchronize()
    secs2 = time.perf_counter() - t0
    run2 = deployment_summary("run 2", reqs2, rec2, sess2, prof2, secs2, L,
                              counts())
    check(prov2.n_throttled > 0 and sess2.stats.n_throttled > 0,
          f"deployment run 2: never throttled (max_inflight {cap2})")
    check(max(rec1.peak, rec2.peak) > 1,
          f"deployment: no two generations ran at once (peaks {rec1.peak}, "
          f"{rec2.peak})")

    # the tokens: each completed output against the same prompt's
    # sequential submit on the card
    t0 = time.perf_counter()
    n_equal = 0
    for reqs in (reqs1, reqs2):
        for r in reqs:
            if r.status != "completed":
                continue
            check(r.output is not None and r.output.shape == (r.max_new,),
                  f"deployment: request {r.rid} answered "
                  f"{None if r.output is None else r.output.shape} for "
                  f"max_new {r.max_new}")
            want = engine.submit(r.prompt, r.max_new)
            check(np.array_equal(r.output, want),
                  f"deployment: request {r.rid}'s tokens differ from its "
                  f"sequential submit: {r.output.tolist()} vs "
                  f"{want.tolist()}")
            n_equal += 1
    replay_s = time.perf_counter() - t0
    check(n_equal > 0, "deployment: nothing completed")
    total = {nm: run1[f"{nm}_launches"] + run2[f"{nm}_launches"]
             for nm in ("flash_attention", "decode_attention",
                        "sched_score_topb")}
    if kernels is not None:
        for nm, v in total.items():
            kernels[nm]["launches"] += v
    emit(phase="deployment", arch=model.cfg.name, dtype=model.cfg.dtype,
         max_seq=sc.max_seq, run1=dict(path="launch.serve.main -> "
                                       "ScheduledClient", **run1),
         run2=dict(path="ClientSession -> AsyncBlackBoxProvider",
                   max_inflight=cap2, time_scale=scale2, **run2),
         outputs_equal_sequential=n_equal, replay_seconds=replay_s,
         phase_seconds=time.perf_counter() - t_phase)
    del engine, model
    return sum(total.values())



# ---------------------------------------------------------------------------
# 8. the SSD kernel against its plain version
# ---------------------------------------------------------------------------

SSD_TOL = 1e-4   # abs and rel, the CPU tests' bound against the reference
SSD_SRC = "src/repro_torch/kernels/ssd_scan/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:53"
PEAK_TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
# (geometry, B, S): the prompts the serve runs give the kernel.  Mamba2:
# H = 48, P = 64, N = 128; Hymba: H = 50, P = 64, N = 16; chunk 128.
# S = 8 and 37 are one short chunk each, 300 is padded to 384.  "odd" and
# "wide" are no served model's: in "odd" Q, H, P and N all leave tails
# (37, 5, 8, 24); "wide" has N = 201, past one 128-column tile of B and
# not a multiple of 4 (two chunks, the second padded)
SSD_CASES = (("mamba2", 1, 1024), ("mamba2", 1, 8), ("mamba2", 1, 37),
             ("mamba2", 1, 300), ("mamba2", 4, 256), ("hymba", 1, 300),
             ("hymba", 1, 1536), ("hymba", 4, 256), ("hymba", 1, 2048),
             ("odd", 1, 37), ("wide", 1, 150))
SSD_OFF_MODEL = {"odd": (5, 8, 24, 128), "wide": (3, 16, 201, 128)}
# each case's dt is drawn two ways, with A = exp(A_log) of the init
# (linspace(1, 16, H)).  "init": softplus of a unit normal, as the seeded
# model gives it (dt_bias 0), about 0.8, so that a step's weight has
# decayed below 1e-6 within ~17 steps and most of the chunk's Q x Q
# patches and state rows add too little to show at 1e-4.  "published":
# log-uniform in Mamba2's dt range [1e-3, 0.1], where the slowest heads
# keep ~0.07 of a step's weight across a 128-step chunk, so every patch
# of C.B^T and every row of the state's sum over the chunk shows.
SSD_DT = ("init", "published")
SSD_LINE = ("mamba2", 1, 1024, "init")


def ssd_work(B, nc, Q, H, P, N):
    """(bytes, operations, product operations) the intra-chunk step
    needs: each input read and each output written once; C.B^T once per
    (batch, chunk) on and below the diagonal (it is the same for every
    head), then per head the decay weights (subtract, exp, two products
    per pair), W x on the causal pairs, the state weights and the state
    product.  The three products (C.B^T, W x, the state) are the
    tensor-core route's."""
    pairs = Q * (Q + 1) // 2
    n_bytes = 4 * B * nc * (2 * Q * H * P + 2 * Q * N + 2 * Q * H + H * P * N)
    n_products = B * nc * (2 * N * pairs + H * (2 * P * pairs
                                                + 2 * Q * P * N))
    n_ops = n_products + B * nc * H * (4 * pairs + 3 * Q + Q * P)
    return n_bytes, n_ops, n_products


def ssd_bounds(work):
    """ms of the bounds of `ssd_work`'s work: bytes; the kernel's route,
    the tensor cores' (3 TF32 products for each product operation, the
    rest as float32); and, for comparison with the CUDA-core body of
    earlier builds, every operation as float32 on the CUDA cores.  The
    kernel's bound (`bound_ms`, `bound_by`) is the larger of the first
    two."""
    n_bytes, n_ops, n_products = work
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_tc = (3 * n_products / PEAK_TF32_OPS_PER_S
            + (n_ops - n_products) / PEAK_F32_OPS_PER_S) * 1e3
    return dict(
        bound_ms=max(t_bytes, t_tc),
        bound_by="bytes" if t_bytes >= t_tc else "operations",
        bound_bytes_ms=t_bytes, bound_tc_ms=t_tc,
        bound_f32_ms=n_ops / PEAK_F32_OPS_PER_S * 1e3)


def ssd_geometry(g):
    """(H, P, N, chunk) of a phase 8 geometry."""
    if g in SSD_OFF_MODEL:
        return SSD_OFF_MODEL[g]
    from repro_torch.configs import get

    cfg = get({"mamba2": "mamba2-780m", "hymba": "hymba-1.5b"}[g])
    return (cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.chunk)


def ssd_cases(torch, dev):
    """(case, args) for every phase 8 shape and dt draw, in order from one
    seeded generator: `args` are `ssd_intra`'s five inputs on `dev`."""
    from repro_torch.models.ssm import chunk_inputs, softplus

    gen = torch.Generator(device=dev).manual_seed(2468)
    for (g, B, S), dt_kind in itertools.product(SSD_CASES, SSD_DT):
        H, P, N, chunk = ssd_geometry(g)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        if dt_kind == "init":
            dt = softplus(rand(B, S, H))
        else:
            u = torch.rand((B, S, H), generator=gen, device=dev)
            dt = torch.exp(math.log(1e-3) + u * math.log(1e2))
        A = torch.linspace(1.0, 16.0, H, device=dev)
        args = chunk_inputs(rand(B, S, H, P), rand(B, S, N), rand(B, S, N),
                            dt, A, chunk)
        nc, Q = args[0].shape[1], args[0].shape[2]
        yield dict(geometry=g, B=B, S=S, dt=dt_kind, nc=nc, Q=Q, H=H, P=P,
                   N=N), args


def ssd_share(torch, got, want):
    """The largest |got - want| / (SSD_TOL + SSD_TOL |want|), inf where
    `got` is not finite: within the tolerance iff <= 1."""
    if not bool(torch.isfinite(got).all()):
        return math.inf
    d = (got - want).abs() / (SSD_TOL + SSD_TOL * want.abs())
    return float(d.max())


def ssd_kernels_per_call(torch, dev):
    """Device kernels a call of `ssd_intra` launches at the kernels line's
    shape (the first of `ssd_cases`), by torch.profiler.  Taken before the
    phases that trace with the profiler: in one full run a profile taken
    after them showed no device kernel for this call, though it ran."""
    from repro_torch.kernels.ssd_scan import ops

    case, args = next(ssd_cases(torch, dev))
    check((case["geometry"], case["B"], case["S"], case["dt"]) == SSD_LINE,
          "the first SSD case is not the kernels line's")
    return kernels_per_call(torch, lambda: ops.ssd_intra(*args))


def phase_ssd_kernel(torch, dev, per_call):
    from repro_torch.kernels.ssd_scan import ops, ref

    rows, err = [], 0.0
    for case, args in ssd_cases(torch, dev):
        got = ops.ssd_intra(*args)
        want = ref.ssd_intra_ref(*args)
        errs, shares = {}, {}
        for name, a, b in zip(("y", "state"), got, want):
            errs[name] = float((a - b).abs().max())
            shares[name] = ssd_share(torch, a, b)
            check(shares[name] <= 1.0,
                  f"ssd_intra {case}: {name} differs from the plain "
                  f"version (max abs err {errs[name]}, "
                  f"{shares[name]} of the tolerance)")
        err = max(err, *errs.values())
        shape = (case["B"], case["nc"], case["Q"], case["H"], case["P"],
                 case["N"])
        hg = ops.heads_per_cta(case["B"], case["nc"], case["H"])
        work = ssd_work(*shape)
        rows.append(dict(
            name="ssd_intra", **case, max_abs_err_y=errs["y"],
            max_abs_err_state=errs["state"], tolerance_share_y=shares["y"],
            tolerance_share_state=shares["state"], heads_per_cta=hg,
            ctas=-(-case["H"] // hg) * case["B"] * case["nc"],
            ms=device_ms(torch, lambda: ops.ssd_intra(*args)),
            plain_ms=device_ms(torch, lambda: ref.ssd_intra_ref(*args),
                               reps=20),
            library_ms=None, **ssd_bounds(work),
            bytes=work[0], operations=work[1], product_operations=work[2]))
    torch.cuda.synchronize()
    for row in rows:
        emit(phase="ssd_kernel_case", **row)
    check(round(per_call) == 1,
          f"ssd_intra: a call launched {per_call} kernels, not one")
    emit(phase="ssd_kernel", cases=len(rows), max_abs_err=err,
         tolerance=SSD_TOL, max_tolerance_share=max(
             max(r["tolerance_share_y"], r["tolerance_share_state"])
             for r in rows), kernels_per_call=per_call)
    line = next(r for r in rows
                if (r["geometry"], r["B"], r["S"], r["dt"]) == SSD_LINE)
    return {"ssd_intra": dict(
        name="ssd_intra", route="cuda", source=SSD_SRC,
        replaces=SSD_REPLACES, launches=0, max_abs_err=err, ms=line["ms"],
        plain_ms=line["plain_ms"], bound_ms=line["bound_ms"],
        bound_by=line["bound_by"], bound_f32_ms=line["bound_f32_ms"],
        library_ms=None)}


# ---------------------------------------------------------------------------
# 9-10. the state-space and hybrid serving paths at full width
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "hymba-1.5b"
HYBRID_PROMPTS = (300, 1536)   # the second passes the 1024-token window
HYBRID_MAX_NEW = (8, 8)


def phase_serve_ssm(torch, dev, kernels):
    """mamba2-780m: the StableLM run's six requests and batch; 48
    ssd_intra launches a prompt, none a decode step, no attention."""
    from repro_torch.configs import get

    cfg = get(SSM_ARCH)
    rng = np.random.default_rng(0)
    requests = serve_requests(rng, cfg.vocab, SERVE_PROMPTS, SERVE_MAX_NEW)
    return serve_model(
        torch, dev, kernels, phase="serve_ssm", arch=SSM_ARCH, max_seq=2048,
        requests=requests, rng=rng, batch_shape=SERVE_BATCH,
        per_prompt={"ssd_intra": cfg.n_layers}, per_step={},
        trace_request=2, f32_copy=True)


def phase_serve_hybrid(torch, dev, kernels):
    """hymba-1.5b: 32 flash_attention and 32 ssd_intra launches a
    prompt, 32 decode_attention launches a decode step."""
    from repro_torch.configs import get

    cfg = get(HYBRID_ARCH)
    L = cfg.n_layers
    rng = np.random.default_rng(3)
    requests = serve_requests(rng, cfg.vocab, HYBRID_PROMPTS, HYBRID_MAX_NEW)
    return serve_model(
        torch, dev, kernels, phase="serve_hybrid", arch=HYBRID_ARCH,
        max_seq=2048, requests=requests, rng=rng, batch_shape=SERVE_BATCH,
        per_prompt={"flash_attention": L, "ssd_intra": L},
        per_step={"decode_attention": L}, trace_request=0, f32_copy=True)


# ---------------------------------------------------------------------------
# 11. the rest of the model zoo at published width
# ---------------------------------------------------------------------------

# (arch, layers run, float32 copy beside it): the width is always the
# published one, and depth is cut only where the card's 80 GB forces it:
# Arctic to 2 of 35 layers (27.2 GB of bf16 a layer, 0.92 GB of
# embedding and head) and Nemotron-4 to 4 of 96 (6.91 and 18.9 GB); the
# others run at the issue's depths, Phi-3.5-MoE at 8 of 32 layers and
# Qwen1.5 at 16 of 64 (each layer alike, so the checks see the same
# code), InternVL2 and MusicGen whole.  A float32 copy of the weights
# fits beside all but Arctic (55.4 GB) and Nemotron-4 (46.5 GB): their
# bf16 rule and float32 check run on a one-layer model of their own
# after the served model is freed, and phase 6 holds the kernels in
# float32 at their geometry.
ZOO_RUNS = (("phi3.5-moe-42b-a6.6b", 8, True), ("arctic-480b", 2, False),
            ("qwen1.5-32b", 16, True), ("nemotron-4-340b", 4, False),
            ("internvl2-1b", None, True), ("musicgen-large", None, True))
ZOO_PROMPTS = (37, 512)        # tokens, one request each
ZOO_MAX_NEW = (16, 16)
ZOO_BATCH = (4, 256, 16)       # B, prompt tokens, max_new
ZOO_MAX_SEQ = 1024             # InternVL2: 256 + 512 + 16 positions


def phase_serve_zoo(torch, dev, kernels=None):
    """The six architectures of the zoo's last slice, one at a time, each
    freed before the next: L flash_attention launches a prompt and L
    decode_attention a decode step.  Returns the launches; prints each
    run's seconds."""
    from repro_torch.configs import get

    if kernels is None:   # a rehearsal (--only): counts kept here
        kernels = {k: {"launches": 0} for k in SERVED_KERNELS}
    total, secs = 0, {}
    for arch, n_layers, f32_copy in ZOO_RUNS:
        # every earlier model's memory back first (earlier phases' and
        # the last run's objects may sit in reference cycles)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = get(arch)
        L = n_layers or cfg.n_layers
        rng = np.random.default_rng(0)
        requests = serve_requests(rng, cfg.vocab, ZOO_PROMPTS, ZOO_MAX_NEW)
        total += serve_model(
            torch, dev, kernels, phase="serve_zoo", arch=arch,
            max_seq=ZOO_MAX_SEQ, requests=requests, rng=rng,
            batch_shape=ZOO_BATCH, per_prompt={"flash_attention": L},
            per_step={"decode_attention": L}, trace_request=1,
            f32_copy=f32_copy, n_layers=n_layers)
        secs[arch] = time.perf_counter() - t0
    emit(phase="serve_zoo_seconds", **secs)
    return total


# StarCoder2-3B whole (30 layers, GQA 24/2 at head dim 128, biases on
# every linear), behind its 4,096-token sliding window: the model-level
# ring cache wraps in prefill (5,000 tokens) and again in decode
STARCODER_ARCH = "starcoder2-3b"
STARCODER_PROMPTS = (37, 5000)   # tokens, one request each
STARCODER_MAX_NEW = (16, 16)
STARCODER_MAX_SEQ = 8192         # the ring holds min(4096, max_seq)


def phase_serve_starcoder2(torch, dev, kernels=None):
    """StarCoder2-3B at full width and depth: 30 flash_attention
    launches a prompt, 30 decode_attention a decode step."""
    from repro_torch.configs import get

    if kernels is None:   # a rehearsal (--only): counts kept here
        kernels = {k: {"launches": 0} for k in SERVED_KERNELS}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get(STARCODER_ARCH)
    check(STARCODER_PROMPTS[-1] > cfg.sliding_window,
          "serve_starcoder2: the long prompt does not pass the window")
    L = cfg.n_layers
    rng = np.random.default_rng(0)
    requests = serve_requests(rng, cfg.vocab, STARCODER_PROMPTS,
                              STARCODER_MAX_NEW)
    return serve_model(
        torch, dev, kernels, phase="serve_starcoder2", arch=STARCODER_ARCH,
        max_seq=STARCODER_MAX_SEQ, requests=requests, rng=rng,
        batch_shape=ZOO_BATCH, per_prompt={"flash_attention": L},
        per_step={"decode_attention": L}, trace_request=1, f32_copy=True)


# ---------------------------------------------------------------------------
# 12. training: card against CPU, a loss that falls, full width
# ---------------------------------------------------------------------------

# (a) smoke configs in float32, card against CPU from the same CPU-drawn
# weights over the same pipeline batches
TRAIN_PARITY_ARCHS = ("stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "mamba2-780m")
TRAIN_PARITY = (3, 4, 32)    # steps, batch, sequence
TRAIN_PARITY_RTOL = 1e-4     # losses and grad norms, card against CPU
# (b) `launch.train.run` at the reference test's lr, steps and batch
# (its warmup is a tenth of the steps, 6); the loss must fall by 0.3
TRAIN_RUN = dict(arch="stablelm-1.6b", steps=60, batch=8, seq=64, lr=3e-3)
TRAIN_FALL = 0.3
# (c) full width: arch, batch, sequence, warm-up steps, timed steps
TRAIN_FULL = ("stablelm-1.6b", 4, 1024, 2, 8)
TRAIN_MICRO = 4              # microbatches of the memory comparison


def all_launch_counters():
    from repro_torch.kernels.sched_score import ops as sched

    return {**launch_counters(), "sched_score": sched}


def total_launches(counters):
    return {k: n for ops in counters.values() for k, n in ops.LAUNCHES.items()}


def train_batches(torch, cfg, batch, seq, n, dev, seed=0):
    """n pipeline batches as tensors on `dev`."""
    from repro_torch.data import DataConfig, make_batches

    data = make_batches(DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch,
                                   seed=seed))
    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for _, b in zip(range(n), data)]


def train_parity(torch, dev, arch):
    """3 train steps of `arch`'s smoke config in float32 on the CPU and
    on the card from the same weights (drawn on the CPU) and batches:
    losses and grad norms within TRAIN_PARITY_RTOL."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model, init_model
    from repro_torch.training import init_train_state
    from repro_torch.training.train_step import train_step

    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    tc = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    steps, batch, seq = TRAIN_PARITY
    m_cpu = init_model(cfg, torch.Generator().manual_seed(0), device=cpu)
    m_card = Model(cfg, dev)
    with torch.no_grad():
        for a, b in zip(m_card.parameters(), m_cpu.parameters()):
            a.copy_(b)
    out = {}
    for where, model in (("card", m_card), ("cpu", m_cpu)):
        d = model.device
        state = init_train_state(model, tc, device=d)
        rows = []
        for b in train_batches(torch, cfg, batch, seq, steps, d):
            state, m = train_step(state, b, tc)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[where] = (rows, {k: p.detach().cpu()
                             for k, p in model.named_parameters()})
    (card, p_card), (cpu_rows, p_cpu) = out["card"], out["cpu"]
    rel = max(abs(a - b) / abs(b) for ra, rb in zip(card, cpu_rows)
              for a, b in zip(ra, rb))
    check(rel <= TRAIN_PARITY_RTOL,
          f"train: {arch} card against CPU, losses and grad norms "
          f"{card} vs {cpu_rows}: {rel:.3g} relative")
    n = n_off = 0
    for k in p_cpu:
        diff = (p_card[k] - p_cpu[k]).abs()
        n += diff.numel()
        n_off += int((diff > 1e-6).sum())
    return dict(arch=cfg.name, losses_card=[r[0] for r in card],
                grad_norms_card=[r[1] for r in card],
                losses_cpu=[r[0] for r in cpu_rows],
                grad_norms_cpu=[r[1] for r in cpu_rows],
                max_rel_diff=rel, rtol=TRAIN_PARITY_RTOL,
                param_elements_off_by_1e6=n_off, param_elements=n,
                param_max_abs_diff=max(float((p_card[k] - p_cpu[k]).abs()
                                             .max()) for k in p_cpu))


def train_microbatch(torch, dev):
    """The reference's microbatch test on the card: stablelm-smoke in
    float32, a 4 x 32 batch whole and as 4 microbatches, loss within
    1e-4 relative and parameters within 1e-4."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    from repro_torch.training import init_train_state
    from repro_torch.training.train_step import train_step

    cfg = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32")
    toks = torch.randint(0, cfg.vocab, (4, 32), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1)).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = []
    for n in (1, 4):
        tc = TrainConfig(microbatches=n)
        model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        state, m = train_step(init_train_state(model, tc, device=dev), batch,
                              tc)
        out.append((float(m["loss"]), {k: p.detach() for k, p in
                                        state.model.named_parameters()}))
    (l1, p1), (l4, p4) = out
    rel = abs(l1 - l4) / abs(l1)
    diff = max(float((p1[k] - p4[k]).abs().max()) for k in p1)
    check(rel <= 1e-4 and diff < 1e-4,
          f"train: microbatched step against the whole batch: loss "
          f"{l4} vs {l1}, params {diff}")
    return dict(loss_whole=l1, loss_micro=l4, loss_rel_diff=rel,
                param_max_abs_diff=diff)


def train_loss_falls(torch, dev):
    """(b): `launch.train.run` on the card; then its checkpoint restored
    on the card bit for bit, and a bf16 train state's (float32 master
    and moments, int32 step) saved and restored bit for bit."""
    import tempfile

    from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.checkpoint.io import _leaves, _to_numpy
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import Model, init_model
    from repro_torch.training import init_train_state
    from repro_torch.training.train_step import train_step

    run = TRAIN_RUN
    cfg = get_smoke(run["arch"])
    (ROOT / "build").mkdir(exist_ok=True)   # git-ignored, in the checkout
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        losses = train_launcher.run(
            run["arch"], smoke=True, steps=run["steps"], batch=run["batch"],
            seq=run["seq"], lr=run["lr"], microbatches=1, ckpt_dir=d,
            log_every=run["steps"], device=dev)
        run_s = time.perf_counter() - t0
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        check(np.isfinite(losses).all() and last <= first - TRAIN_FALL,
              f"train: the loss fell from {first} to {last} over "
              f"{run['steps']} steps, want a fall of {TRAIN_FALL}")
        step = latest_step(d)
        check(step == run["steps"], f"train: latest checkpoint {step}")
        # the launcher's checkpoint (the model, bf16) into a fresh model
        model = Model(cfg, dev)
        restore_checkpoint(d, step, model)
        with np.load(Path(d) / f"ckpt_{step:08d}.npz") as data:
            same = all(np.array_equal(_to_numpy(t), data[k])
                       for k, t in _leaves(model))
        check(same, "train: the launcher's checkpoint did not restore on "
              "the card bit for bit")
        # a whole train state: bf16 parameters, float32 master and
        # moments, the step, restored into zeros
        tc = TrainConfig()
        state = init_train_state(init_model(
            cfg, torch.Generator(device=dev).manual_seed(1), device=dev), tc,
            device=dev)
        for b in train_batches(torch, cfg, 2, 32, 2, dev):
            state, _ = train_step(state, b, tc)
        save_checkpoint(d, 2, state, {"arch": cfg.name})
        fresh = init_train_state(Model(cfg, dev), tc, device=dev)
        with torch.no_grad():
            for _, t in _leaves(fresh):
                t.zero_()
        restore_checkpoint(d, 2, fresh)
        pairs = list(zip((t for _, t in _leaves(fresh)),
                         (t for _, t in _leaves(state))))
        bits = all(a.dtype == b.dtype and a.device == b.device
                   and torch.equal(a.view(torch.int16)
                                   if a.dtype == torch.bfloat16 else a,
                                   b.view(torch.int16)
                                   if b.dtype == torch.bfloat16 else b)
                   for a, b in pairs)
        check(bits, "train: the train state did not round-trip bit for bit")
        dtypes = sorted({str(a.dtype) for a, _ in pairs})
    return dict(arch=cfg.name, steps=run["steps"], batch=run["batch"],
                seq=run["seq"], lr=run["lr"], seconds=run_s,
                first10_mean=float(first), last10_mean=float(last),
                fall=float(first - last), want_fall=TRAIN_FALL,
                losses_every_10=losses[::10],
                launcher_checkpoint_bits_equal=same,
                train_state_bits_equal=bits, state_leaves=len(pairs),
                state_dtypes=dtypes)


def train_flops(cfg, batch, seq, n_params):
    """Operations of one remat step: 8 N T for the matrices (forward,
    the recomputed forward, backward twice the forward; the embedding's
    gather is no product), and the plain attention's two float32
    products over every (query, key) pair, 4 B H S^2 hd a pass, four
    passes."""
    T = batch * seq
    dense = 8 * (n_params - cfg.padded_vocab * cfg.d_model) * T
    attn = 4 * 4 * batch * cfg.n_heads * seq * seq * cfg.head_dim \
        * cfg.n_layers
    return dense, attn


def device_ms_by_kind(per_name):
    """A trace's device µs by name summed into kinds of kernel (ms):
    float32 and other matrix products, softmax, reductions,
    elementwise and the rest."""
    kinds = {}
    for name, us in per_name.items():
        low = name.lower()
        if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
            kind = ("matmul_f32" if "f32f32" in low or "sgemm" in low
                    else "matmul_other")
        elif "softmax" in low:
            kind = "softmax"
        elif "reduce" in low:
            kind = "reduce"
        elif "elementwise" in low:
            kind = "elementwise"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    return kinds


def train_full_width(torch, dev):
    """(c): `TRAIN_FULL` at published width and depth, bf16 parameters,
    AdamW with float32 master and moments, remat on."""
    import warnings

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get
    from repro_torch.models import init_model
    from repro_torch.training import adamw, init_train_state
    from repro_torch.training.train_step import _grads, train_step

    arch, B, S, n_warm, n_timed = TRAIN_FULL
    cfg = get(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tc = TrainConfig(lr=3e-4, warmup_steps=n_warm, total_steps=n_warm
                     + n_timed + 3, remat=True)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    state = init_train_state(model, tc, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = torch.cuda.memory_allocated(dev)
    batches = train_batches(torch, cfg, B, S, n_warm + n_timed + 4, dev)
    losses, gnorms, step_ms = [], [], []
    for i, b in enumerate(batches[:n_warm + n_timed]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, b, tc)
        losses.append(float(m["loss"]))   # the step's one sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"train: non-finite full-width losses {losses} or grad norms "
          f"{gnorms}")
    timed = step_ms[n_warm:]
    med = statistics.median(timed)
    # one step traced
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    state, m = train_step(state, batches[n_warm + n_timed], tc)
    torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    busy_us, n_ops, per_name = device_activity(torch, prof)
    check(n_ops > 0, "train: the traced step shows no device work")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    # host syncs in a step that reads nothing back
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, m = train_step(state, batches[n_warm + n_timed + 1], tc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(x.message) for x in caught)
    check(math.isfinite(float(m["loss"])), "train: non-finite loss")
    # one step split: gradients (forward, recomputed forward, backward),
    # then the AdamW update
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = _grads(model, batches[n_warm + n_timed + 2], tc)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw.apply(state.opt, grads, tc, dict(model.named_parameters()))
    torch.cuda.synchronize()
    split_ms = dict(gradients=(t1 - t0) * 1e3,
                    adamw=(time.perf_counter() - t1) * 1e3)
    check(math.isfinite(float(loss)), "train: non-finite loss")
    del grads, loss
    model.zero_grad(set_to_none=True)
    # one microbatched step's peak beside the whole batch's
    tc_micro = dataclasses.replace(tc, microbatches=TRAIN_MICRO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = train_step(state, batches[n_warm + n_timed + 3], tc_micro)
    micro_loss = float(m["loss"])
    micro_ms = (time.perf_counter() - t0) * 1e3
    micro_peak = torch.cuda.max_memory_allocated(dev)
    check(math.isfinite(micro_loss), "train: non-finite microbatched loss")
    dense, attn = train_flops(cfg, B, S, n_params)
    del state, model, m
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                params=n_params, dtype=cfg.dtype, batch=B, seq=S,
                remat=tc.remat, warmup_steps=n_warm, timed_steps=n_timed,
                step_ms=step_ms, step_ms_median=med,
                tokens_per_s=B * S / med * 1e3,
                state_gb=state_bytes / 1e9, peak_gb=peak / 1e9,
                losses=losses, grad_norms=gnorms,
                flop_per_step=dense + attn, attention_flop_per_step=attn,
                tflop_per_s=(dense + attn) / med / 1e9,
                traced_step=dict(wall_ms=traced_ms, device_ops=n_ops,
                                 device_busy_ms=busy_us / 1e3,
                                 device_idle_share=1.0 - busy_us / 1e3
                                 / traced_ms,
                                 # the profiler slows the host: against
                                 # the untraced median step too
                                 device_idle_share_of_median_step=1.0
                                 - busy_us / 1e3 / med,
                                 device_ms_by_kind=device_ms_by_kind(
                                     per_name),
                                 top_device_us=[[k[:60], us]
                                                for k, us in top]),
                step_split_ms=split_ms,
                host_syncs_in_a_step=syncs,
                microbatches=TRAIN_MICRO, micro_step_ms=micro_ms,
                micro_peak_gb=micro_peak / 1e9, micro_loss=micro_loss)


def phase_train(torch, dev):
    """Phase 12 (module docstring).  Returns the kernel launches across
    it, which must be 0: training runs the plain path."""
    counters = all_launch_counters()
    for ops in counters.values():
        ops.reset_launches()
    parity = [train_parity(torch, dev, arch) for arch in TRAIN_PARITY_ARCHS]
    micro = train_microbatch(torch, dev)
    falls = train_loss_falls(torch, dev)
    full = train_full_width(torch, dev)
    launches = total_launches(counters)
    check(sum(launches.values()) == 0,
          f"train: kernels launched while training: {launches}")
    emit(phase="train", parity=parity, microbatch=micro, loss_falls=falls,
         full_width=full, kernel_launches=launches,
         kernel_launches_note="0 of every kernel: training runs the plain "
         "path under autograd (checked)")
    return sum(launches.values())


# ---------------------------------------------------------------------------
# 13. the dry run: every combo's rank-0 shard on the card
# ---------------------------------------------------------------------------

DRYRUN_FLOPS_ARCH = "stablelm-1.6b"   # the step run on meta, FLOPs counted
DRYRUN_TOP = 5                        # largest combos printed


def phase_dryrun(torch, dev):
    """Phase 13 (module docstring).  Returns the kernel launches across
    it, which must be 0."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import MESHES, record
    from repro_torch.launch.specs import materialize_shard

    counters = all_launch_counters()
    for ops in counters.values():
        ops.reset_launches()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # split every block at its request: memory_allocated() then grows by
    # each tensor's bytes rounded up to 512 and no more
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    rows, flops, cache, t_spec, t_mat = [], {}, {}, 0.0, 0.0
    try:
        for mesh_kind in MESHES:
            for arch in ARCHS:
                for shape in SHAPES:
                    t0 = time.perf_counter()
                    rec, spec = record(arch, shape, mesh_kind,
                                       flops=arch == DRYRUN_FLOPS_ARCH,
                                       flops_cache=cache)
                    t_spec += time.perf_counter() - t0
                    check(rec["ok"], f"dryrun: {arch} {shape} {mesh_kind}: "
                          f"{rec.get('error')}")
                    want = rec["argument_bytes_allocated"]
                    check(rec["fits_hbm"],
                          f"dryrun: {arch} {shape} {mesh_kind}: "
                          f"{rec['argument_bytes_per_device']} bytes")
                    if "flops" in rec:
                        flops[shape] = rec["flops"]
                    t0 = time.perf_counter()
                    shard = materialize_shard(spec, device=dev)
                    torch.cuda.synchronize()
                    got = shard.allocated
                    del shard
                    t_mat += time.perf_counter() - t0
                    check(got == want,
                          f"dryrun: {arch} {shape} {mesh_kind}: rank 0's "
                          f"shard grew the card's allocation by {got} "
                          f"bytes, predicted {want}")
                    rows.append((rec["argument_bytes_per_device"], arch,
                                 shape, mesh_kind, rec["n_state_tensors"],
                                 got))
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    launches = total_launches(counters)
    check(sum(launches.values()) == 0,
          f"dryrun: kernels launched: {launches}")
    check(len(rows) == len(MESHES) * len(ARCHS) * len(SHAPES)
          and len(flops) == len(SHAPES),
          f"dryrun: {len(rows)} combos, FLOPs of {sorted(flops)}")
    top = sorted(rows, reverse=True)[:DRYRUN_TOP]
    emit(phase="dryrun", combos=len(rows),
         all_allocations_equal_prediction=True,
         largest=[dict(arch=a, shape=s, mesh=m,
                       argument_bytes_per_device=b, gb=b / 1e9,
                       allocated_bytes=g, tensors=n)
                  for b, a, s, m, n, g in top],
         bytes_per_device={f"{a} {s} {m}": b
                           for b, a, s, m, _, _ in rows},
         stablelm_flops=flops, spec_seconds=t_spec,
         materialize_seconds=t_mat, kernel_launches=launches)
    return sum(launches.values())


# ---------------------------------------------------------------------------
# 13b. the dry run's sharded step: estimate on the host, then the card
# ---------------------------------------------------------------------------

DRYRUN_SHARDED = (("stablelm-1.6b", "train_4k"), ("stablelm-1.6b", "decode_32k"))
DRYRUN_SHARDED_RTOL = 0.05          # card peak against the estimate ...
DRYRUN_SHARDED_SLACK = 64 << 20     # ... plus this many bytes


def phase_dryrun_sharded(torch, dev):
    """Phase 13b (module docstring).  Returns the kernel launches across
    it, which must be 0."""
    from repro_torch.launch.dryrun import sharded_step
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_spec

    counters = all_launch_counters()
    for ops in counters.values():
        ops.reset_launches()
    # cuBLAS's workspace, allocated at a handle's first product, outside
    # the measured step
    a = torch.ones(64, 64, device=dev, requires_grad=True)
    (a @ a).sum().backward()
    (a.detach().bfloat16() @ a.detach().bfloat16()).sum().item()
    del a
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    rows = []
    try:
        for arch, shape in DRYRUN_SHARDED:
            spec = build_spec(arch, shape, make_production_mesh())
            est = sharded_step(spec, "pod", "cpu")
            card = sharded_step(spec, "pod", "cuda")
            del spec
            gc.collect()
            torch.cuda.empty_cache()
            want, got = est["temp_size_in_bytes"], card["device_temp_bytes"]
            rows.append(dict(
                arch=arch, shape=shape, mesh="pod",
                estimate_temp_bytes=want, card_peak_bytes=got,
                card_tracked_temp_bytes=card["temp_size_in_bytes"],
                rel_err=(got - want) / want,
                output_bytes=est["output_size_in_bytes"],
                collective_counts=est["collective_counts"],
                collectives=est["collectives"],
                card_collective_counts=card["collective_counts"],
                card_collectives=card["collectives"],
                estimate_seconds=est["sharded_s"],
                card_seconds=card["sharded_s"]))
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    emit(phase="dryrun_sharded_rows", combos=rows)
    for r in rows:
        name = f"dryrun_sharded: {r['arch']} {r['shape']}"
        want, got = r["estimate_temp_bytes"], r["card_peak_bytes"]
        check(abs(got - want) <= DRYRUN_SHARDED_RTOL * want
              + DRYRUN_SHARDED_SLACK,
              f"{name}: the card's peak grew by {got} bytes, estimated {want}")
        check(r["card_collective_counts"] == r["collective_counts"]
              and r["card_collectives"] == r["collectives"],
              f"{name}: the card's collectives differ from the estimate's")
    launches = total_launches(counters)
    check(sum(launches.values()) == 0,
          f"dryrun_sharded: kernels launched: {launches}")
    emit(phase="dryrun_sharded", combos=rows, rtol=DRYRUN_SHARDED_RTOL,
         slack_bytes=DRYRUN_SHARDED_SLACK, collectives_equal=True,
         kernel_launches=launches)
    return sum(launches.values())



# ---------------------------------------------------------------------------
# 14. sync_free: the lint's host-sync rule held on the card
# ---------------------------------------------------------------------------

SYNC_FREE_REPS = 5   # counted calls of each function, after one warm call
# the scale runs' width (N arrived, W, B) with K = 2 classes; N is cut from
# their 100,000 to 10,000 (a cut in depth: the window and batch are theirs)
SYNC_FREE_SIM = (10_000, 4096, 16)
SYNC_FREE_DECODE = ("stablelm-1.6b", 2, 37)   # arch, layers, prompt tokens


def count_syncs(torch, fn):
    """(result, syncs, seconds) of one call of `fn` under
    `torch.cuda.set_sync_debug_mode("warn")`: the warnings that name a
    synchronizing operation, and the seconds to the end of its device
    work."""
    import warnings

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return out, syncs, time.perf_counter() - t0


class CountedCall:
    """`fn`, counted where its caller calls it: the first call runs warm,
    the next SYNC_FREE_REPS each under `count_syncs`, any later one
    plainly."""

    def __init__(self, torch, fn):
        self.torch, self.fn = torch, fn
        self.calls, self.syncs, self.seconds = 0, 0, 0.0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if not 1 < self.calls <= 1 + SYNC_FREE_REPS:
            return self.fn(*args, **kwargs)
        out, n, secs = count_syncs(self.torch,
                                   lambda: self.fn(*args, **kwargs))
        self.syncs += n
        self.seconds += secs
        return out


def sync_free_sim(torch, dev, patch):
    """The windowed engine at SYNC_FREE_SIM, every request arrived at t =
    0, for 1 + SYNC_FREE_REPS ticks, with `patch` (a name of
    `repro_torch.sim.engine`: `sim_tick`, or `schedule_batch` as the
    tick calls it) counted.  Returns (counted call, sched_score_topb
    launches)."""
    from repro_torch.core.policy import strategy
    from repro_torch.core.types import COMPLETED
    from repro_torch.kernels.sched_score import ops
    from repro_torch.sim import (SimConfig, WorkloadConfig, default_physics,
                                 engine, generate, run_sim)

    n, w, b = SYNC_FREE_SIM
    wl = WorkloadConfig(n_requests=n, mix="balanced", congestion="high",
                        arrival_scale=n / 160, class_map="paper2")
    batch, jitter = generate(wl, torch.Generator().manual_seed(0),
                             device=dev)
    batch = batch._replace(arrival_ms=torch.zeros_like(batch.arrival_ms))
    counted = CountedCall(torch, getattr(engine, patch))
    setattr(engine, patch, counted)
    ops.reset_launches()
    try:
        final = run_sim(strategy("final_adrr_olc"), batch, jitter,
                        default_physics(),
                        SimConfig(n_ticks=1 + SYNC_FREE_REPS, k_slots=b,
                                  window=w), device=dev)
    finally:
        setattr(engine, patch, counted.fn)
    check(bool((final.req.status == COMPLETED).any()),
          f"sync_free: nothing completed in the {patch} run")
    return counted, ops.LAUNCHES["sched_score_topb"]


def sync_free_session(torch, dev, patch):
    """A `ClientSession` at SYNC_FREE_SIM's width over `MockProvider`
    (`scale_session`), polled 1 + SYNC_FREE_REPS times with `patch`
    counted: the `_fused_tick` the poll calls (the poll's designed syncs
    lie outside it), or the whole `poll`, whose summary pull the
    counter must count once a poll (its check on the real path).
    Returns (counted call, sched_score_topb launches)."""
    from repro_torch.client import session as session_mod
    from repro_torch.kernels.sched_score import ops

    n, w, b = SYNC_FREE_SIM
    sess = scale_session(torch, dev, n, w, b)
    owner = sess if patch == "poll" else session_mod
    counted = CountedCall(torch, getattr(owner, patch))
    setattr(owner, patch, counted)
    ops.reset_launches()
    try:
        for _ in range(1 + SYNC_FREE_REPS):
            sess.poll()
    finally:
        setattr(owner, patch, counted.fn)
    check(sess.stats.n_admitted > 0, "sync_free: the session admitted "
          "nothing")
    if patch == "poll":
        check(counted.syncs >= SYNC_FREE_REPS,
              f"sync_free: {SYNC_FREE_REPS} polls counted {counted.syncs} "
              f"syncs; each pulls its summary")
    return counted, ops.LAUNCHES["sched_score_topb"]


def sync_free_decode(torch, dev):
    """`decode_step` at SYNC_FREE_DECODE (published width, bf16, depth
    cut), after a seeded prefill, 1 + SYNC_FREE_REPS steps.  Returns
    (counted call, decode_attention launches)."""
    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models import decode_step, init_model, prefill

    arch, layers, s = SYNC_FREE_DECODE
    cfg = dataclasses.replace(get(arch), n_layers=layers)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    prompt = torch.randint(0, cfg.vocab, (1, s),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    logits, caches = prefill(model, prompt, s + 1 + SYNC_FREE_REPS)
    counted = CountedCall(torch, decode_step)
    ops.reset_launches()
    for i in range(1 + SYNC_FREE_REPS):
        tok = logits[:, -1:].argmax(-1)
        logits, caches = counted(model, tok, s + i, caches)
    check(bool(torch.isfinite(logits).all()), "sync_free: decode_step "
          "gave non-finite logits")
    launches = ops.LAUNCHES["decode_attention"]
    del model, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counted, launches


# each manifest function, by its qualified name: how the phase drives it
SYNC_FREE_RUNS = {
    "repro_torch.sim.engine.sim_tick":
        lambda torch, dev: sync_free_sim(torch, dev, "sim_tick"),
    "repro_torch.core.scheduler.schedule_batch":
        lambda torch, dev: sync_free_sim(torch, dev, "schedule_batch"),
    "repro_torch.client.session._fused_tick":
        lambda torch, dev: sync_free_session(torch, dev, "_fused_tick"),
    "repro_torch.client.session.ClientSession.poll":
        lambda torch, dev: sync_free_session(torch, dev, "poll"),
    "repro_torch.models.model.decode_step": sync_free_decode,
}
SYNC_FREE_KERNEL = {"repro_torch.models.model.decode_step": "decode_attention"}


def phase_sync_free(torch, dev):
    """Phase 14 (module docstring).  Returns the launches by kernel."""
    from repro_torch.analysis.lint import build_project
    from repro_torch.analysis.rules.rpl003_hostsync import sites_of

    t0 = time.perf_counter()
    project = build_project(ROOT, [ROOT / "src" / "repro_torch"])
    man = project.manifest
    static = {name: [f"{f.path}:{f.line}" for f in sites_of(project, name)]
              for name in (*man.sync_free, *man.capture_candidates)}
    lint_s = time.perf_counter() - t0
    missing = set(static) - set(SYNC_FREE_RUNS)
    check(not missing, f"sync_free: no run for manifest functions "
          f"{sorted(missing)}")
    # the counter itself: a read-back must count
    _, control, _ = count_syncs(
        torch, lambda: torch.ones(4, device=dev).sum().item())
    check(control >= 1, "sync_free: `.item()` counted no sync; the "
          "runtime count cannot be trusted")
    rows, launches = [], {"sched_score_topb": 0, "decode_attention": 0}
    for name, sites in static.items():
        counted, n = SYNC_FREE_RUNS[name](torch, dev)
        kernel = SYNC_FREE_KERNEL.get(name, "sched_score_topb")
        launches[kernel] += n
        kind = "sync-free" if name in man.sync_free else "capture-candidate"
        rows.append(dict(function=name, kind=kind, static_sites=sites,
                         calls=counted.calls, counted_calls=SYNC_FREE_REPS,
                         runtime_syncs=counted.syncs,
                         seconds=counted.seconds, kernel=kernel,
                         launches=n))
        check(counted.calls == 1 + SYNC_FREE_REPS,
              f"sync_free: {name} ran {counted.calls} times, want "
              f"{1 + SYNC_FREE_REPS}")
        check(n > 0, f"sync_free: {name} launched no {kernel}")
        if kind == "sync-free":
            check(not sites, f"sync_free: the lint finds host syncs in "
                  f"sync-free {name}: {sites}")
            check(counted.syncs == 0,
                  f"sync_free: sync-free {name} synced {counted.syncs} "
                  f"times in {SYNC_FREE_REPS} calls on the card")
        else:
            check(sites, f"sync_free: the lint finds no host sync in "
                  f"capture candidate {name}; it belongs in sync-free")
    for row in rows:
        emit(phase="sync_free_function", **row)
    emit(phase="sync_free", functions=len(rows), reps=SYNC_FREE_REPS,
         control_syncs=control, lint_seconds=lint_s,
         n_arrived=SYNC_FREE_SIM[0], window=SYNC_FREE_SIM[1],
         max_grants=SYNC_FREE_SIM[2], decode=SYNC_FREE_DECODE,
         kernel_launches=launches)
    return launches

TRACE_STEPS = 8   # decode steps traced with torch.profiler


def trace_decode(torch, model, decode_step, prefill, sc, prompt, dev,
                 prefix_embeds=None):
    """Device work of TRACE_STEPS decode steps after `prompt` (and
    `prefix_embeds`): kernels a step, device-busy ms a step, wall ms a
    step and the idle share."""
    x = torch.from_numpy(prompt[None]).to(dev)
    _, caches = prefill(model, x, sc.max_seq, prefix_embeds=prefix_embeds)
    tok = x[:, -1:]
    pos = x.shape[1] + (0 if prefix_embeds is None else
                        prefix_embeds.shape[1])
    # not traced: warms the path
    _, caches = decode_step(model, tok, pos, caches)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    for i in range(TRACE_STEPS):
        _, caches = decode_step(model, tok, pos + 1 + i, caches)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRACE_STEPS
    prof.stop()
    busy_us, n_ops, per_name = device_activity(torch, prof)
    check(n_ops > 0, "serve: the decode trace shows no device work")
    busy_ms = busy_us / 1e3 / TRACE_STEPS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(steps=TRACE_STEPS, prompt=len(prompt),
                device_ops_per_step=n_ops / TRACE_STEPS,
                device_busy_ms_per_step=busy_ms,
                traced_wall_ms_per_step=wall_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                top_device_us_per_step=[[k[:60], us / TRACE_STEPS]
                                        for k, us in top])


if __name__ == "__main__":
    main()
