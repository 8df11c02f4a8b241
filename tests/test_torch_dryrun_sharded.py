"""The dry run's sharded step, on the CPU.

* Placements: for every state leaf of the ten smoke configs x four
  shapes x both production meshes, `sharded_args`' DTensor has the local
  shape `NamedSharding.local_shape(..., rank=0)` gives (held against
  the reference's rules in `test_torch_dryrun.py`), and the local bytes
  sum to `shard_nbytes`.
* `constrain` is the identity on a plain tensor and gives a DTensor the
  placements of the activation rules.
* `CollectiveCounter`: a redistribute of known size yields its all-
  gather bytes; an all-reduce counts twice its output.
* A real four-rank run: four `gloo` ranks on a 2 x 2 (`data`, `model`)
  mesh run smoke StableLM's, Phi-3.5-MoE's (capacity drops in its
  prefill and train step), Mamba2's, Hymba's (5 heads: each `model`
  rank attends with its own share of them) and Nemotron-4's with one
  K/V head (each rank reads its q heads' part of the whole K/V) train
  step, prefill and decode step sharded, in float32; and smoke StableLM's
  and Phi-3.5-MoE's on two pods of two (2 x 2 x 1, `pod`, `data`,
  `model`: the batch split over both data axes, a decode cache over
  `data` alone, the MoE's capacity counted across both).  Against the port's
  unsharded step (itself held against the reference): loss, logits,
  caches and states within 1e-4 of the largest value (the sharded step
  sums its partial products in another order); updated parameters as
  in `test_torch_training.py` (Adam's first update is ~lr * sign(g), so
  at most 1% of the elements may differ by more than 1e-6 and none by
  more than 2 lr).  The collectives' counts and bytes of rank 0 under
  `fake_world(4)` equal those of the gloo run exactly.
* `sharded_step` and `record(..., sharded=True)` on a smoke config.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import SHAPES, TrainConfig
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.launch.dryrun import record, sharded_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    _batch_sharding,
    _cache_shardings,
    _params_shardings,
    build_spec,
    shard_nbytes,
    sharded_args,
    state_leaves,
)
from repro_torch.models import init_model, param_axes
from repro_torch.serving.engine import prefill_step, serve_step
from repro_torch.sharding import dist as sd
from repro_torch.sharding.rules import Mesh, NamedSharding, constrain
from repro_torch.training import init_train_state
from repro_torch.training.train_step import TrainState, train_step

torch.set_num_threads(2)

MESHES = ("pod", "multipod")
RTOL = 1e-4          # of the largest value: losses, logits, caches, states
PARAM_ATOL = 1e-6    # parameters: at most 1% of elements above it ...
PARAM_FRAC = 0.01    # ... and none above 2 lr


def smoke_cfg(arch, shape_name):
    cfg = get_smoke(arch)
    if shape_name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        cfg = cfg.with_sliding_window(64)
    return cfg


# --- placements ---------------------------------------------------------------

@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_equal_the_rules(arch, shape_name, mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    spec = build_spec(arch, shape_name, mesh,
                      cfg_override=smoke_cfg(arch, shape_name))
    with sd.fake_world(mesh.size):
        dm = sd.device_mesh(mesh, "cpu")
        args = sharded_args(spec, dm, "meta")
        shared = spec._replace(args=args)
        got = 0
        leaves = list(state_leaves(spec))
        for (name, t, sh), (name2, dt, _) in zip(
                leaves, state_leaves(shared), strict=True):
            assert name == name2 and isinstance(dt, DTensor), name
            local = dt.to_local()
            assert tuple(local.shape) == sh.local_shape(t.shape, 0), name
            assert tuple(dt.shape) == tuple(t.shape), name
            assert local.dtype == t.dtype, name
            got += local.numel() * local.element_size()
    assert got == shard_nbytes(spec)


def test_placements_split_a_dim_over_two_axes_in_spec_order():
    mesh = make_production_mesh(multi_pod=True)
    pl = sd.placements(NamedSharding(mesh, (("pod", "data"), "model")), 2)
    assert pl == (Shard(0), Shard(0), Shard(1))
    assert sd.placements(NamedSharding(mesh, (None,)), 1) == (Replicate(),) * 3


# --- constrain and the byte counter ----------------------------------------

def test_constrain_is_the_identity_on_a_plain_tensor():
    x = torch.randn(4, 3, 8)
    assert constrain(x, "batch", None, "vocab") is x


def test_constrain_gives_the_activation_rules_placements():
    mesh = make_production_mesh(multi_pod=True)
    with sd.fake_world(mesh.size):
        dm = sd.device_mesh(mesh, "cpu")
        x = DTensor.from_local(torch.empty(64, 8, 1024, device="meta"), dm,
                               (Replicate(),) * 3, run_check=False)
        y = constrain(x, "batch", None, "vocab")
        assert tuple(y.placements) == (Shard(0), Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 8, 64)
        z = constrain(y, "batch", None, None)
        assert tuple(z.placements) == (Shard(0), Shard(0), Replicate())


def test_counter_counts_all_gather_bytes_and_all_reduce_twice():
    from torch.distributed.tensor import Partial

    mesh = Mesh((4, 4), ("data", "model"))
    with sd.fake_world(mesh.size):
        dm = sd.device_mesh(mesh, "cpu")
        x = DTensor.from_local(torch.empty(8, 32, device="meta"), dm,
                               (Shard(0), Replicate()), run_check=False)
        with sd.CollectiveCounter() as cc:
            x.redistribute(dm, (Replicate(), Replicate()))
        assert cc.counts["all-gather"] == 1
        assert cc.collectives()["all-gather"] == 32 * 32 * 4
        p = DTensor.from_local(torch.empty(8, 32, device="meta"), dm,
                               (Replicate(), Partial()), run_check=False)
        with sd.CollectiveCounter() as cc:
            p.redistribute(dm, (Replicate(), Replicate()))
        assert cc.counts == {**{k: 0 for k in sd.MULT}, "all-reduce": 1}
        assert cc.collectives()["all-reduce"] == 2 * 8 * 32 * 4
        assert cc.collectives()["total"] == 2 * 8 * 32 * 4


def test_fake_world_refuses_a_second_group():
    with sd.fake_world(4):
        with pytest.raises(RuntimeError):
            with sd.fake_world(4):
                pass
    assert not dist.is_initialized()


# --- a real four-rank run -------------------------------------------------

# arch -> config fields changed from its smoke config
GLOO_CASES = {"stablelm-1.6b": {}, "phi3.5-moe-42b-a6.6b": {},
              "mamba2-780m": {}, "hymba-1.5b": {},
              "nemotron-4-340b": {"n_kv": 1}}
GLOO_MESH = Mesh((2, 2), ("data", "model"))
# two pods of two: the batch split over (pod, data), a decode cache's
# over data alone
GLOO_PODS = Mesh((2, 2, 1), ("pod", "data", "model"))
GLOO_MESHES = {"2x2": (GLOO_MESH, list(GLOO_CASES)),
               "2x2x1": (GLOO_PODS, ["stablelm-1.6b",
                                     "phi3.5-moe-42b-a6.6b"])}
B, S, MAX_SEQ = 4, 16, 24


def _f32(arch):
    return dataclasses.replace(get_smoke(arch), dtype="float32",
                               **GLOO_CASES[arch])


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [t for part in tree for t in _leaves(part)]


def _rel(a, b):
    a, b = _full(a).float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _count(fn):
    with implicit_replication(), sd.CollectiveCounter() as cc:
        out = fn()
    return out, {"counts": dict(cc.counts), "bytes": cc.collectives()}


def run_cases(mesh_name) -> dict:
    """Each arch's three steps sharded on the named mesh and unsharded:
    per (mesh, arch, step), the collectives of this rank and (with a
    real group) the errors against the unsharded step."""
    mesh, archs = GLOO_MESHES[mesh_name]
    dm = sd.device_mesh(mesh, "cpu")
    real = dist.get_backend() != "fake"
    out = {}
    rng = np.random.default_rng(0)
    for arch in archs:
        cfg = _f32(arch)
        model = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        psh = _params_shardings(param_axes(model), model, mesh)
        tok_sh = _batch_sharding(mesh, B)
        tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (B, S + 1),
                                               dtype=np.int32))
        batch = {"tokens": tokens[:, :-1].contiguous(),
                 "labels": tokens[:, 1:].contiguous()}

        # train
        tc = TrainConfig()
        plain = init_train_state(copy.deepcopy(model), tc, "cpu")
        _, m_plain = train_step(plain, batch, tc)
        mine = init_train_state(copy.deepcopy(model), tc, "cpu")
        opt_sh = type(mine.opt)(step=NamedSharding(mesh, ()),
                                master=psh, m=psh, v=psh)
        st = TrainState(sd.distribute_module(mine.model, psh, dm),
                        sd.distribute(mine.opt, opt_sh, dm))
        bt = sd.distribute(batch, {"tokens": tok_sh, "labels": tok_sh}, dm)
        (_, m_sh), coll = _count(lambda: train_step(st, bt, tc))
        res = {"coll": coll}
        if real:
            res["loss"] = _rel(m_sh["loss"], m_plain["loss"])
            want = dict(plain.model.named_parameters())
            diffs = [(_full(p.detach()) - want[k].detach()).abs().flatten()
                     for k, p in st.model.named_parameters()]
            d = torch.cat(diffs)
            res["param_max"] = float(d.max())
            res["param_frac"] = float((d > PARAM_ATOL).float().mean())
            res["lr"] = float(m_plain["lr"])
        out[(mesh_name, arch, "train")] = res

        # prefill, then decode from its caches
        logits, caches = prefill_step(model, batch["tokens"], MAX_SEQ,
                                      impl="plain")
        dmodel = sd.distribute_module(copy.deepcopy(model), psh, dm)
        dtok = sd.distribute(batch["tokens"], tok_sh, dm)
        (lg, cs), coll = _count(lambda: prefill_step(
            dmodel, dtok, MAX_SEQ, impl="plain"))
        res = {"coll": coll}
        if real:
            res["err"] = max([_rel(lg, logits)] + [
                _rel(a, b) for a, b in zip(_leaves(cs), _leaves(caches),
                                           strict=True)])
        out[(mesh_name, arch, "prefill")] = res

        csh = _cache_shardings(cfg, caches, mesh)
        dcaches = sd.distribute(caches, csh, dm)
        token = batch["labels"][:, -1:].contiguous()
        want_lg, want_c = serve_step(model, token, S, caches, impl="plain")
        dtoken = sd.distribute(token, tok_sh, dm)
        (lg, cs), coll = _count(lambda: serve_step(
            dmodel, dtoken, S, dcaches, impl="plain"))
        res = {"coll": coll}
        if real:
            res["err"] = max([_rel(lg, want_lg)] + [
                _rel(a, b) for a, b in zip(_leaves(cs), _leaves(want_c),
                                           strict=True)])
        out[(mesh_name, arch, "decode")] = res
    return out


def _all_cases() -> dict:
    return {k: v for m in GLOO_MESHES for k, v in run_cases(m).items()}


def _worker(rank, store_path, queue):
    """A gloo rank (rank 0 reports), or with rank None rank 0 of a
    `fake_world` of the same size."""
    torch.set_num_threads(1)
    if rank is None:
        with sd.fake_world(GLOO_MESH.size):
            queue.put(("fake", _all_cases()))
        return
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=GLOO_MESH.size)
    try:
        res = _all_cases()
        if rank == 0:
            queue.put(("gloo", res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(gloo results of rank 0, fake_world(4) results of rank 0), run
    in five spawned processes at once."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=_worker, args=(r, store, queue))
             for r in [*range(GLOO_MESH.size), None]]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=300) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return got["gloo"], got["fake"]


GLOO_KEYS = [(m, a, s) for m, (_, archs) in GLOO_MESHES.items()
             for a in archs for s in ("train", "prefill", "decode")]


@pytest.mark.parametrize("mesh_name,arch,step", GLOO_KEYS)
def test_four_gloo_ranks_equal_the_unsharded_step(four_ranks, mesh_name,
                                                  arch, step):
    gloo, fake = four_ranks
    res = gloo[(mesh_name, arch, step)]
    if step == "train":
        assert res["loss"] <= RTOL, res
        assert res["param_frac"] <= PARAM_FRAC, res
        assert res["param_max"] <= 2 * res["lr"] + PARAM_ATOL, res
    else:
        assert res["err"] <= RTOL, res
    assert sum(res["coll"]["counts"].values()) > 0
    assert fake[(mesh_name, arch, step)]["coll"] == res["coll"]


# --- the record ---------------------------------------------------------------

@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_record_adds_the_sharded_fields(shape_name):
    cfg = smoke_cfg("stablelm-1.6b", shape_name)
    rec, spec = record("stablelm-1.6b", shape_name, "multipod", flops=False,
                       cfg_override=cfg, sharded=True)
    assert rec["ok"], rec.get("traceback")
    assert rec["temp_size_in_bytes"] > 0
    assert rec["output_size_in_bytes"] > 0
    assert rec["bytes_per_device"] == (rec["argument_bytes_per_device"]
                                       + rec["temp_size_in_bytes"])
    assert rec["fits_hbm"] == (rec["bytes_per_device"] <= 80e9)
    coll = rec["collectives"]
    assert set(coll) == set(sd.MULT) | {"total"}
    assert coll["total"] == sum(coll[k] for k in sd.MULT) > 0
    assert rec["collective_counts"]["all-gather"] > 0
    assert not dist.is_initialized()
    if shape_name == "decode_32k":   # the same step again: the same numbers
        again = sharded_step(spec, "multipod")
        assert {k: again[k] for k in again if k != "sharded_s"} == {
            k: rec[k] for k in again if k != "sharded_s"}
