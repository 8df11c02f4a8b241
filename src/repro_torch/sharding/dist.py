"""Live meshes: the placements of `repro_torch.sharding.rules` as
`torch.distributed.tensor.DTensor`s.

The reference's dry run lays its production meshes over 512 forced host
devices (`jax.make_mesh`) and lets XLA's SPMD partitioner compile each
step for one device.  The port runs rank 0's share of the step itself,
as a DTensor program:

  * `fake_world(n)` starts a process group of `n` ranks in which this
    process is rank 0 and no collective moves any data: the `fake`
    backend of torch's own test utilities
    (`torch.testing._internal.distributed.fake_pg`, which ships with
    torch and registers the backend when imported; it wraps
    `torch._C._distributed_c10d.FakeProcessGroup`).  A collective's
    output has the right shape and dtype and undefined values, so a
    step under it shows the shapes, the bytes and the collectives of
    rank 0, never its numbers.
  * `device_mesh` lays a device-free `Mesh` over the group
    (`init_device_mesh`, the same shape and axis names).
  * `placements` turns a `NamedSharding` into one `Shard(d)` or
    `Replicate()` per mesh dimension, `distribute` a tree of tensors
    into DTensors.
  * `CollectiveCounter` counts the collectives a step runs on this
    rank (the `_c10d_functional` and `_dtensor` ops DTensor lowers its
    redistributions to) and their bytes under the reference's keys and
    multipliers (`repro.launch.dryrun.MULT`: an all-reduce counts twice
    its output, every other collective once).
  * `LiveBytes` tracks the rank's live local storages and their peak.

The model's layers take a sharded path only when their input is a
DTensor, so every unsharded path runs as before.  There the layouts
are fixed by the port, on each rank's local slices (`local_map`),
rather than left to DTensor's choice of strategy: `gathered(w)`
all-gathers a parameter's FSDP axes before a layer uses it (ZeRO-3,
what GSPMD does with a weight whose `embed` dimension is split over
the batch axes), `dense` is column- or row-parallel by the weight's
split, `embed` looks tokens up in a vocabulary-split table and
`vocab_nll` takes the loss over vocabulary-split logits without
gathering them; the attention, the SSM mixer and the MoE lay out their
own (`repro_torch.models`).  `repro_torch.sharding.rules.constrain`
pins an activation's placement.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Mapping

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed import _functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.rules import (
    DEFAULT_PARAM_RULES,
    Mesh,
    NamedSharding,
    _flat,
)

# the mesh axes a parameter's `embed` dimension is split over: all-
# gathered before use, reduce-scattered in the backward pass
FSDP_AXES = _flat(DEFAULT_PARAM_RULES["embed"])

# collective -> traffic multiplier, the reference's `MULT` (an all-reduce
# is modelled ring-style as a reduce-scatter plus an all-gather)
MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
        "all-to-all": 1.0, "collective-permute": 1.0}


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of `world_size` ranks over the `fake` backend,
    this process being `rank`; torn down on exit.  Refuses to start
    inside another process group."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group already exists")
    import torch.testing._internal.distributed.fake_pg as fake_pg

    dist.init_process_group("fake", rank=rank, world_size=world_size,
                            store=fake_pg.FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """`mesh` over the current process group, on `device_type`."""
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)


def mesh_of(dmesh) -> Mesh:
    """The device-free `Mesh` of a `DeviceMesh`."""
    return Mesh(tuple(dmesh.shape), tuple(dmesh.mesh_dim_names))


def placements(sharding: NamedSharding, ndim: int) -> tuple:
    """One placement per mesh dimension: `Shard(d)` where tensor dim d
    is split over that mesh axis (a dim split over several axes, as
    `("pod", "data")`, takes `Shard(d)` on each, in the spec's order),
    else `Replicate()`."""
    names = sharding.mesh.axis_names
    out: list[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(sharding.spec[:ndim]):
        for a in _flat(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _local(t: torch.Tensor, sh: NamedSharding, dmesh,
           device=None) -> torch.Tensor:
    """This rank's slice of `t`: for a tensor on `meta`, a new one of
    the local shape on `device` (the mesh's by default; `meta` keeps
    it unallocated), uninitialised unless it holds integers; otherwise
    a copy of the slice."""
    if t.is_meta:  # integers (token ids) zeroed: a valid index
        new = torch.empty if t.dtype.is_floating_point else torch.zeros
        return new(sh.local_shape(t.shape), dtype=t.dtype,
                   device=device or dmesh.device_type)
    return narrow(t, placements(sh, t.dim()), dmesh).clone(
        memory_format=torch.contiguous_format)


def narrow(t: torch.Tensor, pl: tuple, dmesh, skip=()) -> torch.Tensor:
    """This rank's slice (a view) of the whole tensor `t` placed by
    `pl`, leaving the tensor dims in `skip` whole.  A dim split over
    several mesh axes is split by the first (slowest) one first."""
    coord = dmesh.get_coordinate()
    for d in range(t.dim()):
        if d in skip:
            continue
        n, i = 1, 0
        for k, p in enumerate(pl):
            if p.is_shard(d):
                n, i = n * dmesh.shape[k], i * dmesh.shape[k] + coord[k]
        if n > 1:
            step = t.shape[d] // n
            t = t.narrow(d, i * step, step)
    return t


def whole(w: DTensor) -> DTensor:
    """`w` replicated on every rank (all-gathered where split)."""
    pl = (Replicate(),) * w.device_mesh.ndim
    return w if tuple(w.placements) == pl else w.redistribute(
        w.device_mesh, pl)


def to_dtensor(t: torch.Tensor, sh: NamedSharding, dmesh,
               device=None) -> DTensor:
    """`t` (the global tensor, or its shape and dtype on `meta`) as a
    DTensor placed by `sh`, built from this rank's local slice (on
    `device`, for a `meta` `t`)."""
    pl = placements(sh, t.dim())
    local = _local(t, sh, dmesh, device)
    return DTensor.from_local(local, dmesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(tree: Any, shardings: Any, dmesh, device=None) -> Any:
    """A tree of tensors (dicts, lists, tuples and NamedTuples of them;
    None and non-tensors pass through) as DTensors, each built from
    this rank's local slice of its placement in `shardings` (a tree of
    the same structure)."""
    if isinstance(tree, torch.Tensor):
        return to_dtensor(tree, shardings, dmesh, device)
    if isinstance(tree, Mapping):
        return {k: distribute(v, shardings[k], dmesh, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [distribute(v, s, dmesh, device)
                 for v, s in zip(tree, shardings, strict=True)]
        return (type(tree)(*parts) if hasattr(tree, "_fields")
                else type(tree)(parts))
    return tree


def distribute_module(module: torch.nn.Module, shardings: Mapping,
                      dmesh, device=None) -> torch.nn.Module:
    """Replace each parameter of `module` (by `named_parameters` name)
    with a DTensor parameter placed by `shardings[name]`, in place."""
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = module.get_submodule(owner)
        setattr(mod, attr, torch.nn.Parameter(
            to_dtensor(p.detach(), shardings[name], dmesh, device),
            requires_grad=p.requires_grad))
    return module


def gathered(w):
    """A parameter as a layer uses it: on a DTensor, every mesh axis of
    FSDP_AXES that splits it all-gathered (its tensor-parallel split
    kept); a plain tensor unchanged."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in FSDP_AXES and p.is_shard() else p
               for n, p in zip(names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


# --- collectives ------------------------------------------------------------

def _collective_kinds() -> dict:
    ops = torch.ops._c10d_functional
    kinds = {ops.all_reduce: "all-reduce",
             ops.all_reduce_: "all-reduce",
             ops.all_reduce_coalesced: "all-reduce",
             ops.all_gather_into_tensor: "all-gather",
             ops.all_gather_into_tensor_coalesced: "all-gather",
             ops.reduce_scatter_tensor: "reduce-scatter",
             ops.reduce_scatter_tensor_coalesced: "reduce-scatter",
             ops.all_to_all_single: "all-to-all",
             ops.broadcast: "collective-permute"}
    if hasattr(torch.ops, "_dtensor") and hasattr(torch.ops._dtensor,
                                                  "shard_dim_alltoall"):
        kinds[torch.ops._dtensor.shard_dim_alltoall] = "all-to-all"
    return kinds


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    return sum(_out_bytes(o) for o in out)


class CollectiveCounter(TorchDispatchMode):
    """Counts, on this rank, every collective the ops run inside it
    launch, and the bytes of each one's output (the shape the
    reference's HLO parse reads).  DTensor ops are let through first,
    so their redistributions are seen as the collectives they lower
    to."""

    def __init__(self):
        super().__init__()
        self.kinds = _collective_kinds()
        self.counts = {k: 0 for k in MULT}
        self.bytes = {k: 0 for k in MULT}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = self.kinds.get(func.overloadpacket)
        if kind is not None:
            self.counts[kind] += 1
            self.bytes[kind] += _out_bytes(out)
        return out

    def collectives(self) -> dict:
        """Bytes under the reference's keys, each times its multiplier,
        and their `total`."""
        out = {k: float(self.bytes[k] * MULT[k]) for k in MULT}
        out["total"] = sum(out.values())
        return out


# --- placements of activations ---------------------------------------------

def axis_size(dmesh, name: str) -> int:
    """The size of mesh axis `name` (1 where the mesh has none)."""
    names = dmesh.mesh_dim_names
    return dmesh.shape[names.index(name)] if name in names else 1


def axis_rank(dmesh, name: str) -> int:
    """This rank's coordinate on mesh axis `name` (0 where none)."""
    names = dmesh.mesh_dim_names
    return dmesh.get_local_rank(name) if name in names else 0


def batch_placements(x: DTensor) -> tuple:
    """`x`'s split of its batch (dimension 0): `Shard(0)` on the mesh
    axes that split it, `Replicate()` on every other."""
    return tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in x.placements)


def on_axis(pl: tuple, dmesh, name: str, p) -> tuple:
    """`pl` with its entry for mesh axis `name` set to `p`."""
    names = dmesh.mesh_dim_names
    if name not in names:
        return tuple(pl)
    out = list(pl)
    out[names.index(name)] = p
    return tuple(out)


def like_batch(x: DTensor, local: torch.Tensor, shape) -> DTensor:
    """`local`, a tensor whose dimension 0 is this rank's rows of `x`'s
    batch, as a DTensor of global `shape` split as `x`'s batch is."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, x.device_mesh, batch_placements(x),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def all_reduce(t: torch.Tensor, op: str, dmesh, name) -> torch.Tensor:
    """A functional all-reduce of a local tensor over mesh axis `name`
    (the identity where the mesh has no such axis, or `name` is None,
    or the axis has size 1)."""
    if axis_size(dmesh, name) == 1:
        return t
    out = funcol.all_reduce(t, op, (dmesh, dmesh.mesh_dim_names.index(name)))
    return funcol.wait_tensor(out) if hasattr(out, "wait") else out


def dense(x: DTensor, w: DTensor, b=None) -> DTensor:
    """`x @ w (+ b)` on each rank's slices, the weight's FSDP axes
    gathered first.  Per mesh axis: x's batch split is kept where it
    has one (the weight whole there, its gradient a partial sum over
    the axis); where the weight splits its output dim (column-parallel)
    x is whole and y comes out split likewise; where it splits its input
    dim (row-parallel) x comes in split on its last dim and y is a
    partial sum, reduced where a later op needs it (the bias is added
    after that reduction).  The layout is fixed here, not left to
    DTensor's choice of strategy, which may split the sequence or all-
    gather the batch of a 3-D product's backward."""
    w = gathered(w)
    last = x.dim() - 1
    xb = batch_placements(x)
    x_in, x_grad, w_grad, out = [], [], [], []
    for pb, pw in zip(xb, w.placements):
        if pb.is_shard():                  # a batch axis
            x_in.append(pb), x_grad.append(pb)
            w_grad.append(Partial()), out.append(pb)
        elif pw.is_shard(1):               # column-parallel
            x_in.append(Replicate()), x_grad.append(Partial())
            w_grad.append(pw), out.append(Shard(last))
        elif pw.is_shard(0):               # row-parallel
            x_in.append(Shard(last)), x_grad.append(Shard(last))
            w_grad.append(pw), out.append(Partial())
        else:
            x_in.append(Replicate()), x_grad.append(Replicate())
            w_grad.append(Replicate()), out.append(Replicate())
    partial = any(p.is_partial() for p in out)
    args, in_pl, grad_pl = [x, w], [tuple(x_in), tuple(w.placements)], \
        [tuple(x_grad), tuple(w_grad)]
    if b is not None and not partial:
        b = gathered(b)
        args.append(b)
        in_pl.append(tuple(b.placements))
        grad_pl.append(tuple(Partial() if pb.is_shard() else p
                             for pb, p in zip(xb, b.placements)))

    def mm(x, w, b=None):
        y = x @ w
        return y if b is None else y + b

    y = local_map(mm, out_placements=list(out), in_placements=tuple(in_pl),
                  in_grad_placements=tuple(grad_pl), device_mesh=x.device_mesh,
                  redistribute_inputs=True)(*args)
    if b is not None and partial:
        y = y + gathered(b)
    return y


def embed(tokens: DTensor, w: DTensor) -> DTensor:
    """`w[tokens]` on each rank's slices, the table's FSDP axes gathered
    first.  Where the table's rows (the vocabulary) are split over an
    axis, each rank looks up the tokens in its own rows and gives zeros
    for the rest: a partial sum over the axis, exact once reduced (one
    rank adds the row, the others add zeros)."""
    w = gathered(w)
    dm = tokens.device_mesh
    tb = batch_placements(tokens)
    split = [i for i, p in enumerate(w.placements) if p.is_shard(0)]
    if len(split) > 1:
        raise NotImplementedError("embed: vocabulary split over two axes")
    n_rows = w.to_local().shape[0]
    lo = dm.get_local_rank(split[0]) * n_rows if split else 0
    out = tuple(Partial() if i in split else p for i, p in enumerate(tb))
    w_grad = tuple(Partial() if pb.is_shard() else p
                   for pb, p in zip(tb, w.placements))

    def look(tok, w):
        if not split:
            return w[tok]
        idx = tok.long() - lo
        ok = (idx >= 0) & (idx < n_rows)
        rows = w[idx.clamp(0, n_rows - 1)]
        return rows.masked_fill(~ok[..., None], 0)

    return local_map(look, out_placements=list(out),
                     in_placements=(tb, tuple(w.placements)),
                     in_grad_placements=(tb, w_grad), device_mesh=dm,
                     redistribute_inputs=True)(tokens, w)


class _VocabNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over logits whose last dim (the
    vocabulary) is split over mesh axis `axis`, from this rank's
    columns alone: a max, a sum of exponentials and the label's logit,
    each all-reduced as (B, S) values.  The backward pass is local:
    softmax less the label's one-hot, on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, dmesh, axis: str):
        V = logits.shape[-1]
        m = all_reduce(logits.amax(-1), "max", dmesh, axis)
        s = all_reduce(torch.exp(logits - m[..., None]).sum(-1), "sum",
                       dmesh, axis)
        lse = m + torch.log(s)
        idx = labels.long() - lo
        ok = (idx >= 0) & (idx < V)
        idx = idx.clamp(0, V - 1)
        picked = logits.gather(-1, idx[..., None])[..., 0]
        picked = all_reduce(picked.masked_fill(~ok, 0), "sum", dmesh, axis)
        ctx.save_for_backward(logits, lse, idx, ok)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, ok = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, idx[..., None], -ok[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None, None


def vocab_nll(logits: DTensor, labels: DTensor) -> DTensor:
    """Per-token loss (B, S_txt) of DTensor logits (B, P + S_txt, V)
    against labels (B, S_txt) of their last S_txt positions (a prefix's
    P positions drop out), the vocabulary split over at most one mesh
    axis, without gathering the logits (`_VocabNLL` on each rank's
    slices); the loss comes out split as the batch is."""
    dm = logits.device_mesh
    last = logits.dim() - 1
    split = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    if len(split) > 1:
        raise NotImplementedError("vocab_nll: vocabulary split over two axes")
    axis = dm.mesh_dim_names[split[0]] if split else None
    n_cols = logits.to_local().shape[-1]
    lo = dm.get_local_rank(split[0]) * n_cols if split else 0
    bpl = batch_placements(logits)
    lpl = on_axis(bpl, dm, axis, Shard(last)) if axis else bpl

    P = logits.shape[1] - labels.shape[1]

    def nll(logits, labels):
        # sliced locally: no slice of a DTensor in the backward pass
        return _VocabNLL.apply(logits[:, P:], labels, lo, dm, axis)

    return local_map(nll, out_placements=list(bpl),
                     in_placements=(lpl, bpl), in_grad_placements=(lpl, bpl),
                     device_mesh=dm, redistribute_inputs=True)(logits, labels)


# --- memory -------------------------------------------------------------------

# the CUDA caching allocator's block: a storage takes a multiple of it
ALLOC_BLOCK = 512

# ops whose CUDA kernels hold a temporary of their own, made below the
# dispatcher so that no dispatch mode sees it: op name -> the input whose
# size the temporary has.  Softmax's backward forms grad * output first
# (`softmax_backward_cuda_out`): the 1,778,623,488 bytes of StableLM-
# 1.6B's train_4k peak on the card that the tracked storages missed
# (H100 80GB HBM3, 700 W).
CUDA_OP_TEMPS = {"aten::_softmax_backward_data": 0}


def _blocks(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


class LiveBytes(TorchDispatchMode):
    """The bytes of the live local storages, and their peak, while the
    ops inside run: every storage an op outputs is counted once, each
    rounded up to the allocator's block, until it is freed; an op of
    CUDA_OP_TEMPS adds its kernel's temporary to the peak while it runs.  DTensor
    ops are let through first, so it is their local tensors that are
    counted; the fake tensors DTensor's sharding propagation computes
    shapes with (under a `FakeTensorMode`) are not.  `track` counts a
    tensor made before."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = self.peak = 0

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = _blocks(st.nbytes())
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                self.track(t)
        i = CUDA_OP_TEMPS.get(func._schema.name)
        if i is not None:   # the kernel's own temporary, beside its output
            held = args[i].numel() * args[i].element_size()
            self.peak = max(self.peak, self.current + _blocks(held))
        return out


def all_gather(t: torch.Tensor, dmesh, name: str) -> torch.Tensor:
    """A functional all-gather of a local tensor over mesh axis `name`,
    the ranks' tensors stacked along a new dimension 0 in the axis's
    order."""
    if axis_size(dmesh, name) == 1:
        return t[None]
    out = funcol.all_gather_single(t[None], 0, (dmesh,
                                   dmesh.mesh_dim_names.index(name)))
    return funcol.wait_tensor(out) if hasattr(out, "wait") else out


def batch_axes(pl: tuple, dmesh) -> list[str]:
    """The mesh axes that split dimension 0 in placements `pl`, in mesh
    order (the order the rows of a split over several lie in)."""
    return [n for n, p in zip(dmesh.mesh_dim_names, pl) if p.is_shard(0)]
