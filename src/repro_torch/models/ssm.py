"""Mamba2 (state-space duality / SSD) mixer [arXiv:2405.21060].

Counterpart of `repro.models.ssm`.  Per head h (head dim P, state N),
with per-step log-decay la_t = -exp(A_log_h) * dt_t:

    state_t = exp(la_t) * state_{t-1} + dt_t * (x_t outer B_t)
    y_t     = C_t . state_t + D_h * x_t

Prefill splits the sequence into chunks of Q = min(chunk, S) steps: the
intra-chunk part (a masked, decay-weighted Q x Q product per (batch,
chunk, head)) runs through the `ssd_intra` kernel (`impl="kernel"`, the
main path) or its plain version (`impl="plain"`); the inter-chunk
recurrence carries chunk-final states with a loop over the chunks (the
reference's `lax.scan`).  Decode is the O(1)-state `ssd_step`.

Dtypes follow the reference: the SSD runs in float32 and casts y back
to x's dtype; the causal conv runs in the model dtype (taps in order,
bias last); dt goes through softplus in float32 as `jax.nn.softplus`
(`logaddexp(x, 0)`); D is applied in x's dtype in prefill and in
float32 inside `ssd_step`.  The conv state is kept in the model dtype,
the SSD state in float32, and `SSM.decode` updates both in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.common import Dense, param
from repro_torch.models.norms import Norm, rms_norm
from repro_torch.sharding import dist as sd

IMPLS = ("kernel", "plain")


class SSMState(NamedTuple):
    ssd: torch.Tensor    # (B, H, P, N) float32
    conv: torch.Tensor   # (B, conv_width - 1, d_inner + 2N), model dtype


def softplus(x):
    """`jax.nn.softplus`: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg: ModelConfig, h):
    """The fused input projection -> (z, x, B, C, dt)."""
    di, N = cfg.d_inner, cfg.ssm.d_state
    return torch.split(h, [di, di, N, N, cfg.n_ssm_heads], dim=-1)


def _causal_conv(w, b, u, state=None):
    """Depthwise causal conv, width W, in u's dtype.  u: (B, S, C); state:
    (B, W-1, C), the last W-1 inputs (zeros when None).  Returns
    (silu(y), new_state)."""
    W, S = w.shape[0], u.shape[1]
    if state is None:
        state = u.new_zeros((u.shape[0], W - 1, u.shape[2]))
    ext = torch.cat([state, u], dim=1)                       # (B, S+W-1, C)
    y = ext[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + ext[:, i:i + S] * w[i]
    y = y + b
    return F.silu(y), ext[:, -(W - 1):]


def chunk_inputs(x, Bm, Cm, dt, A, chunk: int):
    """The intra-chunk step's inputs, as `ssd_chunked` gives them to it:
    the sequence zero-padded to a multiple of Q = min(chunk, S) (dt = 0
    makes the padded steps exact no-ops for the state), cut into nc
    chunks and cast to float32, and the inclusive cumsum of the log-decay
    within each chunk.  Returns (xc (B,nc,Q,H,P), Bc, Cc (B,nc,Q,N),
    dtc, cum (B,nc,Q,H))."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_pad = -S % Q
    if S_pad:
        x, Bm, Cm, dt = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, S_pad))
                         for a in (x, Bm, Cm, dt))
    nc = (S + S_pad) // Q
    xc = x.reshape(Bsz, nc, Q, H, P).float().contiguous()
    Bc = Bm.reshape(Bsz, nc, Q, N).float().contiguous()
    Cc = Cm.reshape(Bsz, nc, Q, N).float().contiguous()
    dtc = dt.reshape(Bsz, nc, Q, H).float().contiguous()
    cum = torch.cumsum(-A * dtc, dim=2)                      # (B,nc,Q,H)
    return xc, Bc, Cc, dtc, cum


def ssd_chunked(x, Bm, Cm, dt, A, chunk: int, state0=None,
                impl: str = "kernel"):
    """Chunked SSD scan.

    x: (B,S,H,P); Bm/Cm: (B,S,N); dt: (B,S,H) (softplus'd, float32);
    A: (H,) positive decay rates; state0: (B,H,P,N) float32 or None.
    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) float32).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xc, Bc, Cc, dtc, cum = chunk_inputs(x, Bm, Cm, dt, A, chunk)
    nc = xc.shape[1]
    intra = ssd_ops.ssd_intra if impl == "kernel" else ssd_ref.ssd_intra_ref
    y_intra, chunk_state = intra(xc, Bc, Cc, dtc, cum)

    # inter-chunk recurrence: the state entering each chunk
    decay = torch.exp(cum[:, :, -1])                         # (B,nc,H)
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device) if state0 is None else state0)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = chunk_state[:, c] + decay[:, c, :, None, None] * state
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,N)

    # y_t += C_t . (exp(cum_t) * state entering the chunk)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(Bsz, -1, H, P)[:, :S].to(x.dtype)
    return y, state


def ssd_step(x, Bm, Cm, dt, A, D, state):
    """O(1) decode step.  x: (B,H,P); Bm/Cm: (B,N); dt: (B,H); A, D: (H,)
    float32; state: (B,H,P,N) float32.  Returns (y: (B,H,P) in x's
    dtype, new_state)."""
    xf = x.float()
    a = torch.exp(-A[None, :] * dt)                          # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xf, Bm.float())
    new_state = a[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    y = y + D[None, :, None] * xf
    return y.to(x.dtype), new_state


class SSM(nn.Module):
    """The full mixer: in_proj -> causal conv -> SSD -> gated RMSNorm ->
    out_proj.  Parameter names are the reference's (`in_proj.w`,
    `conv_w`, `conv_b`, `A_log`, `D`, `dt_bias`, `norm.scale`,
    `out_proj.w`); `A_log`, `D`, `dt_bias` and `conv_b` are set here as
    the reference's `ssm_init` sets them, `conv_w` and the projections
    are drawn by `init_model`."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        s = cfg.ssm
        d, di, N, H = cfg.d_model, cfg.d_inner, s.d_state, cfg.n_ssm_heads
        self.cfg = cfg
        conv_ch = di + 2 * N
        self.in_proj = Dense(d, 2 * di + 2 * N + H, False, dtype, device,
                             axes=("embed", "ssm_inner"))
        self.conv_w = param((s.conv_width, conv_ch), dtype, device)
        self.conv_w_scale = 1.0 / s.conv_width ** 0.5
        self.conv_b = param((conv_ch,), dtype, device, 0.0)
        self.A_log = param((H,), dtype, device)
        with torch.no_grad():
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, H, dtype=torch.float32, device=device)))
        self.D = param((H,), dtype, device, 1.0)
        self.dt_bias = param((H,), dtype, device, 0.0)
        self.norm = Norm(di, "rmsnorm", dtype, device, axis="ssm_inner")
        self.out_proj = Dense(di, d, False, dtype, device,
                              axes=("ssm_inner", "embed"))
        self.axes = {"conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",),
                     "A_log": (None,), "D": (None,), "dt_bias": (None,)}

    def _params(self) -> tuple:
        """The mixer's parameters between the two projections, in the
        order `_mix_in` and `_norm` take them."""
        return (self.conv_w, self.conv_b, self.A_log, self.dt_bias,
                self.D, self.norm.scale)

    def _mix_in(self, zx, conv_state, conv_w, conv_b, A_log, dt_bias):
        """The input projection's output through the conv and the
        softplus: (z, u, Bm, Cm, dt float32, A float32, new conv
        state)."""
        cfg = self.cfg
        di, N = cfg.d_inner, cfg.ssm.d_state
        z, u, Bm, Cm, dt = _split_proj(cfg, zx)
        conv_out, conv_state = _causal_conv(
            conv_w, conv_b, torch.cat([u, Bm, Cm], dim=-1), conv_state)
        u, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
        dt = softplus(dt.float() + dt_bias.float())
        A = torch.exp(A_log.float())
        return z, u, Bm, Cm, dt, A, conv_state

    def _norm(self, y, z, scale):
        return rms_norm(y * F.silu(z), scale, self.norm.eps)

    def _prefill_mix(self, zx, impl, conv_w, conv_b, A_log, dt_bias, D,
                     scale):
        """Prefill from the input projection's output to the gated
        norm's: (normed y, SSMState)."""
        cfg = self.cfg
        H, P = cfg.n_ssm_heads, cfg.ssm.head_dim
        B, S, _ = zx.shape
        z, u, Bm, Cm, dt, A, conv_state = self._mix_in(
            zx, None, conv_w, conv_b, A_log, dt_bias)
        u = u.reshape(B, S, H, P)
        y, ssd_state = ssd_chunked(u, Bm, Cm, dt, A, cfg.ssm.chunk,
                                   impl=impl)
        y = y + D.to(zx.dtype)[None, None, :, None] * u
        h = self._norm(y.reshape(B, S, cfg.d_inner), z, scale)
        # the conv state is a view of the whole padded input: copy it out
        return h, SSMState(ssd_state, conv_state.clone())

    def _decode_mix(self, zx, state: SSMState, conv_w, conv_b, A_log,
                    dt_bias, D, scale):
        """One step from the input projection's output to the gated
        norm's: (normed y, the new SSD state, the new conv state)."""
        cfg = self.cfg
        H, P = cfg.n_ssm_heads, cfg.ssm.head_dim
        B = zx.shape[0]
        z, u, Bm, Cm, dt, A, conv_state = self._mix_in(
            zx, state.conv, conv_w, conv_b, A_log, dt_bias)
        y, ssd_state = ssd_step(u[:, 0].reshape(B, H, P), Bm[:, 0],
                                Cm[:, 0], dt[:, 0], A, D.float(), state.ssd)
        return (self._norm(y.reshape(B, 1, cfg.d_inner), z, scale),
                ssd_state, conv_state)

    def prefill(self, x, impl: str = "kernel"):
        """x: (B, S, d_model), from zero state.  Returns (out,
        SSMState)."""
        if isinstance(x, DTensor):
            return self._prefill_sharded(x, impl)
        h, st = self._prefill_mix(self.in_proj(x), impl, *self._params())
        return self.out_proj(h), st

    def decode(self, x, state: SSMState):
        """x: (B, 1, d_model).  One step; `state` is updated in place and
        returned."""
        if isinstance(x, DTensor):
            return self._decode_sharded(x, state)
        h, ssd_state, conv_state = self._decode_mix(
            self.in_proj(x), state, *self._params())
        state.ssd.copy_(ssd_state)
        state.conv.copy_(conv_state)
        return self.out_proj(h), state

    # --- a sharded step: x a DTensor ------------------------------------
    # Each rank runs the whole mixer on its batch rows: the input
    # projection's columns and the mixer's parameters all-gathered over
    # the tensor-parallel axis (its split of the fused projection does
    # not fall on the z / x / B / C / dt boundaries), the output
    # projection row-parallel again.

    def _prefill_sharded(self, x, impl: str):
        dm = x.device_mesh
        bpl = sd.batch_placements(x)
        b_axes = sd.batch_axes(bpl, dm)
        params = [sd.whole(p) for p in self._params()]
        p_grad = tuple(Partial() if n in b_axes else Replicate()
                       for n in dm.mesh_dim_names)

        def mix(zx, *params):
            h, st = self._prefill_mix(zx, impl, *params)
            return h, st.ssd, st.conv

        h, ssd, conv = local_map(
            mix, out_placements=(bpl, bpl, bpl),
            in_placements=(bpl,) + (tuple(params[0].placements),) * 6,
            in_grad_placements=(bpl,) + (p_grad,) * 6, device_mesh=dm,
            redistribute_inputs=True)(self.in_proj(x), *params)
        return self.out_proj(h), SSMState(ssd, conv)

    def _decode_sharded(self, x, state: SSMState):
        """The state is split over the cache's batch axes and, on the
        tensor-parallel axis, over its channels: each rank reads it
        whole (all-gathered) and writes back its own slice."""
        dm = x.device_mesh
        spl, cpl = tuple(state.ssd.placements), tuple(state.conv.placements)
        bpl = sd.batch_placements(state.ssd)
        params = [sd.whole(p) for p in self._params()]
        repl = (Replicate(),) * dm.ndim

        def step(zx, ssd_all, conv_all, ssd_mine, conv_mine, *params):
            h, ssd_new, conv_new = self._decode_mix(
                zx, SSMState(ssd_all, conv_all), *params)
            ssd_mine.copy_(sd.narrow(ssd_new, spl, dm, skip=(0,)))
            conv_mine.copy_(sd.narrow(conv_new, cpl, dm, skip=(0,)))
            return h

        h = local_map(
            step, out_placements=list(bpl),
            in_placements=(bpl, bpl, bpl, spl, cpl) + (repl,) * 6,
            device_mesh=dm, redistribute_inputs=True)(
                self.in_proj(x), state.ssd, state.conv, state.ssd,
                state.conv, *params)
        return self.out_proj(h), state


# logical axes of a layer's SSM state, mapped by the activation rules
SSM_STATE_AXES = SSMState(
    ssd=("cache_batch", None, "ssm_inner", None),
    conv=("cache_batch", None, "ssm_inner"),
)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> SSMState:
    s = cfg.ssm
    return SSMState(
        torch.zeros((batch, cfg.n_ssm_heads, s.head_dim, s.d_state),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, s.conv_width - 1, cfg.d_inner + 2 * s.d_state),
                    dtype=dtype, device=device))
