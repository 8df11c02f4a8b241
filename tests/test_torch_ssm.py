"""The port's SSD kernel and Mamba2 mixer against the JAX reference, on
the CPU.

Inputs are seeded numpy arrays handed to both packages in float32.

* Kernel: the port's `ssd_intra` wrapper (`repro_torch.kernels.ssd_scan`,
  which takes its plain version on CPU tensors) and the plain
  `ssd_intra_ref` are held against the reference's oracle
  `repro.kernels.ssd_scan.ref.ssd_intra_ref` and its Pallas kernel
  `repro.kernels.ssd_scan.ops.ssd_intra` (interpret mode on the CPU), on
  the shapes of `tests/test_kernels.py` `TestSSDScan`, a Q = 37 single
  chunk and a Hymba tile (N = 16).  Bound: `KERNEL_TOL`, 1e-4 absolute
  and relative, the reference's own bound for its kernel against its
  oracle (float32 sums over up to 128 terms in other orders).
* Rounding of the CUDA kernel's tensor-core products: the 3xTF32
  emulation `ssd_intra_3xtf32_ref` against the same oracle and Pallas
  kernel within the same `KERNEL_TOL`, on those shapes and on Mamba2's
  full chunk (Q 128, N 128, P 64, A up to 16, unit-normal B and C) under
  both of `chip_smoke.py`'s dt draws; one TF32 product alone misses it
  there, which is why the kernel splits every operand.
* Mixer: `ssd_chunked` (both impls, with and without an initial state,
  S on and off chunk boundaries), `ssd_step`, `_causal_conv`,
  `sinusoidal_embed`, softplus and the whole `SSM` mixer's prefill and
  decode against `repro.models.ssm`, within `MIXER_TOL` (2e-5 absolute
  and relative, as `tests/test_torch_models.py` holds its modules; the
  SSD's chunked sums reach 1e-4 relative where they cancel, so they
  keep `KERNEL_TOL`).  Streaming: a prefill of S tokens then one decode
  step equals a prefill of S + 1 tokens.

The CUDA kernel itself is held against the plain version on the card by
`chip_smoke.py` (phase `ssd_kernel`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as RefModelConfig
from repro.config import SSMConfig as RefSSMConfig
from repro.kernels.ssd_scan.ops import ssd_intra as jax_ssd_intra
from repro.kernels.ssd_scan.ref import ssd_intra_ref as jax_ssd_intra_ref
from repro.models import ssm as ref_ssm
from repro.models.rope import sinusoidal_embed as ref_sinusoidal_embed
from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_intra_3xtf32_ref,
                                              ssd_intra_ref, tf32_round)
from repro_torch.models import ssm
from repro_torch.models.rope import sinusoidal_embed

torch.set_num_threads(2)

KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
MIXER_TOL = dict(atol=2e-5, rtol=2e-5)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def intra_inputs(seed, B, nc, Q, H, P, N):
    """xc, Bc, Cc, dtc, cum as numpy float32, drawn as `TestSSDScan`
    draws them (cum from the decay rates within each chunk)."""
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((B, nc, Q, H, P)).astype(np.float32)
    Bc = (rng.standard_normal((B, nc, Q, N)) * 0.5).astype(np.float32)
    Cc = (rng.standard_normal((B, nc, Q, N)) * 0.5).astype(np.float32)
    dtc = np.logaddexp(rng.standard_normal((B, nc, Q, H)), 0).astype(
        np.float32)
    A = np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    cum = np.cumsum(-A * dtc, axis=2, dtype=np.float32)
    return xc, Bc, Cc, dtc, cum


INTRA_SHAPES = [
    (1, 2, 32, 2, 16, 16),
    (2, 4, 64, 4, 32, 32),
    (1, 1, 128, 8, 64, 128),   # mamba2-780m native tile
    (2, 3, 16, 5, 8, 24),      # odd head count
    (1, 1, 37, 3, 64, 128),    # a prompt shorter than the chunk
    (1, 2, 128, 5, 64, 16),    # hymba-1.5b tile (N = 16)
]


@pytest.mark.parametrize("B,nc,Q,H,P,N", INTRA_SHAPES)
def test_ssd_intra_matches_reference(B, nc, Q, H, P, N):
    arrs = intra_inputs(B * 1000 + Q, B, nc, Q, H, P, N)
    js = [jnp.asarray(a) for a in arrs]
    ts = [torch.from_numpy(a) for a in arrs]
    got = ssd_ops.ssd_intra(*ts)
    plain = ssd_intra_ref(*ts)
    assert got[0].shape == (B, nc, Q, H, P) and got[1].shape == (B, nc, H, P, N)
    assert got[0].dtype == got[1].dtype == torch.float32
    for name, want in (("oracle", jax_ssd_intra_ref(*js)),
                       ("pallas", jax_ssd_intra(*js))):
        for g, p, w, what in zip(got, plain, want, ("y_intra", "state")):
            np.testing.assert_allclose(np32(g), np32(w), **KERNEL_TOL,
                                       err_msg=f"{what} vs {name}")
            np.testing.assert_allclose(np32(p), np32(w), **KERNEL_TOL,
                                       err_msg=f"plain {what} vs {name}")


def mamba2_chunk_inputs(seed, dt_kind):
    """One Mamba2-780M chunk (Q 128, N 128, P 64) of 4 heads with A =
    1..16, unit-normal x, B and C, and dt drawn as `chip_smoke.py` phase
    ssd_kernel draws it: "init" softplus of a unit normal (fast decay),
    "published" log-uniform over Mamba2's [1e-3, 0.1] (slow decay, every
    step of the chunk counts)."""
    rng = np.random.default_rng(seed)
    Q, H, P, N = 128, 4, 64, 128
    xc = rng.standard_normal((1, 1, Q, H, P)).astype(np.float32)
    Bc = rng.standard_normal((1, 1, Q, N)).astype(np.float32)
    Cc = rng.standard_normal((1, 1, Q, N)).astype(np.float32)
    if dt_kind == "init":
        dtc = np.logaddexp(rng.standard_normal((1, 1, Q, H)), 0)
    else:
        dtc = np.exp(np.log(1e-3) + rng.random((1, 1, Q, H)) * np.log(1e2))
    dtc = dtc.astype(np.float32)
    A = np.linspace(1.0, 16.0, H, dtype=np.float32)
    cum = np.cumsum(-A * dtc, axis=2, dtype=np.float32)
    return xc, Bc, Cc, dtc, cum


EMULATED = ([pytest.param(intra_inputs(B * 1000 + Q, B, nc, Q, H, P, N),
                          id=f"{B}-{nc}-{Q}-{H}-{P}-{N}")
             for B, nc, Q, H, P, N in INTRA_SHAPES]
            + [pytest.param(mamba2_chunk_inputs(5, kind), id=f"mamba2-{kind}")
               for kind in ("init", "published")])


@pytest.mark.parametrize("arrs", EMULATED)
def test_ssd_intra_3xtf32_emulation_matches_reference(arrs):
    """The kernel's 3xTF32 rounding keeps it within the reference's
    kernel tolerance of the oracle and the Pallas kernel."""
    js = [jnp.asarray(a) for a in arrs]
    got = ssd_intra_3xtf32_ref(*map(torch.from_numpy, arrs))
    for name, want in (("oracle", jax_ssd_intra_ref(*js)),
                       ("pallas", jax_ssd_intra(*js))):
        for g, w, what in zip(got, want, ("y_intra", "state")):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(np32(g), np32(w), **KERNEL_TOL,
                                       err_msg=f"3xTF32 {what} vs {name}")


def test_single_tf32_product_misses_the_tolerance():
    """One TF32 product (hi.hi, no split) is not enough on Mamba2's chunk
    under either dt draw: its y leaves KERNEL_TOL of the oracle."""
    for kind in ("init", "published"):
        arrs = mamba2_chunk_inputs(5, kind)
        want = np32(jax_ssd_intra_ref(*map(jnp.asarray, arrs))[0])
        got = np32(ssd_intra_3xtf32_ref(*map(torch.from_numpy, arrs),
                                        lo=False)[0])
        share = np.abs(got - want) / (KERNEL_TOL["atol"]
                                      + KERNEL_TOL["rtol"] * np.abs(want))
        assert share.max() > 1.0, (kind, share.max())


def test_tf32_round_is_cvt_rna():
    """To nearest, ties away from zero, 13 low bits cleared; the remainder
    is exact in float32."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, 0.0, -2.0 ** -130],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0,
                         -2.0 ** -130], dtype=torch.float32)
    got = tf32_round(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    hi = tf32_round(v)
    assert torch.equal((hi.double() + (v - hi).double()).float(), v)


def test_ssd_intra_masks_padded_steps_exactly():
    """Steps with dt = 0 and zero inputs (the padding of a prompt to a
    chunk boundary) leave the chunk state and the earlier rows as
    they are."""
    xc, Bc, Cc, dtc, cum = intra_inputs(7, 1, 1, 40, 2, 16, 16)
    short = [torch.from_numpy(a[:, :, :30].copy())
             for a in (xc, Bc, Cc, dtc, cum)]
    for a in (xc, Bc, Cc, dtc):
        a[:, :, 30:] = 0
    cum[:, :, 30:] = cum[:, :, 29:30]
    y_pad, st_pad = ssd_ops.ssd_intra(*map(torch.from_numpy, (xc, Bc, Cc,
                                                               dtc, cum)))
    y, st = ssd_ops.ssd_intra(*short)
    np.testing.assert_allclose(np32(y_pad[:, :, :30]), np32(y), **MIXER_TOL)
    np.testing.assert_allclose(np32(st_pad), np32(st), **MIXER_TOL)


def test_ssd_intra_wrapper_rejects_what_the_kernel_does_not_take():
    ts = [torch.from_numpy(a) for a in intra_inputs(3, 1, 1, 16, 2, 8, 8)]
    with pytest.raises(TypeError):
        ssd_ops.ssd_intra(ts[0].double(), *ts[1:])
    with pytest.raises(ValueError, match="shapes"):
        ssd_ops.ssd_intra(ts[0], ts[1][..., :4], *ts[2:])
    big = [torch.from_numpy(a) for a in intra_inputs(3, 1, 1, 129, 1, 8, 8)]
    with pytest.raises(ValueError, match="Q <= 128"):
        ssd_ops.ssd_intra(*big)
    odd = [torch.from_numpy(a) for a in intra_inputs(3, 1, 1, 16, 2, 6, 8)]
    with pytest.raises(ValueError, match="multiple of 4"):
        ssd_ops.ssd_intra(*odd)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_intra(ts[0].transpose(3, 4).contiguous().transpose(3, 4),
                          *ts[1:])
    with pytest.raises(ValueError, match="device"):
        ssd_ops.ssd_intra(*(t.to("meta") for t in ts))


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------

def chunked_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    state0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, Bm, Cm, dt, A, state0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [8, 37, 96, 100])
def test_ssd_chunked_matches_reference(S, with_state):
    x, Bm, Cm, dt, A, state0 = chunked_inputs(S, 2, S, 3, 16, 16)
    if not with_state:
        state0 = None
    args = (x, Bm, Cm, dt, A)
    for impl in ("kernel", "plain"):
        got_y, got_s = ssm.ssd_chunked(
            *map(torch.from_numpy, args), 32,
            None if state0 is None else torch.from_numpy(state0), impl)
        assert got_y.shape == x.shape and got_s.shape == (2, 3, 16, 16)
        for ref_impl in ("xla", "pallas"):
            want_y, want_s = ref_ssm.ssd_chunked(
                *map(jnp.asarray, args), 32,
                None if state0 is None else jnp.asarray(state0), ref_impl)
            msg = f"port {impl} vs reference {ref_impl}"
            np.testing.assert_allclose(np32(got_y), np32(want_y),
                                       **KERNEL_TOL, err_msg=msg)
            np.testing.assert_allclose(np32(got_s), np32(want_s),
                                       **KERNEL_TOL, err_msg=msg)


def test_ssd_chunked_rejects_an_unknown_impl():
    x, Bm, Cm, dt, A, _ = chunked_inputs(0, 1, 8, 1, 8, 8)
    with pytest.raises(ValueError, match="impl"):
        ssm.ssd_chunked(*map(torch.from_numpy, (x, Bm, Cm, dt, A)), 32,
                        impl="xla")


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(11)
    B, H, P, N = 2, 3, 16, 24
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, B, N)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, H)), 0).astype(np.float32)
    A = np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = (x, Bm, Cm, dt, A, D, state)
    want = ref_ssm.ssd_step(*map(jnp.asarray, args))
    got = ssm.ssd_step(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(w), **MIXER_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(12)
    B, S, C, W = 2, 9, 40, 4
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    u = rng.standard_normal((B, S, C)).astype(np.float32)
    st = rng.standard_normal((B, W - 1, C)).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(u),
                                jnp.asarray(st) if with_state else None)
    got = ssm._causal_conv(torch.from_numpy(w), torch.from_numpy(b),
                           torch.from_numpy(u),
                           torch.from_numpy(st) if with_state else None)
    for g, v in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(v), **MIXER_TOL)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-100.0, 100.0, 0.0]]).astype(np.float32)
    want = jax.nn.softplus(jnp.asarray(x))
    got = ssm.softplus(torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("d_model", [256, 320])
def test_sinusoidal_embed_matches_reference(d_model):
    pos = np.random.default_rng(13).integers(0, 5000, size=(2, 7)).astype(
        np.int32)
    want = ref_sinusoidal_embed(jnp.asarray(pos), d_model)
    got = sinusoidal_embed(torch.from_numpy(pos), d_model)
    assert got.shape == (2, 7, d_model)
    # angles up to 5000 rad: the two libraries' float32 sin/cos differ in
    # the last ulp of the angle's reduction
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)


# ---------------------------------------------------------------------------
# the whole mixer
# ---------------------------------------------------------------------------

SSM_CFG = dict(name="ssm-test", arch_type="ssm", n_layers=1, d_model=64,
               n_heads=0, n_kv=0, d_ff=0, vocab=128, rope=False,
               dtype="float32")


def mixer_pair(seed):
    """The port's `SSM` and the reference's parameter dict, with the same
    seeded values in every leaf (A_log, D and dt_bias too)."""
    pcfg = ModelConfig(**SSM_CFG, ssm=SSMConfig(
        d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16))
    rcfg = RefModelConfig(**SSM_CFG, ssm=RefSSMConfig(
        d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16))
    mod = ssm.SSM(pcfg, torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    p = {}
    for name, t in mod.named_parameters():
        val = (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32)
        t.data.copy_(torch.from_numpy(val))
        node = p
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(val)
    return mod, p, pcfg, rcfg


def test_ssm_mixer_prefill_and_decode_match_reference():
    mod, p, pcfg, rcfg = mixer_pair(14)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    want, wst = ref_ssm.ssm_prefill(p, rcfg, jnp.asarray(x))
    got, gst = mod.prefill(torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np32(want), **KERNEL_TOL)
    np.testing.assert_allclose(np32(gst.ssd), np32(wst["ssd"]), **KERNEL_TOL)
    np.testing.assert_allclose(np32(gst.conv), np32(wst["conv"]), **MIXER_TOL)
    for i in range(3):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, wst = ref_ssm.ssm_decode(p, rcfg, jnp.asarray(xd), wst)
        got, gst2 = mod.decode(torch.from_numpy(xd), gst)
        assert gst2 is gst   # updated in place
        np.testing.assert_allclose(np32(got), np32(want), **KERNEL_TOL,
                                   err_msg=f"decode step {i}")
        np.testing.assert_allclose(np32(gst.ssd), np32(wst["ssd"]),
                                   **KERNEL_TOL)
        np.testing.assert_allclose(np32(gst.conv), np32(wst["conv"]),
                                   **MIXER_TOL)


@pytest.mark.parametrize("S", [15, 16, 40])
def test_prefill_then_decode_equals_a_longer_prefill(S):
    mod, _, pcfg, _ = mixer_pair(16)
    x = np.random.default_rng(17).standard_normal((2, S + 1, 64)).astype(
        np.float32)
    full, fst = mod.prefill(torch.from_numpy(x))
    _, st = mod.prefill(torch.from_numpy(x[:, :S].copy()))
    step, st = mod.decode(torch.from_numpy(x[:, S:].copy()), st)
    np.testing.assert_allclose(np32(step), np32(full[:, -1:]), **KERNEL_TOL)
    np.testing.assert_allclose(np32(st.ssd), np32(fst.ssd), **KERNEL_TOL)
    np.testing.assert_array_equal(np32(st.conv), np32(fst.conv))


def test_init_ssm_state_matches_reference_layout():
    _, _, pcfg, rcfg = mixer_pair(0)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        want = ref_ssm.init_ssm_state(rcfg, 3, jdt)
        got = ssm.init_ssm_state(pcfg, 3, dtype, "cpu")
        assert got.ssd.shape == want["ssd"].shape
        assert got.ssd.dtype == torch.float32
        assert got.conv.shape == want["conv"].shape and got.conv.dtype == dtype
        assert not got.ssd.any() and not got.conv.any()


def test_ssm_init_leaves_follow_the_reference():
    _, _, pcfg, rcfg = mixer_pair(0)
    want, _ = ref_ssm.ssm_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    mod = ssm.SSM(dataclasses.replace(pcfg), torch.float32, "cpu")
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(np32(getattr(mod, name)),
                                   np32(want[name]), atol=1e-6,
                                   err_msg=name)
    assert mod.conv_w_scale == pytest.approx(0.5)
