"""The port's attention kernels against the JAX reference, on the CPU.

Inputs are seeded numpy normals handed to both packages (bfloat16 cases
round the same float32 values to bfloat16 in both, with equal bits).
The port's wrappers `repro_torch.kernels.{flash,decode}_attention.ops`
run their plain PyTorch versions on CPU tensors; they are held against

* the reference's Pallas kernels through `repro.kernels.*.ops`, which
  run in interpret mode on the CPU, on the parameter grids of
  `tests/test_kernels.py` (`TestFlashAttention`, `TestDecodeAttention`).
  Both compute in float32 from the same inputs and differ only in the
  order of their float32 sums: float32 outputs agree within 3e-5, and
  bfloat16 outputs within one bfloat16 ulp of the output plus that
  float32 bound (two float32 results 3e-5 apart round to bfloat16 values
  at most one ulp plus 3e-5 apart; near zero, where a bfloat16 ulp is
  tiny, the float32 term is what remains);
* the reference's oracles `repro.kernels.*.ref`, within the reference's
  own `TOLS` (3e-5 for float32, 3e-2 for bfloat16: its oracle runs its
  einsums in bfloat16).

Ragged lengths that only the port accepts (no block divisibility) are
held against the oracles.  The decode kernel's algorithm (32-key tiles,
splits from `ops.split_plan`, tiles with no valid key skipped, the
combine and its all-invalid rule) is emulated step by step in
`decode_attention_split_ref` and held against the interpret-mode Pallas
kernel like the plain version.  The CUDA kernels themselves are held
against these plain versions on the card by `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref as port_decode_ref,
    decode_attention_split_ref,
)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_mma_ref

torch.set_num_threads(2)

TOLS = {"float32": dict(atol=3e-5, rtol=3e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_EPS = 2.0 ** -7   # spacing of bfloat16 values in [1, 2)


def inputs(seed, shapes, dtype):
    """The same values for both packages: (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    js = [jnp.asarray(x).astype(JNP[dtype]) for x in xs]
    ts = [torch.from_numpy(x).to(TORCH[dtype]) for x in xs]
    if dtype == "bfloat16":
        for j, t in zip(js, ts):
            np.testing.assert_array_equal(
                np.asarray(j.astype(jnp.float32)), t.float().numpy())
    return js, ts


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def bf16_ulp(x):
    """Spacing of bfloat16 values at |x| (normal range)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return BF16_EPS * np.exp2(np.floor(np.log2(mag)))


def assert_kernel_close(port, ref, dtype):
    """Against the interpret-mode Pallas kernel: 3e-5 in float32, one
    bfloat16 ulp of the output plus 3e-5 in bfloat16."""
    p, r = f32(port), f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(p, r, atol=3e-5, rtol=0)
    else:
        ulp = bf16_ulp(np.maximum(np.abs(p), np.abs(r)))
        bad = np.abs(p - r) > ulp + 3e-5
        assert not bad.any(), (p[bad][:5], r[bad][:5])


# the grids of tests/test_kernels.py
FLASH_GRID = [
    (1, 512, 4, 4, 64, 0, 128, 128),     # MHA
    (2, 512, 8, 2, 64, 0, 256, 128),     # GQA
    (1, 1024, 4, 1, 128, 0, 256, 256),   # MQA, wide head
    (1, 512, 4, 2, 64, 200, 128, 128),   # sliding window
    (1, 768, 6, 3, 32, 0, 256, 256),     # non-pow2 heads
]
# lengths that only the port accepts (no block divisibility)
FLASH_RAGGED = [
    (1, 37, 37, 4, 2, 64, 0),      # a ragged prompt
    (2, 37, 100, 8, 2, 32, 0),     # fewer queries than keys
    (1, 130, 130, 6, 3, 32, 50),   # ragged, windowed
    (1, 1, 1, 4, 4, 128, 0),       # one token
]
DECODE_GRID = [
    (1, 1024, 8, 8, 64, 1000, 256),
    (4, 2048, 8, 2, 64, 1, 512),         # single valid entry
    (2, 1024, 16, 2, 128, 555, 256),
    (1, 4096, 4, 1, 64, 4096, 1024),     # fully valid, MQA
    # the port's kernel serves a KV head's G query heads in one CTA:
    (1, 1024, 10, 2, 64, 700, 256),      # G = 5 (Hymba), not a power of 2
    (1, 1024, 24, 2, 128, 1024, 256),    # G = 12 (StarCoder2), all valid
    # splits of 4 tiles (ops.split_plan at B * KV = 32): the valid prefix
    # ends inside split 7 and inside its last tile
    (2, 2048, 16, 16, 32, 1000, 512),
]
# the kernel's split emulation: (B, S, H, KV, hd, mask, bk); mask is a
# valid prefix length, "ring" (every third slot stale), or "tile_last"
# (only the last key of each 32-key tile valid: every live tile rests
# on the key that the any-valid test reads last)
DECODE_SPLIT_CASES = (
    [(B, S, H, KV, hd, n, bk) for B, S, H, KV, hd, n, bk in DECODE_GRID]
    + [(1, 512, 4, 2, 64, "ring", 128),
       (2, 77, 4, 2, 32, 0, 77),            # nothing valid: the mean of V
       (1, 512, 10, 2, 64, "tile_last", 128)])


def decode_mask(S, mask):
    j = np.arange(S)
    if mask == "ring":
        return (j % 3) != 1
    if mask == "tile_last":
        return (j % da_ops.BLOCK) == da_ops.BLOCK - 1
    return j < mask


class TestFlashAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,S,H,KV,hd,window,bq,bk", FLASH_GRID)
    def test_matches_reference(self, dtype, B, S, H, KV, hd, window, bq, bk):
        (jq, jk, jv), (tq, tk, tv) = inputs(
            0, [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
        port = fa_ops.flash_attention(tq, tk, tv, window=window)
        assert port.dtype == TORCH[dtype] and port.shape == (B, S, H, hd)
        kernel = jax_flash(jq, jk, jv, window=window, bq=bq, bk=bk)
        assert_kernel_close(port, kernel, dtype)
        oracle = flash_attention_ref(jq, jk, jv, window=window)
        np.testing.assert_allclose(f32(port), f32(oracle), **TOLS[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,window", FLASH_RAGGED)
    def test_ragged_lengths(self, dtype, B, Sq, Skv, H, KV, hd, window):
        (jq, jk, jv), (tq, tk, tv) = inputs(
            1, [(B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)], dtype)
        port = fa_ops.flash_attention(tq, tk, tv, window=window)
        oracle = flash_attention_ref(jq, jk, jv, window=window)
        np.testing.assert_allclose(f32(port), f32(oracle), **TOLS[dtype])

    def test_rejects_what_the_kernel_does_not_take(self):
        q = torch.zeros(1, 8, 4, 64)
        k = torch.zeros(1, 4, 4, 64)
        with pytest.raises(ValueError):      # Sq > Skv
            fa_ops.flash_attention(q, k, k)
        with pytest.raises(ValueError):      # head dim
            fa_ops.flash_attention(torch.zeros(1, 8, 4, 48),
                                   torch.zeros(1, 8, 4, 48),
                                   torch.zeros(1, 8, 4, 48))
        with pytest.raises(ValueError):      # H % KV
            fa_ops.flash_attention(q, torch.zeros(1, 8, 3, 64),
                                   torch.zeros(1, 8, 3, 64))
        with pytest.raises(TypeError):       # mixed dtypes
            fa_ops.flash_attention(q, q.to(torch.bfloat16), q)
        with pytest.raises(ValueError):      # not contiguous
            fa_ops.flash_attention(q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), q, q)

    def test_cpu_path_launches_no_kernel(self):
        fa_ops.reset_launches()
        x = torch.zeros(1, 4, 2, 32)
        fa_ops.flash_attention(x, x, x)
        assert fa_ops.LAUNCHES["flash_attention"] == 0


class TestFlashTensorCoreRounding:
    """The card's bf16 body rounds P to bf16 before P V (2^-9 relative a
    weight), which the float32 plain version does not; `chip_smoke.py`
    holds the kernel to the plain version within TOLS["bfloat16"], and
    to this rounding's emulation (`ref.flash_attention_mma_ref`) within
    one bf16 ulp.  The emulation shows on the CPU that the rounding fits
    the first bound at the reference's grid and the ragged shapes."""

    @pytest.mark.parametrize(
        "B,Sq,Skv,H,KV,hd,window",
        [(B, S, S, H, KV, hd, w) for B, S, H, KV, hd, w, _, _ in FLASH_GRID]
        + FLASH_RAGGED)
    def test_fits_the_bf16_tolerance(self, B, Sq, Skv, H, KV, hd, window):
        _, (tq, tk, tv) = inputs(
            5, [(B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)],
            "bfloat16")
        emulated = flash_attention_mma_ref(tq, tk, tv, window=window)
        plain = fa_ops.flash_attention(tq, tk, tv, window=window)
        assert emulated.dtype == plain.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(emulated), f32(plain),
                                   **TOLS["bfloat16"])


class TestDecodeAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,S,H,KV,hd,n_valid,bk", DECODE_GRID)
    def test_matches_reference(self, dtype, B, S, H, KV, hd, n_valid, bk):
        (jq, jk, jv), (tq, tk, tv) = inputs(
            0, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
        valid = np.arange(S) < n_valid
        port = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
        assert port.dtype == TORCH[dtype] and port.shape == (B, H, hd)
        kernel = jax_decode(jq, jk, jv, jnp.asarray(valid), bk=bk)
        assert_kernel_close(port, kernel, dtype)
        oracle = decode_attention_ref(jq, jk, jv, jnp.asarray(valid))
        np.testing.assert_allclose(f32(port), f32(oracle), **TOLS[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ring_mask_pattern(self, dtype):
        """Non-contiguous validity (a ring cache after wrap-around)."""
        B, S, H, KV, hd = 1, 512, 4, 2, 64
        (jq, jk, jv), (tq, tk, tv) = inputs(
            2, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
        valid = (np.arange(S) % 3) != 1
        port = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
        kernel = jax_decode(jq, jk, jv, jnp.asarray(valid), bk=128)
        assert_kernel_close(port, kernel, dtype)

    @pytest.mark.parametrize("S,n_valid,H,KV,hd", [
        (1000, 1000, 8, 8, 64),    # ragged cache length
        (1000, 421, 24, 2, 128),   # ragged, GQA, part valid
        (77, 0, 4, 2, 32),         # nothing valid: the mean of V
    ])
    def test_ragged_lengths(self, S, n_valid, H, KV, hd):
        (jq, jk, jv), (tq, tk, tv) = inputs(
            3, [(2, H, hd), (2, S, KV, hd), (2, S, KV, hd)], "float32")
        valid = np.arange(S) < n_valid
        port = da_ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
        oracle = decode_attention_ref(jq, jk, jv, jnp.asarray(valid))
        np.testing.assert_allclose(f32(port), f32(oracle),
                                   **TOLS["float32"])

    def test_rejects_bad_mask(self):
        q, k = torch.zeros(1, 4, 64), torch.zeros(1, 16, 4, 64)
        with pytest.raises(ValueError):
            da_ops.decode_attention(q, k, k, torch.ones(15, dtype=torch.bool))
        with pytest.raises(ValueError):
            da_ops.decode_attention(q, k, k, torch.ones(16))

    def test_split_plan_covers_every_block(self):
        for B, KV, S in [(1, 32, 2048), (4, 32, 2048), (1, 24, 64),
                         (1, 1, 129), (64, 32, 4096), (1, 32, 100),
                         (1, 2, 4096), (1, 2, 64), (1, 5, 1024),
                         (4, 5, 2048), (1, 1, 1 << 20)]:
            n_split, per = da_ops.split_plan(B, KV, S)
            n_blk = -(-S // da_ops.BLOCK)
            assert 1 <= per <= da_ops.MAX_TILES
            assert n_split == -(-n_blk // per)
            assert (n_split - 1) * per < n_blk <= n_split * per

    def test_grid_has_a_prefix_ending_inside_a_split(self):
        """DECODE_GRID keeps a case whose valid prefix ends inside a tile
        of a split of several tiles, under the present plan."""
        def inside(B, S, KV, n):
            n_split, per = da_ops.split_plan(B, KV, S)
            return per > 1 and 0 < n < S and n % da_ops.BLOCK
        assert any(inside(B, S, KV, n)
                   for B, S, H, KV, hd, n, bk in DECODE_GRID)

    @pytest.mark.parametrize("B,KV,S", [
        (1, 32, 2048), (4, 32, 2048),            # StableLM serve, batch
        (1, 2, 4096), (1, 2, 64),                # StarCoder2
        (1, 5, 1024), (1, 5, 2048), (4, 5, 2048),  # Hymba local, global
        (1, 1, 100),                             # fewer tiles than SMs
    ])
    def test_split_plan_fills_the_card(self, B, KV, S):
        """At least one partial CTA an SM wherever the cache has that many
        tiles, every one of them when it has fewer."""
        n_split, per = da_ops.split_plan(B, KV, S)
        n_tiles = -(-S // da_ops.BLOCK)
        assert B * KV * n_split >= min(da_ops.SMS, B * KV * n_tiles)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,S,H,KV,hd,mask,bk", DECODE_SPLIT_CASES)
    def test_split_emulation_matches_kernel(self, dtype, B, S, H, KV, hd,
                                            mask, bk):
        """The CUDA kernel's algorithm (tiles, splits, the skipping of
        tiles with no valid key, the combine and its all-invalid rule),
        emulated in ref.py, against the reference's interpret-mode
        Pallas kernel."""
        (jq, jk, jv), (tq, tk, tv) = inputs(
            5, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
        valid = decode_mask(S, mask)
        plan = da_ops.split_plan(B, KV, S)
        port = decode_attention_split_ref(tq, tk, tv, torch.from_numpy(valid),
                                          plan, da_ops.BLOCK)
        assert port.dtype == TORCH[dtype] and port.shape == (B, H, hd)
        kernel = jax_decode(jq, jk, jv, jnp.asarray(valid), bk=bk)
        assert_kernel_close(port, kernel, dtype)

    def test_plain_version_is_the_cpu_path(self):
        (_, _, _), (tq, tk, tv) = inputs(
            4, [(1, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32)], "float32")
        valid = torch.arange(40) < 33
        da_ops.reset_launches()
        torch.testing.assert_close(
            da_ops.decode_attention(tq, tk, tv, valid),
            port_decode_ref(tq, tk, tv, valid), rtol=0, atol=0)
        assert da_ops.LAUNCHES["decode_attention"] == 0
