// Hand-written Hopper (sm_90a) SSD intra-chunk step: the port of the
// reference's Pallas kernel `ssd_intra`
// (src/repro/kernels/ssd_scan/ssd_scan.py:53, its pallas_call at :59).
//
// Computes, per (batch b, chunk c, head h) with chunk length Q, head dim
// P and state size N, from xc (B,nc,Q,H,P), Bc/Cc (B,nc,Q,N) and
// dtc/cum (B,nc,Q,H), all float32:
//
//   G[t,s]  = C_t . B_s                  (the same for every head)
//   W[t,s]  = G[t,s] * exp(cum_t - cum_s) * dt_s        for s <= t, else 0
//   y[t,:]  = sum_s W[t,s] x_s                          -> (B,nc,Q,H,P)
//   st[p,n] = sum_s (x_s[p] * exp(cum_{Q-1} - cum_s) * dt_s) B_s[n]
//                                                       -> (B,nc,H,P,N)
//
// The three products run on the tensor cores (mma.sync m16n8k8, TF32 in,
// float32 accumulators) in 3xTF32: each operand v is split into hi, v
// rounded to TF32 as cvt.rna.tf32.f32 rounds it, and lo, the rounded
// remainder, and a product step adds lo.hi and hi.lo before hi.hi, which
// keeps float32's accuracy (one TF32 product alone misses the 1e-4
// tolerance: ref.py `ssd_intra_3xtf32_ref(lo=False)`,
// tests/test_torch_ssm.py).  The decay, dt and mask weighting stays in
// float32 on the fragments, masked inside the exponent (exp(-inf) = 0 for s
// > t) in the diagonal blocks.
//
// What bounds it on an H100: at Mamba2-780M's geometry (Q 128, H 48, P
// 64, N 128) a 1024-token prompt moves ~39 MB (11.7 µs at 3.35 TB/s) and
// needs ~1.2 GFLOP of products, 3.7 G in 3xTF32 (7.5 µs at the TF32 rate
// of 495 TFLOP/s), so on this route bytes set the bound; all of it as
// float32 on the CUDA cores would take 18.6 µs.  In practice the SM's
// instruction issue does: every mma.sync needs its operands split (ALU) and
// loaded (shared memory) first.
//
// Design: one CTA of 16 warps per (group of hg heads, chunk, batch), one
// CTA an SM (180,736 B of dynamic shared memory; the first launch on a
// device opts in).
//   1. G: B and C of the chunk come in by cp.async (C in two 64-column
//      pieces, into the region G will take and into x's second buffer),
//      with the group's first head's x, cum and dt beside them.  Row tile
//      i of G's lower triangle (2 (i + 1) fragments of 16 x 8; nrt =
//      ceil(Q / 16) row tiles) goes to ceil((i + 1) / 3) warps, at most 6
//      fragments each (15 warps at Q = 128), so that a warp splits C's rows
//      once a k step for all its fragments.  G
//      stays in shared memory, row tile i at 128 i (i + 2) floats with a
//      row stride of 16 i + 24.  G is computed once per CTA: ceil(H / hg)
//      times per (batch, chunk) instead of H times (16 instead of 48 for
//      Mamba2 at 1024 tokens).
//   2. The heads, the next head's x, cum and dt coming in by cp.async while
//      one computes: warps 0-7 run y while warps 8-15 run the state, one
//      barrier a head.  y: warp w taking row tiles (w % 4, nrt - 1 -
//      w % 4), paired so that each runs about the same number of k steps
//      (18 at Q = 128), and head dims 8 (w / 4 + 2 q) + 0..7; it reads G's
//      fragments, forms W in registers and multiplies by x.  A fragment's
//      k index tg stands for s = 2 tg and tg + 4 for s = 2 tg + 1, so that
//      G and the cum/dt pairs are read as float2.  The state: xw^T B (xw =
//      x * tail, the state weights computed once a head into shared
//      memory), warp v taking head dims 16 (v % 4) .. + 15 and n8 tiles v /
//      4 + 2 q of B; N past 128 goes in tiles of 128, B's tile brought in
//      again each head.
//   Every k step's three products go to a fresh accumulator that is added
//   to the sum in float32 (see mma3).  Every shared-memory row stride is 4
//   or 8 (mod 32) words, so that the fragments' loads are free of bank
//   conflicts.  Padding: rows past Q, head dims past P and columns past N
//   are zeros in shared memory and never stored; any 1 <= Q <= 128, P <=
//   64 a multiple of 4 and N >= 1.
// Heads a CTA (hg): the fewest, at most 8, that put all the CTAs in one
// wave over the card's SMs (plan_hg).  On an H100 (132 SMs):
// Mamba2 at 1024 tokens and at 4 x 256 (8 chunks) hg 3, 128 CTAs, one
// wave; Hymba-1.5B (H 50, N 16) at 2048 tokens (16 chunks) hg 7, 128
// CTAs, at 1536 hg 5, 120, at 4 x 256 hg 4, 104; 300 tokens (3 chunks):
// Mamba2 hg 2, 72 CTAs, Hymba hg 2, 75; one short chunk (8 or 37 tokens):
// hg 1, 48 and 50 CTAs.  Every served shape fits one wave of 132.
// ptxas (sm_90a, -O3 -fmad=false): 116 registers, no spills, 2 barriers;
// with 180,736 B of shared memory, one CTA of 16 warps an SM.
// One kernel a call (torch.profiler, chip_smoke.py phase ssd_kernel).
//
// Plain C interface, bound from Python with ctypes
// (kernels/ssd_scan/ops.py): launches on the caller's stream, allocates
// nothing, does not synchronise, returns the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int QM = 128;          // largest chunk length
constexpr int PM = 64;           // largest head dim
constexpr int NBT = 128;         // state columns a tile of B
constexpr int NT = 512;          // threads of a CTA
constexpr int HG_MAX = 8;        // heads a CTA at most
constexpr int LDB = NBT + 4;     // row stride of B's tile, [s][n]
constexpr int LDX = PM + 4;      // row stride of x [s][p] and of C's pieces
constexpr int G_FLOATS = 128 * (QM / 16) * (QM / 16 + 2);
constexpr int X_FLOATS = QM * LDX;
// G, B's tile, two buffers of x, cum and dt, and the state weights
constexpr int SMEM_FLOATS =
    G_FLOATS + QM * LDB + 2 * X_FLOATS + 2 * 2 * QM + QM;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
constexpr int GF_WARP = 6;  // G's fragments a warp at most
constexpr float LOG2E = 1.4426950408889634f;
static_assert(X_FLOATS <= G_FLOATS, "a piece of C fits G's region");
static_assert(PM == 64 && NT == 512, "the warps' shares");

constexpr int MAX_DEVICES = 64;
std::atomic<bool> smem_opted_in[MAX_DEVICES];
std::atomic<int> sm_count[MAX_DEVICES];

// G's row tile i: its offset and row stride in shared memory
__device__ __forceinline__ int g_off(int i) { return 128 * i * (i + 2); }
__device__ __forceinline__ int g_ld(int i) { return 16 * i + 24; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (or 4) to shared memory, of which the first `bytes` from src and
// the rest zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the barrier of the 8 state warps
__device__ __forceinline__ void state_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// v = hi + lo, both TF32: hi is v rounded to 10 mantissa bits, to nearest
// with ties away from zero, lo the remainder rounded the same way.  That is
// cvt.rna.tf32.f32's rounding, done here with an integer add and mask on the
// bits (half an ulp of TF32 added to the magnitude, the 13 low bits
// cleared): the same values, and the whole kernel 12% faster than with the
// conversion instruction on an H100 (tools/ssd_intra_ab.py).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b from a zero accumulator
__device__ __forceinline__ void mma_tf32_0(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(z));
}

// acc[q] += a b[q] for one k step in 3xTF32: the small products (lo.hi,
// hi.lo) before hi.hi, each pass over the NQ accumulators in turn so that
// a tensor core's products for one accumulator are NQ apart.  The step's
// products go to a fresh accumulator, added to acc in float32 (rounded to
// nearest): summed over a chunk's k steps in the tensor cores' own
// accumulation, y came out 2-5x further from the plain version than the
// rounding emulation, and Mamba2-780M's logits nearly twice as far from
// a float64 version's (tools/ssd_intra_ab.py --variants --model, tc_acc).
template <int NQ>
__device__ __forceinline__ void mma3(float (&acc)[NQ][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[NQ][2],
                                     const uint32_t (&bl)[NQ][2]) {
  float d[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) mma_tf32_0(d[q], al, bh[q]);
#pragma unroll
  for (int q = 0; q < NQ; ++q) mma_tf32(d[q], ah, bl[q]);
#pragma unroll
  for (int q = 0; q < NQ; ++q) mma_tf32(d[q], ah, bh[q]);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] += d[q][e];
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}

__device__ __forceinline__ bool causal(int s, int t) { return s <= t; }

// exp(cum_t - cum_s); MASK: 0 above the diagonal (off the diagonal blocks
// every s < t)
template <bool MASK>
__device__ __forceinline__ float decay(int s, int t, float ct, float cs) {
  return ex2(((!MASK || causal(s, t)) ? ct - cs : -INFINITY) * LOG2E);
}

// rows [0, rows) x columns [0, cols) of dst (row stride ld), by threads
// tid = 0 .. nthr - 1: element (r, c) is src[r * sld + c] if r < rv and c <
// cv, else 0.  cols is a multiple of 4; vec: src and sld allow 16-byte
// copies.
__device__ void load_tile(float* dst, int ld, const float* src, long sld,
                          int rows, int cols, int rv, int cv, bool vec,
                          int tid, int nthr) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int i = tid; i < rows * c4; i += nthr) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const int n = r < rv ? min(max(cv - c, 0), 4) : 0;
      cp_async16(dst + r * ld + c, n ? src + r * sld + c : src, 4 * n);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthr) {
      const int r = i / cols, c = i - r * cols;
      const bool in = r < rv && c < cv;
      cp_async4(dst + r * ld + c, in ? src + r * sld + c : src, in ? 4 : 0);
    }
  }
}

struct Shape {
  long bc;   // batch * nc + chunk
  int Q, H, P, N, Qp;
};

// The regions of shared memory: G, B's tile of 128 columns, two buffers
// of x, cum and dt, and the state weights.
struct Smem {
  float* G;
  float* B;
  float* x;
  float* cum;
  float* dt;
  float* tail;
};

__device__ __forceinline__ Smem carve(float* smem) {
  Smem m;
  m.G = smem;
  m.B = smem + G_FLOATS;
  m.x = m.B + QM * LDB;
  m.cum = m.x + 2 * X_FLOATS;
  m.dt = m.cum + 2 * QM;
  m.tail = m.dt + 2 * QM;
  return m;
}

// head h's x, cum and dt into buffer `buf`, by threads tid < nthr
__device__ void load_head(const Smem& m, int buf, int h, const float* x,
                          const float* dt, const float* cum, const Shape& sh,
                          int tid, int nthr) {
  const int Q = sh.Q, H = sh.H, P = sh.P;
  load_tile(m.x + buf * X_FLOATS, LDX,
            x + (sh.bc * Q * H + h) * static_cast<long>(P),
            static_cast<long>(H) * P, sh.Qp, PM, Q, P, true, tid, nthr);
  float* cs = m.cum + buf * QM;
  float* ds = m.dt + buf * QM;
  for (int t = tid; t < sh.Qp; t += nthr) {
    const bool in = t < Q;
    const long g = (sh.bc * Q + t) * H + h;
    cp_async4(cs + t, in ? cum + g : cum, in ? 4 : 0);
    cp_async4(ds + t, in ? dt + g : dt, in ? 4 : 0);
  }
}

// one k step (columns sa, sa + 1 of W) of y's rows r0, r1: W from G's
// fragment, the decay and dt, times x's rows sa, sa + 1 at xr
template <bool MASK>
__device__ __forceinline__ void y_step(float (&acc)[4][4], float2 ga,
                                       float2 gb, float2 cu, float2 dd,
                                       float c0, float c1, int r0, int r1,
                                       int sa, const float* xr) {
  // A: (row g, k tg) = W[r0][sa], (g + 8, tg) = W[r1][sa], (g, tg + 4)
  // = W[r0][sa + 1], (g + 8, tg + 4) = W[r1][sa + 1]
  const float wv[4] = {ga.x * decay<MASK>(sa, r0, c0, cu.x) * dd.x,
                       gb.x * decay<MASK>(sa, r1, c1, cu.x) * dd.x,
                       ga.y * decay<MASK>(sa + 1, r0, c0, cu.y) * dd.y,
                       gb.y * decay<MASK>(sa + 1, r1, c1, cu.y) * dd.y};
  uint32_t ah[4], al[4], bh[4][2], bl[4][2];
  split4(wv, ah, al);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    split(xr[16 * q], bh[q][0], bl[q][0]);
    split(xr[LDX + 16 * q], bh[q][1], bl[q][1]);
  }
  mma3<4>(acc, ah, al, bh, bl);
}

// y of head h by one of 8 warps, w: row tiles (w % 4, nrt - 1 - w % 4)
// and head dims 8 (w / 4 + 2 q) + 0..7, q < 4
__device__ void head_y(const Smem& m, int buf, int h, float* y,
                       const Shape& sh, int w) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int nrt = sh.Qp >> 4;
  const float* xs = m.x + buf * X_FLOATS;
  const float* cs = m.cum + buf * QM;
  const float* ds = m.dt + buf * QM;
  const int ia = w & 3, ib = nrt - 1 - ia, ph = w >> 2;
  for (int k = 0; k < 2; ++k) {
    const int i = k == 0 ? ib : ia;
    if (ia > ib || (k == 1 && ia == ib)) break;
    const int r0 = 16 * i + g, r1 = r0 + 8;
    const float c0 = cs[r0], c1 = cs[r1];
    const float* g0 = m.G + g_off(i) + g * g_ld(i) + 2 * tg;
    const float* g1 = g0 + 8 * g_ld(i);
    // head dims 8 ph + 16 q + g: x is zero past P
    const float* xc = xs + 2 * tg * LDX + 8 * ph + g;
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    // the k steps left of the diagonal block, then its two
    for (int j = 0; j < 2 * i; ++j) {
      const int sa = 8 * j + 2 * tg;
      y_step<false>(acc, *reinterpret_cast<const float2*>(g0 + 8 * j),
                    *reinterpret_cast<const float2*>(g1 + 8 * j),
                    *reinterpret_cast<const float2*>(cs + sa),
                    *reinterpret_cast<const float2*>(ds + sa), c0, c1, r0,
                    r1, sa, xc + 8 * j * LDX);
    }
#pragma unroll
    for (int j = 2 * i; j < 2 * i + 2; ++j) {
      const int sa = 8 * j + 2 * tg;
      y_step<true>(acc, *reinterpret_cast<const float2*>(g0 + 8 * j),
                   *reinterpret_cast<const float2*>(g1 + 8 * j),
                   *reinterpret_cast<const float2*>(cs + sa),
                   *reinterpret_cast<const float2*>(ds + sa), c0, c1, r0,
                   r1, sa, xc + 8 * j * LDX);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 8 * ph + 16 * q + 2 * tg;
      if (col >= sh.P) continue;
      const long row = (sh.bc * sh.Q + r0) * sh.H + h;
      if (r0 < sh.Q)
        *reinterpret_cast<float2*>(y + row * sh.P + col) =
            make_float2(acc[q][0], acc[q][1]);
      if (r1 < sh.Q)
        *reinterpret_cast<float2*>(y + (row + 8L * sh.H) * sh.P + col) =
            make_float2(acc[q][2], acc[q][3]);
    }
  }
}

// n8 tiles of B's tile a state warp takes, rounded up to a power of two:
// the warps take 2 NQ of them, columns 0 .. 16 NQ - 1 (zeros past nb)
__device__ __forceinline__ int state_nq(int nb) {
  const int n = (nb + 15) >> 4;
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8;
}

// the state warp's head dims p0, p0 + 8 and columns n0 + 8 (nq + 2 q) + 0..7
// of one tile of B, for q < NQ
template <int NQ>
__device__ void state_tile(const float* xs, const float* tail, const float* Bs,
                           float* so, int p0, int nq, int n0,
                           const Shape& sh) {
  const int tg = threadIdx.x & 3;
  float acc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
  const float* xc = xs + 2 * tg * LDX + p0;
  const float* bc = Bs + 2 * tg * LDB + (p0 & 7) + 8 * nq;
  for (int ks = 0; ks < (sh.Q + 7) >> 3; ++ks) {
    const float2 tl = *reinterpret_cast<const float2*>(tail + 8 * ks + 2 * tg);
    const float* xr = xc + 8 * ks * LDX;
    // A = xw^T: (row g, k tg) = xw[sa][p0], (g + 8, tg) = xw[sa][p0 + 8],
    // (g, tg + 4) = xw[sa + 1][p0], (g + 8, tg + 4) = xw[sa + 1][p0 + 8]
    const float a[4] = {xr[0] * tl.x, xr[8] * tl.x, xr[LDX] * tl.y,
                        xr[LDX + 8] * tl.y};
    uint32_t ah[4], al[4], bh[NQ][2], bl[NQ][2];
    split4(a, ah, al);
    const float* br = bc + 8 * ks * LDB;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      split(br[16 * q], bh[q][0], bl[q][0]);
      split(br[LDB + 16 * q], bh[q][1], bl[q][1]);
    }
    mma3<NQ>(acc, ah, al, bh, bl);
  }
  const int P = sh.P, N = sh.N;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int n = n0 + 8 * (nq + 2 * q) + 2 * tg;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + 8 * half;
      if (p >= P) continue;
      if (n < N) so[static_cast<long>(p) * N + n] = acc[q][2 * half];
      if (n + 1 < N)
        so[static_cast<long>(p) * N + n + 1] = acc[q][2 * half + 1];
    }
  }
}

// the state of head h by 8 warps: warp v (thread sid of 256) takes head
// dims 16 (v % 4) .. + 15 and n8 tiles v / 4 + 2 q
__device__ void head_state(const Smem& m, int buf, int h, const float* Bm,
                           float* st, const Shape& sh, int v, int sid) {
  const int Q = sh.Q, P = sh.P, N = sh.N;
  const float* xs = m.x + buf * X_FLOATS;
  const float* cs = m.cum + buf * QM;
  const float* ds = m.dt + buf * QM;
  if (sid < QM)
    m.tail[sid] =
        sid < Q ? ex2((cs[Q - 1] - cs[sid]) * LOG2E) * ds[sid] : 0.0f;
  state_sync();
  const int p0 = 16 * (v & 3) + ((threadIdx.x & 31) >> 2), nq = v >> 2;
  const bool active = 16 * (v & 3) < P;
  float* so = st + (sh.bc * sh.H + h) * static_cast<long>(P) * N;
  for (int n0 = 0; n0 < N; n0 += NBT) {
    const int nb = min(NBT, N - n0), cols = 16 * state_nq(nb);
    if (N > NBT) {  // B's tiles do not all stay: bring this one in again
      state_sync();
      for (int i = sid; i < sh.Qp * cols; i += 256) {
        const int r = i / cols, c = i - r * cols;
        m.B[r * LDB + c] =
            (r < Q && c < nb) ? Bm[(sh.bc * Q + r) * N + n0 + c] : 0.0f;
      }
      state_sync();
    }
    if (!active) continue;
    switch (state_nq(nb)) {
      case 1: state_tile<1>(xs, m.tail, m.B, so, p0, nq, n0, sh); break;
      case 2: state_tile<2>(xs, m.tail, m.B, so, p0, nq, n0, sh); break;
      case 4: state_tile<4>(xs, m.tail, m.B, so, p0, nq, n0, sh); break;
      default: state_tile<8>(xs, m.tail, m.B, so, p0, nq, n0, sh); break;
    }
  }
}

// G's fragments (row tile i, 8-column tiles j0 .. j0 + NF - 1) of a warp
// over one tile of N, C's row tile split once a k step for all of them: C's
// rows from ca (k below 64) or cb, B's rows from br, k < nb8
template <int NF>
__device__ __forceinline__ void gram_tile(float (&gacc)[GF_WARP][4], int i,
                                          int j0, const float* ca,
                                          const float* cb, const float* br,
                                          int nb8) {
  for (int k0 = 0; k0 < nb8; k0 += 8) {
    const float* cr = (k0 < 64 ? ca + k0 : cb + (k0 - 64)) + 16 * i * LDX;
    const float a[4] = {cr[0], cr[8 * LDX], cr[4], cr[8 * LDX + 4]};
    uint32_t ah[4], al[4], bh[NF][2], bl[NF][2];
    split4(a, ah, al);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* b = br + 8 * (j0 + f) * LDB + k0;
      split(b[0], bh[f][0], bl[f][0]);
      split(b[4], bh[f][1], bl[f][1]);
    }
    mma3<NF>(reinterpret_cast<float(&)[NF][4]>(gacc), ah, al, bh, bl);
  }
}

__global__ void __launch_bounds__(NT, 1)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ dt,
                 const float* __restrict__ cum, float* __restrict__ y,
                 float* __restrict__ st, int nc, int Q, int H, int P, int N,
                 int hg) {
  extern __shared__ __align__(16) float smem[];
  Shape sh;
  sh.bc = static_cast<long>(blockIdx.z) * nc + blockIdx.y;
  sh.Q = Q; sh.H = H; sh.P = P; sh.N = N;
  sh.Qp = (Q + 15) & ~15;
  const int h0 = blockIdx.x * hg, nh = min(hg, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int nrt = sh.Qp >> 4;
  const bool vecN = (N & 3) == 0;
  const Smem m = carve(smem);
  const float* Bsrc = Bm + sh.bc * Q * N;
  const float* Csrc = Cm + sh.bc * Q * N;
  float* Ca = m.x + X_FLOATS;  // C's columns 0-63 of a tile
  float* Cb = m.G;             // and 64-127, in G's region

  // ---- 1. G = C B^T on and below the diagonal, over N in tiles of 128.
  // Row tile i's 2 (i + 1) fragments go to ceil((i + 1) / 3) warps, at most
  // 6 each (15 warps at Q = 128): warp w takes row tile gi, fragments gj0 ..
  // gj0 + gn - 1.
  int gi = 0, gj0 = 0, gn = 0;
  for (int i = 0, w0 = 0; i < nrt; ++i) {
    const int n = 2 * (i + 1), kk = (i + 3) / 3;
    if (warp < w0 + kk) {
      const int u = warp - w0;
      gi = i;
      gj0 = u * n / kk;
      gn = (u + 1) * n / kk - gj0;
      break;
    }
    w0 += kk;
  }
  float gacc[GF_WARP][4];
#pragma unroll
  for (int f = 0; f < GF_WARP; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[f][e] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += NBT) {
    const int nb = min(NBT, N - n0), nb8 = (nb + 7) & ~7;
    const int cols = 16 * state_nq(nb);  // what the state warps read
    if (n0 > 0) __syncthreads();  // the last tile's reads are done
    load_tile(m.B, LDB, Bsrc + n0, N, sh.Qp, cols, Q, nb, vecN, tid, NT);
    load_tile(Ca, LDX, Csrc + n0, N, sh.Qp, min(64, nb8), Q, nb, vecN, tid,
              NT);
    if (nb8 > 64)
      load_tile(Cb, LDX, Csrc + n0 + 64, N, sh.Qp, nb8 - 64, Q, nb - 64, vecN,
                tid, NT);
    if (n0 == 0) load_head(m, 0, h0, x, dt, cum, sh, tid, NT);
    cp_async_wait_all();
    __syncthreads();
    const float* ca = Ca + g * LDX + tg;
    const float* cb = Cb + g * LDX + tg;
    const float* br = m.B + g * LDB + tg;
    switch (gn) {
      case 0: break;
      case 1: gram_tile<1>(gacc, gi, gj0, ca, cb, br, nb8); break;
      case 2: gram_tile<2>(gacc, gi, gj0, ca, cb, br, nb8); break;
      case 3: gram_tile<3>(gacc, gi, gj0, ca, cb, br, nb8); break;
      case 4: gram_tile<4>(gacc, gi, gj0, ca, cb, br, nb8); break;
      case 5: gram_tile<5>(gacc, gi, gj0, ca, cb, br, nb8); break;
      default: gram_tile<6>(gacc, gi, gj0, ca, cb, br, nb8); break;
    }
  }
  __syncthreads();  // C's pieces are read: G's region and x's buffer 1 free
#pragma unroll
  for (int f = 0; f < GF_WARP; ++f) {
    if (f >= gn) continue;
    float* gp = m.G + g_off(gi) + g * g_ld(gi) + 8 * (gj0 + f) + 2 * tg;
    *reinterpret_cast<float2*>(gp) = make_float2(gacc[f][0], gacc[f][1]);
    *reinterpret_cast<float2*>(gp + 8 * g_ld(gi)) =
        make_float2(gacc[f][2], gacc[f][3]);
  }

  // ---- 2. the heads, the next one's inputs in flight: warps 0-7 compute
  // y, warps 8-15 the state; buffer k & 1
  if (nh > 1) load_head(m, 1, h0 + 1, x, dt, cum, sh, tid, NT);
  __syncthreads();
  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k, buf = k & 1;
    if (warp < 8)
      head_y(m, buf, h, y, sh, warp);
    else
      head_state(m, buf, h, Bm, st, sh, warp - 8, tid - 256);
    cp_async_wait_all();
    __syncthreads();
    if (k + 2 < nh) load_head(m, buf, h + 2, x, dt, cum, sh, tid, NT);
  }
}

// Heads a CTA: the fewest that put all the CTAs in one wave over the
// card's SMs, at most HG_MAX (more heads a CTA compute G fewer times but
// leave SMs idle).
int plan_hg(int B, int nc, int H, int nsm) {
  for (int hg = 1; hg < HG_MAX && hg < H; ++hg)
    if (static_cast<long>((H + hg - 1) / hg) * B * nc <= nsm) return hg;
  return H < HG_MAX ? H : HG_MAX;
}

int device_sms(int* nsm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  int n = sm_count[dev].load(std::memory_order_acquire);
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    sm_count[dev].store(n, std::memory_order_release);
  }
  *nsm = n;
  return 0;
}

int launch(const float* x, const float* Bm, const float* Cm, const float* dt,
           const float* cum, float* y, float* st, int B, int nc, int Q, int H,
           int P, int N, int hg, cudaStream_t stream) {
  if (B < 1 || nc < 1 || Q < 1 || Q > QM || H < 1 || P < 4 || P > PM ||
      P % 4 != 0 || N < 1 || nc > 65535 || B > 65535 || hg < 1 ||
      hg > HG_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory opt-in holds per device: set it on a device's
  // first launch only
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(ssd_intra_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_opted_in[dev].store(true, std::memory_order_release);
  }
  ssd_intra_kernel<<<dim3((H + hg - 1) / hg, nc, B), NT, SMEM_BYTES,
                     stream>>>(x, Bm, Cm, dt, cum, y, st, nc, Q, H, P, N, hg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Heads a CTA for this shape on the current device (plan_hg), or a
// negative CUDA error code.
int ssd_intra_group(int B, int nc, int H) {
  int nsm = 0;
  const int e = device_sms(&nsm);
  if (e != 0) return -e;
  return plan_hg(B, nc, H, nsm);
}

// All pointers float32 and 16-byte aligned; 1 <= Q <= 128, P <= 64 and a
// multiple of 4 (so that rows of x and y are float4-aligned).
int ssd_intra_fwd(const float* x, const float* Bm, const float* Cm,
                  const float* dt, const float* cum, float* y, float* st,
                  int B, int nc, int Q, int H, int P, int N,
                  cudaStream_t stream) {
  const int hg = ssd_intra_group(B, nc, H);
  if (hg < 0) return -hg;
  return launch(x, Bm, Cm, dt, cum, y, st, B, nc, Q, H, P, N, hg, stream);
}

// The same with hg heads a CTA (1..8) instead of the plan's.
int ssd_intra_fwd_group(const float* x, const float* Bm, const float* Cm,
                        const float* dt, const float* cum, float* y,
                        float* st, int B, int nc, int Q, int H, int P, int N,
                        int hg, cudaStream_t stream) {
  return launch(x, Bm, Cm, dt, cum, y, st, B, nc, Q, H, P, N, hg, stream);
}

int ssd_intra_max_q(void) { return QM; }

int ssd_intra_max_p(void) { return PM; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
