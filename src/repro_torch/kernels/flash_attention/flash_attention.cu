// Hand-written Hopper (sm_90a) flash attention for prefill: the port of
// the reference's Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py:78).
//
// Computes, for q (B, Sq, H, hd) and k/v (B, Skv, KV, hd) in float32 or
// bfloat16, causal attention with an optional sliding window,
//
//   s[i, j] = (q_i . k_j) * scale,  scale = 1/sqrt(hd),
//   valid   = j <= i  and  (window <= 0 or j > i - window)  and  j < Skv,
//   s       = valid ? s : NEG_INF  (-1e30, finite),
//   out_i   = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
//
// with the running max m and denominator l of the online softmax in
// float32, and the output written in q's dtype.  Query head h reads KV
// head h / (H / KV), as the reference's index_map has it.
//
// What bounds it on an H100: the causal work is 4 * hd * H * pairs
// flops against 2 bytes an element of q, k, v and the output read or
// written once.  At StableLM-2-1.6B's prefill (H = KV = 32, hd = 64) the
// bound is the bytes up to Sq ~ 1100 (5.0 us at Sq = 1024: 16.8 MB over
// 3.35 TB/s, against 4.3 GFLOP over 989 TFLOP/s) and the bf16 tensor
// cores' rate above (17.4 us at Sq = 2048).  Either way the products
// belong on the tensor cores.  At these shapes the time is set by each
// SM's stream of key tiles: two 64 x 64 x hd MMA products, 4096
// exponentials (16 a clock an SM) and the softmax's float32 work a tile,
// which one warp runs in sequence, and by the longest CTA's chain of
// tiles when one wave covers the grid (Sq <= 1024).
//
// Design, bfloat16 (the main path).  One CTA of 4 warps per (64-query
// tile, head, batch); each warp owns 16 query rows.  The Q tile arrives
// in shared memory once and its A fragments (ldmatrix) stay in
// registers for the whole key loop.  64-key K and V tiles stream through
// 2-stage rings in shared memory by cp.async (16 bytes a thread, zeros
// past Skv; rows padded by 16 bytes so that every ldmatrix phase is free
// of bank conflicts), K one tile ahead of V, each issued one tile before
// it is read.  Both products are mma.sync.m16n8k16 on bf16 operands with
// float32 accumulation: S = Q K^T with K as non-transposed ldmatrix
// B-fragments, O += P V with V as transposed ldmatrix B-fragments.  The
// next tile's S = Q K^T is issued to the tensor cores in four parts, each
// followed by a part of this tile's softmax, so that a warp's MMAs
// overlap its exponentials.  The online softmax works on S's
// accumulator fragments in registers (a thread holds 2 rows x 16 keys;
// row max over the 4 lanes of a quad by two shuffles; row sums kept per
// thread and summed over the quad once, at the end); the scale, folded
// with log2(e), and the row max enter one fmaf, and the exponential is
// one ex2.approx.  P goes from the accumulators to the second product's
// A fragments by packing pairs to bf16x2, in registers: no shared memory
// and no barrier between the products.  The one rounding that the
// float32 semantics lack is P to bf16 before P V (2^-9 relative a weight,
// as in SDPA's flash backend); S is exact products of bf16 operands
// summed in float32.  The causal/window mask is applied only on tiles
// that cross a warp's diagonal or window edge, as -inf: a row with no
// valid key yet subtracts 0 instead of its max, so its masked weights
// are 0, and every other masked weight is 0 as exp(-1e30 - m) is.  Query
// tiles run heaviest (last) first, and heads vary fastest in the grid,
// so the long CTAs start in the first wave.  The epilogue multiplies by
// 1 / max(l, 1e-30), stages the warp's bf16 rows in its own rows of the
// now-free Q buffer and writes them with 16-byte stores.
//
// Design, float32 (a dispatch on dtype, kept for the float32 fidelity
// checks; the main path is bf16).  The same tiling on the CUDA cores:
// each thread owns 4 query rows and 8 key columns of the 64 x 64 score
// tile (columns tx, tx+8, ..., so a quarter-warp reads 8 consecutive
// padded K rows without bank conflicts) and the same 4 rows times hd/8
// output dims of the accumulator; the 8 threads sharing a row reduce
// with shuffles; the probabilities pass through shared memory to the
// P.V product; explicit fmaf and expf, no TF32.
//
// Tiles wholly above the diagonal, or wholly before every row's window,
// are skipped.  This changes no result: a skipped tile would add
// exp(-1e30 - m) = 0 to a row that has seen a valid key, and a row whose
// first tiles are fully masked accumulates no weight (bf16) or exp(0)
// weights that the first valid tile's corr = exp(-1e30 - m) = 0 wipes
// exactly (float32).  Ragged Sq and Skv are masked in the kernel (rows
// past Sq are not stored, keys past Skv load as zeros and are masked),
// so prompts need no padding.  The wrapper requires Sq <= Skv, so every
// stored row has a valid key, and every key past Skv lies above the
// diagonal of every stored row.
//
// Head dims 32, 64, 128 and 192.  At hd 192 the bf16 body's Q fragments
// take 48 registers and the output accumulator 96: 255 registers, no
// spills (ptxas -v, CUDA 12.8), and 128,000 bytes of shared memory, so
// one CTA an SM.  Shared memory, bytes: bf16 25,600 / 46,080 / 87,040 /
// 128,000 at hd 32 / 64 / 128 / 192; float32 45,056, 69,632, 118,784,
// 167,936.
//
// Plain C interface, bound from Python with ctypes
// (kernels/flash_attention/ops.py): launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;      // query rows per CTA, 16 a warp (bf16)
constexpr int BK = 64;      // keys per tile
constexpr int NT = 128;     // threads
constexpr int MAX_DEVICES = 64;

// The shared-memory opt-in above 48 KB holds per device and kernel: set
// it on a device's first launch only.
template <typename Kernel>
cudaError_t opt_in_smem(std::atomic<bool> (&done)[MAX_DEVICES],
                        Kernel kernel, size_t bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bfloat16: warp-level tensor-core MMA fed by a cp.async ring
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// Q tile, then 2 stages of K, then 2 stages of V; rows of hd bf16 plus
// 16 bytes of padding.
template <int HD>
constexpr size_t smem_bytes_bf16() {
  return sizeof(bf16) * static_cast<size_t>(BQ + 4 * BK) * (HD + 8);
}

// 2^x in one MUFU instruction (relative error ~2^-22; results below
// 2^-126 flush to 0, and ex2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; zeros when !full
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i holds matrix i's (lane / 4, 2 (lane % 4) + e)
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// the same, transposed: register i holds matrix i's (2 (lane % 4) + e,
// lane / 4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.x4.trans.m8n8.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// d (16x8 float32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo in the low 16 bits: the lower column of an A-fragment pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// Fragment layout of mma.m16n8k16 for lane = 4 g + c: A holds rows g and
// g + 8, columns 2c, 2c + 1 (regs 0, 1) and 2c + 8, 2c + 9 (regs 2, 3);
// B holds rows 2c, 2c + 1 and 2c + 8, 2c + 9 of column g; the float32
// accumulator holds rows g (0, 1) and g + 8 (2, 3), columns 2c, 2c + 1.
// S (16 rows x key blocks nb, nb + 1) = Q K^T over all k-steps: one
// ldmatrix gives the B fragments of both key blocks (matrices: keys 0-7
// x dims 0-7, keys 0-7 x dims 8-15, keys 8-15 x dims 0-7, keys 8-15 x
// dims 8-15); kaddr is this lane's row address in the K tile
template <int HD>
__device__ __forceinline__ void qk_pair(float (&s)[BK / 8][4],
                                        const uint32_t (&qf)[HD / 16][4],
                                        uint32_t kaddr, int nb) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[nb][e] = 0.0f;
    s[nb + 1][e] = 0.0f;
  }
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4(kaddr + static_cast<uint32_t>(sizeof(bf16) * (nb * 8 * LD + ks * 16)),
            b0, b1, b2, b3);
    mma_bf16(s[nb], qf[ks], b0, b1);
    mma_bf16(s[nb + 1], qf[ks], b2, b3);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, HD <= 64 ? 3 : HD <= 128 ? 2 : 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
               int Skv, int H, int KV, int window, float scale_log2) {
  constexpr int LD = HD + 8;   // bf16 per padded shared-memory row
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int ND = HD / 8;   // 8-wide output column blocks
  constexpr int NB = BK / 8;   // 8-wide key blocks of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;      // stages 0, 1
  bf16* Vs = Ks + 2 * BK * LD;  // stages 0, 1

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row
  const int c = lane & 3;   // fragment column pair
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long qs = static_cast<long>(H) * HD;    // row stride of q / o
  const long kvs = static_cast<long>(KV) * HD;  // row stride of k / v
  const bf16* qb = q + static_cast<long>(b) * Sq * qs + static_cast<long>(h) * HD;
  const bf16* kb = k + static_cast<long>(b) * Skv * kvs + static_cast<long>(kvh) * HD;
  const bf16* vb = v + static_cast<long>(b) * Skv * kvs + static_cast<long>(kvh) * HD;
  bf16* ob = o + static_cast<long>(b) * Sq * qs + static_cast<long>(h) * HD;

  // tiles that hold a valid key for some row of this query tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kt_end = q_last / BK;
  int kt_begin = 0;
  if (window > 0) {
    const int k_first = q0 - window + 1;
    kt_begin = k_first > 0 ? k_first / BK : 0;
  }

  // 16-byte copies of the K or V rows of tile kt into a stage; keys past
  // Skv zero
  auto load_tile = [&](const bf16* src, bf16* dst, int kt) {
#pragma unroll
    for (int it = 0; it < BK * CH / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / CH, ch = i % CH, kr = kt * BK + r;
      const bool in = kr < Skv;
      cp_async16(smem_addr(dst + r * LD + ch * 8),
                 src + (in ? kr * kvs : 0) + ch * 8, in);
    }
  };
  // K runs one tile ahead of V: groups {Q, K_first}, {K_first+1, V_first},
  // then one {K_t+2, V_t+1} a tile; tile t's K and V sit in stage
  // (t - kt_begin) & 1
#pragma unroll
  for (int it = 0; it < BQ * CH / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / CH, ch = i % CH, qr = q0 + r;
    const bool in = qr < Sq;
    cp_async16(smem_addr(Qs + r * LD + ch * 8),
               qb + (in ? qr * qs : 0) + ch * 8, in);
  }
  load_tile(kb, Ks, kt_begin);
  cp_async_commit();
  if (kt_begin < kt_end) load_tile(kb, Ks + BK * LD, kt_begin + 1);
  load_tile(vb, Vs, kt_begin);
  cp_async_commit();

  const int wq0 = q0 + warp * 16;  // the warp's first query row
  const int row0 = wq0 + g;        // this thread's rows: row0, row0 + 8
  // this lane's row addresses for the B fragments of K (ldmatrix) and
  // of V (ldmatrix.trans: matrices keys 0-7 x dims 0-7, keys 8-15 x dims
  // 0-7, keys 0-7 x dims 8-15, keys 8-15 x dims 8-15), stage 0
  const uint32_t kaddr0 = smem_addr(
      Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t vaddr0 = smem_addr(
      Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
  constexpr uint32_t STAGE = sizeof(bf16) * BK * LD;  // bytes a stage

  // A fragments of the warp's 16 rows, kept for the whole key loop:
  // matrices (rows 0-7, 8-15) x (columns 0-7, 8-15) of each k-step
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                      (lane >> 4) * 8),
            qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3]);
  float sc[NB][4];  // S of the tile in hand
#pragma unroll
  for (int nb = 0; nb < NB; nb += 2) qk_pair<HD>(sc, qf, kaddr0, nb);

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  // running row max of the scaled scores (log2 domain), -inf until a
  // row meets a valid key
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const uint32_t st = static_cast<uint32_t>(kt - kt_begin) & 1u;
    __syncthreads();  // K_kt's and V_kt-1's stages are read: refill them
    if (kt + 2 <= kt_end) load_tile(kb, Ks + st * BK * LD, kt + 2);
    if (kt + 1 <= kt_end) load_tile(vb, Vs + (st ^ 1u) * BK * LD, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // K_kt+1 and V_kt have landed
    __syncthreads();

    // on tiles crossing the warp's diagonal or window edge, mask: -inf
    // here gives every stored row the weights that the reference's finite
    // -1e30 gives (exp(-1e30 - m) is 0 in float32 once a row has met a
    // valid key, and every stored row has one)
    const int k0 = kt * BK;
    if (k0 + BK - 1 > wq0 || (window > 0 && k0 <= wq0 + 15 - window)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row0 + (e >> 1) * 8;
          const int kpos = k0 + nb * 8 + 2 * c + (e & 1);
          const bool ok = kpos <= qpos && (window <= 0 || kpos > qpos - window);
          if (!ok) sc[nb][e] = -INFINITY;
        }
    }

    // The next tile's S = Q K^T goes to the tensor cores in four parts,
    // each followed by a part of this tile's softmax, so that the MMAs
    // and the exponentials overlap.  On the last tile the next K stage
    // holds stale rows and its S is dropped.  The softmax works on the
    // fragments, rows row0 (i = 0) and row0 + 8: p = 2^(s * scale *
    // log2(e) - m) as one fmaf and one ex2; a row with no valid key yet
    // subtracts 0, so its masked weights are 0.  P becomes the A
    // fragments of P V: key step j takes key blocks 2j (regs 0, 1) and
    // 2j + 1 (regs 2, 3).
    const uint32_t kaddr = kaddr0 + (st ^ 1u) * STAGE;
    float sn[NB][4];
    uint32_t pf[NB / 2][4];
    float corr[2], mu[2];
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      qk_pair<HD>(sn, qf, kaddr, 2 * u);
      if (u == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mx = fmaxf(mx, fmaxf(sc[nb][2 * i], sc[nb][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx * scale_log2);
          mu[i] = m_new == -INFINITY ? 0.0f : m_new;
          corr[i] = ex2(m[i] - mu[i]);
          m[i] = m_new;
        }
      } else {
#pragma unroll
        for (int nb = 3 * u - 3; nb < (3 * u < NB ? 3 * u : NB); ++nb) {
          const float p0 = ex2(fmaf(sc[nb][0], scale_log2, -mu[0]));
          const float p1 = ex2(fmaf(sc[nb][1], scale_log2, -mu[0]));
          const float p2 = ex2(fmaf(sc[nb][2], scale_log2, -mu[1]));
          const float p3 = ex2(fmaf(sc[nb][3], scale_log2, -mu[1]));
          rs[0] += p0 + p1;
          rs[1] += p2 + p3;
          pf[nb >> 1][(nb & 1) * 2] = pack_bf16(p0, p1);
          pf[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }

    // O += P V: B fragments of column blocks n, n + 1 by one transposed
    // ldmatrix
    const uint32_t vaddr = vaddr0 + st * STAGE;
#pragma unroll
    for (int j = 0; j < NB / 2; ++j)
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(vaddr + static_cast<uint32_t>(sizeof(bf16) * (j * 16 * LD + n * 8)),
                  b0, b1, b2, b3);
        mma_bf16(oacc[n], pf[j], b0, b1);
        mma_bf16(oacc[n + 1], pf[j], b2, b3);
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = sn[nb][e];
  }

  // epilogue: the quad's row sums, the division (one reciprocal a row),
  // bf16 rows staged in the warp's own rows of the Q buffer (read only by
  // this warp, into registers, before the loop), then 16-byte stores of
  // rows < Sq
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    inv[i] = 1.0f / fmaxf(li, 1e-30f);
  }
  bf16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Os + g * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / CH, ch = i % CH, qr = wq0 + r;
    if (qr < Sq)
      *reinterpret_cast<uint4*>(ob + qr * qs + ch * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + ch * 8);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int H, int KV, int window, float scale,
                cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes_bf16<HD>();
  if constexpr (bytes > 48 * 1024) {
    static std::atomic<bool> opted[MAX_DEVICES];
    const cudaError_t e = opt_in_smem(opted, flash_fwd_bf16<HD>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  flash_fwd_bf16<HD><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, KV,
      window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TR = 4;       // query rows per thread
constexpr int TC = 8;       // key columns per thread: tx + 8 * c
constexpr int LDP = BK + 4; // padded row of the probability tile

template <int HD>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) *
         static_cast<size_t>(BQ * (HD + 4) + 2 * BK * (HD + 4) + BQ * LDP);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Skv, int H, int KV, int window, float scale) {
  constexpr int LD = HD + 4;   // padded row of the Q/K/V tiles
  constexpr int DC = HD / 32;  // float4 groups of output dims per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // key columns tx + 8c; dims tx*4 + 32g + e
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long qs = static_cast<long>(H) * HD;    // row stride of q / o
  const long kvs = static_cast<long>(KV) * HD;  // row stride of k / v
  const float* qb = q + static_cast<long>(b) * Sq * qs + static_cast<long>(h) * HD;
  const float* kb = k + static_cast<long>(b) * Skv * kvs + static_cast<long>(kvh) * HD;
  const float* vb = v + static_cast<long>(b) * Skv * kvs + static_cast<long>(kvh) * HD;
  float* ob = o + static_cast<long>(b) * Sq * qs + static_cast<long>(h) * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qr = q0 + r;
    Qs[r * LD + d] = qr < Sq ? qb[qr * qs + d] : 0.0f;
  }

  float m[TR], l[TR], acc[TR][DC * 4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.0f;
  }

  // tiles that hold a valid key for some row of this query tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kt_end = q_last / BK;
  int kt_begin = 0;
  if (window > 0) {
    const int k_first = q0 - window + 1;
    kt_begin = k_first > 0 ? k_first / BK : 0;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, kr = k0 + r;
      const bool in = kr < Skv;
      Ks[r * LD + d] = in ? kb[kr * kvs + d] : 0.0f;
      Vs[r * LD + d] = in ? vb[kr * kvs + d] : 0.0f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * TR + i) * LD + d]);
#pragma unroll
      for (int c = 0; c < TC; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 8 * c) * LD + d]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          float a = s[i][c];
          a = fmaf(qv[i].x, kv[c].x, a);
          a = fmaf(qv[i].y, kv[c].y, a);
          a = fmaf(qv[i].z, kv[c].z, a);
          a = fmaf(qv[i].w, kv[c].w, a);
          s[i][c] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q0 + ty * TR + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int kpos = k0 + tx + 8 * c;
        const bool ok = kpos <= qpos && kpos < Skv &&
                        (window <= 0 || kpos > qpos - window);
        s[i][c] = ok ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float p = expf(s[i][c] - m_new);
        Ps[(ty * TR + i) * LDP + tx + 8 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * TR + i) * LDP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < DC; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * LD + tx * 4 + 32 * g]);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][g * 4 + 0] = fmaf(p, vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(p, vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(p, vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(p, vv.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qr = q0 + ty * TR + i;
    if (qr >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < DC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[qr * qs + tx * 4 + 32 * g + e] = acc[i][g * 4 + e] / den;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes_f32<HD>();
  if constexpr (bytes > 48 * 1024) {
    static std::atomic<bool> opted[MAX_DEVICES];
    const cudaError_t e = opt_in_smem(opted, flash_fwd_f32<HD>, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32<HD><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores)
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int window, float scale,
           int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<HD>(q, k, v, o, B, Sq, Skv, H, KV, window, scale,
                          stream);
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, o, B, Sq, Skv, H, KV, window, scale,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Shapes as in the header; every
// tensor contiguous and 16-byte aligned.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int KV, int hd,
                        int window, float scale, int dtype,
                        cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < Sq || KV < 1 || H % KV != 0 || window < 0 ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, Sq, Skv, H, KV, window, scale, dtype,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, window, scale, dtype,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, window, scale, dtype,
                         stream);
    case 192:
      return launch<192>(q, k, v, o, B, Sq, Skv, H, KV, window, scale, dtype,
                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
