// Hand-written Hopper (sm_90a) flash-decode: the port of the reference's
// Pallas kernel `decode_attention`
// (src/repro/kernels/decode_attention/decode_attention.py:66, its
// pallas_call at :81).
//
// Computes, for one query token per sequence q (B, H, hd) against a
// cache k/v (B, S, KV, hd) in float32 or bfloat16 under a validity mask
// valid (S,) (bool bytes),
//
//   s[j]  = valid[j] ? (q . k_j) * scale : NEG_INF  (-1e30, finite),
//   out   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with the online softmax and P.V in float32 and the output in q's
// dtype.  Query head h reads KV head h / (H / KV).  Any S is accepted.  A
// row with no valid key gives the mean of V over the S positions, as the
// reference's softmax over an all -1e30 row does.
//
// What bounds it on an H100: the bytes of the valid K and V, 2 * n_valid
// * KV * hd elements a sequence, at 3.35 TB/s.  The work is 4 hd G
// float32 operations a key (G = H / KV query heads a KV head) against
// 4 hd bytes of bf16 K and V: G operations a byte, under the CUDA cores'
// ridge of ~20 for every G the served models have (1, 5, 12), so the
// tensor cores would buy nothing (and would round P and q to bf16).
//
// Design: split-KV flash-decoding in two launches.
//   1. decode_partial: one CTA of 4 warps per (split, KV head, batch)
//      serves all G query heads of its KV head (at most GMAX = 16; a
//      larger G takes ceil(G / 16) CTAs a KV head), so each valid K/V
//      element is read from device memory once a call.  A split is a run
//      of at most 128 tiles of TK = 32 keys.
//      a. The CTA's G query rows are loaded, 16 bytes a thread, while
//      b. thread t reads tile t's 32 mask bytes as two 16-byte words; a
//         warp ballot compacts the tiles holding a valid key into a list
//         in shared memory.  Only those tiles are read.  q goes to shared
//         memory once, in float32.
//      c. K and V tiles of the list (and each tile's 32 mask bytes) come
//         into a STAGES = 3 ring in shared memory by cp.async, 16 bytes a
//         thread, zeros past S: the first three tiles at once, then each
//         stage refilled as soon as every warp is past its tile, so two
//         tiles' copies are in flight while a tile's scores and P.V run.
//         Rows are padded by 16 bytes, so the lanes' 16-byte reads of 32
//         different rows are free of bank conflicts.
//      d. Scores: lane j owns key j of the tile and warp w a quarter of
//         the dims, hd/4 * w .. hd/4 * (w + 1) - 1: a lane reads that part
//         of its K row in 8-element pieces and takes its dot product with
//         every head's q row (explicit fmaf); the four partial dots meet
//         in shared memory.
//      e. Softmax: warp w owns the heads g = w, w + 4, ...; lane j adds
//         key j's partial dots in a fixed order, masks, and the warp
//         reduces the tile's max and sum by shuffles: (m, l) of head g
//         live in the registers of warp g % 4.  p goes to shared memory
//         as p[key][head], the rescale factor as corr[head].
//      f. P.V: warp w owns keys 8w .. 8w + 7 of the tile and lane i owns
//         output dims hd/32 * i .. hd/32 * (i + 1) - 1 of every head, so
//         a lane holds acc[G_c][hd / 32] in registers: per key one V read
//         (4, 2 or 1 element) feeds G_c * hd / 32 fmaf, with p read four
//         heads at a time as a broadcast.  All warps rescale by the same
//         corr, so their accs add: one reduction across warps through
//         shared memory at the end of the split, into (acc[hd], m, l)
//         per query head.
//      Three barriers a tile: after the copies land (which also frees the
//      stage of the tile before for its refill), after the partial dots,
//      after the softmax.  The heads are padded to the CTA's capacity
//      G_c (1, 8, 12 or 16, the least >= G) with q = 0, and the pad
//      heads go through every step: no inner loop branches on G, so the
//      compiler interleaves the heads' independent chains (a branch per
//      head kept it from doing so; PERF.md, section 6).
//   2. decode_combine: one CTA of 512 threads per (head, batch) merges
//      the splits, M = max m_s, out = sum acc_s e^(m_s - M) / sum l_s
//      e^(m_s - M).  When that sum is 0, no split saw a valid key: the row
//      has none, and the combine returns the mean of V over the S
//      positions.  It is launched as a programmatic dependent of the
//      partial kernel (Hopper's griddepcontrol), so its launch overlaps
//      the partial grid instead of following it.
// The wrapper chooses the number of splits so that B * KV * splits
// reaches 4 CTAs an SM where the cache has enough tiles, and at least
// one on each of the 132 SMs wherever it has that many
// (kernels/decode_attention/ops.py `split_plan`).
//
// Skipping tiles changes no result.  A tile is read iff it holds a valid
// key, so each tile that is read raises m to a valid score: its invalid
// keys (and the zeros past S) get exp(-1e30 - m) = 0 exactly, as do the
// skipped tiles' keys in the reference.  A split with no live tile keeps
// (m, l, acc) = (-1e30, 0, 0), which the combine weighs by
// exp(-1e30 - M) = 0 when any split has a valid key.  The rule is
// emulated in `ref.py` `decode_attention_split_ref`.
//
// Shared memory of decode_partial (bytes; `Smem` below): the ring, 3
// stages of K and V tiles of 32 padded rows, then q in float32, the
// partial dots, p, corr and the tile list:
//   bf16 hd 64: ring 27,648; G_c = 1 (StableLM) 29,184; 8 (Hymba) 35,984;
//   bf16 hd 128: ring 52,224; G_c = 12 (StarCoder2) 67,744;
//   float32 hd 128: ring 101,376; G_c = 16 121,008.
// Above 48 KB (every hd 128 and float32 hd 64 instantiation) the kernel
// opts in by cudaFuncSetAttribute on each device's first launch.
// Registers a thread (ptxas -v, sm_90a, bf16; no spills), hd 64 / 128:
//   G_c = 1: 50 / 50;  8: 80 / 142;  12: 148 / 154;  16: 156 / 196.
// CTAs an SM, the lesser of shared memory's and registers' limits: 7 at
// StableLM's shape (bf16 hd 64, G_c 1; shared memory), 6 at Hymba's (hd
// 64, G_c 8; both), 3 at StarCoder2's (hd 128, G_c 12; both).
//
// Plain C interface, bound from Python with ctypes
// (kernels/decode_attention/ops.py): launches on the caller's stream,
// allocates nothing (the split scratch comes from the wrapper), does not
// synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;          // threads of a partial CTA
constexpr int NW = NT / 32;      // its warps
constexpr int TK = 32;           // keys a tile: one a lane in the scores
constexpr int STAGES = 3;        // tiles in the cp.async ring
constexpr int MAX_TILES = NT;    // tiles a split: one a thread, mask pass
constexpr int GMAX = 16;         // query heads a CTA serves at most
constexpr int CT = 512;          // threads of a combine CTA
constexpr int MAX_DEVICES = 64;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
static_assert(TK == 32, "a tile's keys are a warp's lanes");
static_assert(TK % NW == 0, "P.V splits a tile's keys across the warps");

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a bfloat16 is the high half of a float32
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// 8 consecutive elements (16-byte aligned) as float32
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = bf_lo(w[i]);
    x[2 * i + 1] = bf_hi(w[i]);
  }
}

// N consecutive elements (N * sizeof(T)-byte aligned) as float32
template <int N>
__device__ __forceinline__ void loadn(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void loadn(const __nv_bfloat16* p, float* x) {
  if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(a.x); x[1] = bf_hi(a.x);
    x[2] = bf_lo(a.y); x[3] = bf_hi(a.y);
  } else if constexpr (N == 2) {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(p);
    x[0] = bf_lo(a); x[1] = bf_hi(a);
  } else {
    x[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; only the first `src_bytes` are read, the
// rest of the 16 are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
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

__device__ __forceinline__ uint32_t or4(uint4 w) {
  return w.x | w.y | w.z | w.w;
}

// whether keys j0 .. j0 + TK - 1 (those below S) hold a valid one: the
// mask in 16-byte words (valid is 16-byte aligned, j0 a multiple of 32),
// bytes only in the last word of a ragged cache
__device__ __forceinline__ bool tile_has_valid(const uint8_t* valid, int j0,
                                               int S) {
  uint32_t any = 0;
#pragma unroll
  for (int c = 0; c < TK / 16; ++c) {
    const int j = j0 + 16 * c;
    if (j + 16 <= S) {
      any |= or4(*reinterpret_cast<const uint4*>(valid + j));
    } else {
      for (int i = j; i < S; ++i) any |= valid[i];
    }
  }
  return any != 0;
}

// byte offsets of decode_partial's dynamic shared memory
template <typename T, int HD, int GC>
struct Smem {
  static constexpr int ESZ = static_cast<int>(sizeof(T));
  static constexpr int LD = HD + 16 / ESZ;  // a K or V row, padded
  // row of p: a key's heads, padded so that the lanes' writes of one
  // head spread over 8 banks (4-way conflicts at most)
  static constexpr int PS = GC == 1 ? 1 : GC % 8 == 0 ? GC + 4 : GC + 8;
  static constexpr int TILE = TK * LD * ESZ;
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int RED = NW * GC * HD * 4;  // the warps' accs, at the end
  static constexpr int Q = 0;                   // float q[GC][HD]
  static constexpr int KV = Q + GC * HD * 4;    // T k, v [TK][LD] a stage
  static constexpr int MASK = KV + (RING > RED ? RING : RED);  // u8 [ST][TK]
  static constexpr int DOT = MASK + STAGES * TK;    // float [NW][GC][TK]
  static constexpr int P = DOT + NW * GC * TK * 4;  // float p[TK][PS]
  static constexpr int CORR = P + (TK * PS * 4 + 15) / 16 * 16;  // float [GC]
  static constexpr int LIST = CORR + (GC * 4 + 15) / 16 * 16;  // int [128]
  static constexpr int CNT = LIST + MAX_TILES * 4;             // int [NW]
  static constexpr int BYTES = CNT + NW * 4;
};

// 16 bytes of T (8 bf16 or 4 float32) to float32 in shared memory
__device__ __forceinline__ void store_f32(float* dst, uint4 w, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(w.x), __uint_as_float(w.y), __uint_as_float(w.z),
      __uint_as_float(w.w));
}
__device__ __forceinline__ void store_f32(float* dst, uint4 w,
                                          __nv_bfloat16) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(bf_lo(w.z), bf_hi(w.z), bf_lo(w.w), bf_hi(w.w));
}

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(NT)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ valid,
               float* __restrict__ part, int S, int H, int KV, int n_split,
               int tiles_per_split, int n_gchunk, float scale) {
  using L = Smem<T, HD, GC>;
  constexpr int DPL = HD / 32;             // output dims a lane owns in P.V
  constexpr int DQ = HD / NW;              // dims a warp owns in the scores
  constexpr int HPW = (GC + NW - 1) / NW;  // head slots a warp owns, softmax
  static_assert(GC == 1 || GC % NW == 0, "heads pad to a multiple of 4");
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int CPR = HD / EPC;            // 16-byte copies a row
  constexpr int KPW = TK / NW;             // keys a warp takes in P.V
  constexpr int QV = GC * HD / EPC;        // 16-byte pieces of the q rows
  constexpr int QPT = (QV + NT - 1) / NT;  // ... a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::Q);
  T* kv_s = reinterpret_cast<T*>(smem + L::KV);
  float* red_s = reinterpret_cast<float*>(smem + L::KV);
  uint8_t* mask_s = smem + L::MASK;
  float* dot_s = reinterpret_cast<float*>(smem + L::DOT);
  float* p_s = reinterpret_cast<float*>(smem + L::P);
  float* corr_s = reinterpret_cast<float*>(smem + L::CORR);
  int* list_s = reinterpret_cast<int*>(smem + L::LIST);
  int* cnt_s = reinterpret_cast<int*>(smem + L::CNT);

  // the combine may launch now: it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_gchunk;
  const int G = H / KV, g0 = (blockIdx.y % n_gchunk) * GC;
  const int gc = min(GC, G - g0);  // query heads of this CTA
  const int h0 = kvh * G + g0;     // the first of them
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (S + TK - 1) / TK;
  const int t0 = split * tiles_per_split;
  const int nt = min(tiles_per_split, n_tiles - t0);
  const long hs = static_cast<long>(n_split) * (HD + 2);  // head stride
  float* out0 = part + ((static_cast<long>(b) * H + h0) * n_split + split) *
                           (HD + 2);

  // a. the CTA's q rows, 16 bytes a thread, in flight with the mask pass
  const T* qb = q + (static_cast<long>(b) * H + h0) * HD;
  uint4 q_r[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * NT;
    q_r[u] = i < QV && i * EPC / HD < gc
                 ? *reinterpret_cast<const uint4*>(qb + i * EPC)
                 : make_uint4(0u, 0u, 0u, 0u);
  }

  // b. the split's tiles that hold a valid key, in order
  const bool live = tid < nt && tile_has_valid(valid, (t0 + tid) * TK, S);
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) cnt_s[warp] = __popc(bal);
  __syncthreads();
  int off = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    off += w < warp ? cnt_s[w] : 0;
    n_live += cnt_s[w];
  }
  if (n_live == 0) {  // uniform: no valid key in the split
    for (int i = tid; i < gc * (HD + 2); i += NT) {
      const int g = i / (HD + 2), d = i % (HD + 2);
      out0[g * hs + d] = d == HD ? NEG_INF : 0.0f;
    }
    return;
  }
  if (live) list_s[off + __popc(bal & ((1u << lane) - 1u))] = t0 + tid;
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * NT;
    if (i < QV) store_f32(q_s + i * EPC, q_r[u], T());
  }
  __syncthreads();  // list_s, q_s

  // c. the ring: tile i of the list into stage i % STAGES
  const long rs = static_cast<long>(KV) * HD;  // row stride of k / v
  const long kv0 = static_cast<long>(b) * S * rs + static_cast<long>(kvh) * HD;
  const T* kb = k + kv0;
  const T* vb = v + kv0;
  auto issue = [&](int i) {
    const int st = i % STAGES;
    const int j0 = list_s[i] * TK;
    T* ks = kv_s + st * 2 * TK * L::LD;
    T* vs = ks + TK * L::LD;
    for (int c = tid; c < TK * CPR; c += NT) {
      const int r = c / CPR, ch = c % CPR;
      const bool in = j0 + r < S;
      const long src = (in ? j0 + r : j0) * rs + ch * EPC;
      cp_async16(ks + r * L::LD + ch * EPC, kb + src, in ? 16 : 0);
      cp_async16(vs + r * L::LD + ch * EPC, vb + src, in ? 16 : 0);
    }
    if (tid < TK / 16) {
      const int j = j0 + 16 * tid;
      const int n = min(max(S - j, 0), 16);
      cp_async16(mask_s + st * TK + 16 * tid, valid + (n > 0 ? j : 0), n);
    }
  };

  // head slots of this warp in the softmax: g = warp + NW * t, t < HPW
  // (with GC = 1 only warp 0 has one).  Pad heads (gc <= g < GC,
  // q = 0) run through every step like the others, so that no inner
  // loop branches on the head count; only their results are not written.
  float m[HPW], l[HPW], acc[GC][DPL];
#pragma unroll
  for (int t = 0; t < HPW; ++t) {
    m[t] = NEG_INF;
    l[t] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.0f;

  // every stage filled at once; then, from tile 1 on, the stage of tile
  // i - 1 is refilled with tile i - 1 + STAGES once every warp is past it
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n_live) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_live; ++i) {
    // this thread's copies of tile i: STAGES groups are committed before
    // tile 0, one more before each later tile
    if (i == 0)
      cp_async_wait<STAGES - 1>();
    else
      cp_async_wait<STAGES - 2>();
    __syncthreads();  // everyone's; and every warp is past tile i - 1
    if (i > 0) {
      if (i - 1 + STAGES < n_live) issue(i - 1 + STAGES);
      cp_async_commit();
    }
    const int st = i % STAGES;
    const T* ks = kv_s + st * 2 * TK * L::LD;
    const T* vs = ks + TK * L::LD;

    // d. partial scores: key `lane`, dims DQ * warp .., every head
    {
      float dot[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) dot[g] = 0.0f;
      const T* kr = ks + lane * L::LD + warp * DQ;
#pragma unroll
      for (int c = 0; c < DQ / 8; ++c) {
        float x[8];
        load8(kr + 8 * c, x);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float y[8];
          load8(q_s + g * HD + warp * DQ + 8 * c, y);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[g] = fmaf(y[e], x[e], dot[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) dot_s[(warp * GC + g) * TK + lane] = dot[g];
    }
    __syncthreads();

    // e. the online softmax of the warp's heads, key `lane`
    if (warp < GC) {  // every warp unless GC = 1
      const bool ok = mask_s[st * TK + lane] != 0;
#pragma unroll
      for (int t = 0; t < HPW; ++t) {
        const int g = warp + NW * t;
        float dot = dot_s[g * TK + lane];
#pragma unroll
        for (int w = 1; w < NW; ++w) dot += dot_s[(w * GC + g) * TK + lane];
        const float s = ok ? dot * scale : NEG_INF;
        const float m_new = fmaxf(m[t], warp_max(s));
        const float corr = expf(m[t] - m_new);
        const float p = expf(s - m_new);
        l[t] = l[t] * corr + warp_sum(p);
        m[t] = m_new;
        p_s[lane * L::PS + g] = p;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

    // f. P.V: keys KPW * warp .., dims DPL * lane .., every head
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float c = corr_s[g];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= c;
    }
#pragma unroll
    for (int r = 0; r < KPW; ++r) {
      const int jr = warp * KPW + r;
      float x[DPL];
      loadn<DPL>(vs + jr * L::LD + lane * DPL, x);
      if constexpr (GC == 1) {
        const float pj = p_s[jr];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[0][e] = fmaf(pj, x[e], acc[0][e]);
      } else {
#pragma unroll
        for (int g4 = 0; g4 < GC / 4; ++g4) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(p_s + jr * L::PS + 4 * g4);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < DPL; ++e)
              acc[4 * g4 + u][e] = fmaf(pv[u], x[e], acc[4 * g4 + u][e]);
        }
      }
    }
    // the next tile's first barrier orders its writes of dot_s, p_s,
    // corr_s and its refill of this stage after these reads
  }
  cp_async_wait<0>();  // only empty groups are left: the ring is free
  __syncthreads();     // every warp is done with the last tile

  // the warps' accs add: one reduction through the ring's memory, laid
  // out [warp][head][e][lane] so that neither side has bank conflicts
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      red_s[((warp * GC + g) * DPL + e) * 32 + lane] = acc[g][e];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < (GC * HD + NT - 1) / NT; ++u) {
    const int i = tid + u * NT;  // (head, e, lane) of the output
    if (i < gc * HD) {
      float a = red_s[i];
#pragma unroll
      for (int w = 1; w < NW; ++w) a += red_s[w * GC * HD + i];
      const int g = i / HD, r = i % HD;
      out0[g * hs + (r % 32) * DPL + r / 32] = a;
    }
  }
  if (lane == 0 && warp < GC) {
#pragma unroll
    for (int t = 0; t < HPW; ++t) {
      const int g = warp + NW * t;
      if (g < gc) {
        out0[g * hs + HD] = m[t];
        out0[g * hs + HD + 1] = l[t];
      }
    }
  }
}

// One CTA per (head, batch), launched as a programmatic dependent of the
// partial kernel (its launch overlaps that grid; griddepcontrol.wait
// holds it until the grid is done and its writes are visible).  Warp
// (sp, d / 32) merges dims d of the splits sp, sp + NSP, ... in batches
// of 32, all loads of a batch in flight together.  A batch of at most
// 4 splits merges split by split, two exps a split and lane.  In a
// larger one lane u loads (m, l) of the batch's u-th split and every
// lane its dim of each split's acc; the batch's max by shuffles, one exp
// a lane for the weight f_u = exp(m_u - M_b), handed to the other lanes
// by shuffles.  Batches merge by the online rule, and the NSP warps'
// sums of a dim in shared memory.
template <typename T, int HD>
__global__ void __launch_bounds__(CT)
decode_combine(const float* __restrict__ part, const T* __restrict__ v,
               T* __restrict__ o, int S, int H, int KV, int n_split) {
  constexpr int NSP = CT / HD;  // split lanes of a dim
  __shared__ float a_s[CT], m_s[NSP], l_s[NSP];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int sp = tid / HD, d = tid % HD, lane = tid & 31;
  const float* pp = part + (static_cast<long>(b) * H + h) * n_split * (HD + 2);
  float M = NEG_INF, L = 0.0f, A = 0.0f;
  for (int b0 = sp; b0 < n_split; b0 += 32 * NSP) {
    const int nb = min(32, (n_split - b0 + NSP - 1) / NSP);  // warp-uniform
    float Mb, Ab = 0.0f, Lb = 0.0f;
    if (nb <= 4) {  // few splits: loaded together, merged one by one
      float mv[4], lv[4], av[4];  // an absent split weighs nothing
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* ps = pp + (b0 + NSP * u) * (HD + 2);
        mv[u] = u < nb ? ps[HD] : NEG_INF;
        lv[u] = u < nb ? ps[HD + 1] : 0.0f;
        av[u] = u < nb ? ps[d] : 0.0f;
      }
      Mb = NEG_INF;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float Mn = fmaxf(Mb, mv[u]);
        const float c = expf(Mb - Mn), f = expf(mv[u] - Mn);
        Ab = fmaf(av[u], f, Ab * c);
        Lb = fmaf(lv[u], f, Lb * c);
        Mb = Mn;
      }
    } else {
      const int su = b0 + NSP * lane;
      const float mu = lane < nb ? pp[su * (HD + 2) + HD] : NEG_INF;
      const float lu = lane < nb ? pp[su * (HD + 2) + HD + 1] : 0.0f;
      Mb = warp_max(mu);
      const float fu = lane < nb ? expf(mu - Mb) : 0.0f;
      Lb = warp_sum(lu * fu);
#pragma unroll 8
      for (int u = 0; u < nb; ++u)
        Ab = fmaf(pp[(b0 + NSP * u) * (HD + 2) + d],
                  __shfl_sync(0xffffffffu, fu, u), Ab);
    }
    const float Mn = fmaxf(M, Mb), c = expf(M - Mn), fb = expf(Mb - Mn);
    A = A * c + Ab * fb;
    L = L * c + Lb * fb;
    M = Mn;
  }
  a_s[tid] = A;
  if (d == 0) {
    m_s[sp] = M;
    l_s[sp] = L;
  }
  __syncthreads();
  if (sp != 0) return;
  float Mx = m_s[0];
#pragma unroll
  for (int i = 1; i < NSP; ++i) Mx = fmaxf(Mx, m_s[i]);
  float a = 0.0f;
  L = 0.0f;
#pragma unroll
  for (int i = 0; i < NSP; ++i) {
    const float f = expf(m_s[i] - Mx);
    a = fmaf(a_s[i * HD + d], f, a);
    L = fmaf(l_s[i], f, L);
  }
  if (L == 0.0f) {  // no valid key in the row: the mean of V
    const long rs = static_cast<long>(KV) * HD;
    const T* vb = v + static_cast<long>(b) * S * rs +
                  static_cast<long>(h / (H / KV)) * HD + d;
    a = 0.0f;
    for (int j = 0; j < S; ++j) a += to_f32<T>(vb[j * rs]);
    a /= static_cast<float>(S);
  } else {
    a /= L;
  }
  o[(static_cast<long>(b) * H + h) * HD + d] = from_f32<T>(a);
}

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

template <typename T, int HD, int GC>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           float* part, void* o, int B, int S, int H, int KV, int n_split,
           int tiles_per_split, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<T, HD, GC>::BYTES;
  const auto kernel = decode_partial<T, HD, GC>;
  if (bytes > SMEM_DEFAULT) {
    static std::atomic<bool> done[MAX_DEVICES];
    const cudaError_t e = opt_in_smem(done, kernel, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_gchunk = (H / KV + GC - 1) / GC;
  if (static_cast<long>(KV) * n_gchunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(n_split, KV * n_gchunk, B), NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, part, S, H, KV, n_split,
      tiles_per_split, n_gchunk, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void (*combine)(const float*, const T*, T*, int, int, int, int) =
      decode_combine<T, HD>;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, combine, static_cast<const float*>(part),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, n_split));
}

template <typename T, int HD>
int dispatch_group(const void* q, const void* k, const void* v,
                   const uint8_t* valid, float* part, void* o, int B, int S,
                   int H, int KV, int n_split, int tiles_per_split,
                   float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G == 1)
    return launch<T, HD, 1>(q, k, v, valid, part, o, B, S, H, KV, n_split,
                            tiles_per_split, scale, stream);
  if (G <= 8)
    return launch<T, HD, 8>(q, k, v, valid, part, o, B, S, H, KV, n_split,
                            tiles_per_split, scale, stream);
  if (G <= 12)
    return launch<T, HD, 12>(q, k, v, valid, part, o, B, S, H, KV, n_split,
                             tiles_per_split, scale, stream);
  return launch<T, HD, GMAX>(q, k, v, valid, part, o, B, S, H, KV, n_split,
                             tiles_per_split, scale, stream);
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const uint8_t* valid, float* part, void* o, int B, int S,
                int H, int KV, int hd, int n_split, int tiles_per_split,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return dispatch_group<T, 32>(q, k, v, valid, part, o, B, S, H, KV,
                                   n_split, tiles_per_split, scale, stream);
    case 64:
      return dispatch_group<T, 64>(q, k, v, valid, part, o, B, S, H, KV,
                                   n_split, tiles_per_split, scale, stream);
    case 128:
      return dispatch_group<T, 128>(q, k, v, valid, part, o, B, S, H, KV,
                                    n_split, tiles_per_split, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part: B * H * n_split * (hd + 2)
// float32 scratch.  valid: 16-byte aligned.  The splits must cover every
// tile of 32 keys exactly, at most 128 tiles each:
// n_split = ceil(ceil(S / 32) / tiles_per_split).
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const uint8_t* valid, float* part, void* o, int B,
                         int S, int H, int KV, int hd, int n_split,
                         int tiles_per_split, float scale, int dtype,
                         cudaStream_t stream) {
  const int n_tiles = (S + TK - 1) / TK;
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || tiles_per_split < 1 ||
      tiles_per_split > MAX_TILES ||
      n_split != (n_tiles + tiles_per_split - 1) / tiles_per_split ||
      H > 65535 || B > 65535 || reinterpret_cast<uintptr_t>(valid) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, valid, part, o, B, S, H, KV, hd,
                              n_split, tiles_per_split, scale, stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, valid, part, o, B, S, H, KV,
                                      hd, n_split, tiles_per_split, scale,
                                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int decode_attention_block(void) { return TK; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
