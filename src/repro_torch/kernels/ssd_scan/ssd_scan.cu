// Hand-written Hopper (sm_90a) SSD intra-chunk step: the port of the
// reference's Pallas kernel `ssd_intra`
// (src/repro/kernels/ssd_scan/ssd_scan.py).
//
// Computes, per (batch b, chunk c, head h) with chunk length Q, head dim
// P and state size N, from xc (B,nc,Q,H,P), Bc/Cc (B,nc,Q,N) and
// dtc/cum (B,nc,Q,H), all float32:
//
//   W[t,s]  = (C_t . B_s) * exp(cum_t - cum_s) * dt_s   for s <= t, else 0
//   y[t,:]  = sum_s W[t,s] x_s                          -> (B,nc,Q,H,P)
//   st[p,n] = sum_s (x_s[p] * exp(cum_{Q-1} - cum_s) * dt_s) B_s[n]
//                                                       -> (B,nc,H,P,N)
//
// in float32 on the CUDA cores (explicit fmaf, no tensor cores, no TF32),
// as the reference computes it.  Terms with s > t are skipped, not
// computed and zeroed: the reference's exp(-1e9) is exactly 0 there, and
// for s <= t the exponent cum_t - cum_s <= 0 cannot overflow.
//
// Design: one CTA of 256 threads per (head, chunk, batch), everything
// staged in dynamic shared memory (135,680 bytes, above the 48 KB default,
// so the first launch on a device opts in):
//   1. cum and dt of the head, and the state weights tail_s =
//      exp(cum_{Q-1} - cum_s) dt_s; x of the head (Q x P);
//   2. over N in tiles of 32 columns: C and B of the tile, transposed to
//      [n][t] so that a thread reads 8 consecutive rows as two float4s.
//      A thread owns an 8 x 8 patch of the Q x Q matrix C.B^T and adds
//      the tile's products to it (patches wholly above the diagonal are
//      skipped); each warp then reduces the tile's 4 state columns it
//      owns over the Q rows, lanes on consecutive p;
//   3. the patches become W (decay, dt_s, mask) in shared memory,
//      transposed to [s][t];
//   4. y = W x, a thread owning 8 rows x 4 head dims, the sum over s
//      stopping at its last row (the causal half).
// Q may be anything from 1 to 128 (a prompt shorter than the chunk gives
// a short chunk); rows past Q and columns past N are zero in shared
// memory and never stored.
//
// What bounds it on an H100: operations.  At Mamba2-780M's geometry
// (Q 128, H 48, P 64, N 128) a 1024-token prompt needs ~1.2 GFLOP
// (C.B^T once per chunk, W x and the state per head) against ~39 MB of
// inputs and outputs, so float32's 67 TFLOP/s sets the bound.  This
// kernel recomputes C.B^T for every head, as the Pallas kernel does
// (48x that product's work); sharing it across heads and running the
// products on the tensor cores are later speed work.
//
// Plain C interface, bound from Python with ctypes
// (kernels/ssd_scan/ops.py): launches on the caller's stream, allocates
// nothing, does not synchronise, returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int QM = 128;     // largest chunk length
constexpr int PM = 64;      // largest head dim
constexpr int NK = 32;      // state columns a tile
constexpr int NT = 256;     // threads of a CTA
constexpr int NW = NT / 32;
constexpr int LD = QM + 4;  // row stride (floats) of the [n][t] / [s][t] tiles
constexpr int SMEM_FLOATS = 2 * NK * LD + QM * PM + QM * LD + 3 * QM;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(NW * 4 == NK, "each warp owns 4 state columns of a tile");
static_assert(PM == 64, "lanes own head dims lane and lane + 32");

constexpr int MAX_DEVICES = 64;
std::atomic<bool> smem_opted_in[MAX_DEVICES];

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void __launch_bounds__(NT)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ dt,
                 const float* __restrict__ cum, float* __restrict__ y,
                 float* __restrict__ st, int nc, int Q, int H, int P,
                 int N) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;              // [NK][LD]  C of the tile, [n][t]
  float* bs = cs + NK * LD;      // [NK][LD]  B of the tile, [n][s]
  float* xs = bs + NK * LD;      // [QM][PM]  x of the head, [s][p]
  float* wt = xs + QM * PM;      // [QM][LD]  W, [s][t]
  float* cum_s = wt + QM * LD;   // [QM]
  float* dt_s = cum_s + QM;      // [QM]
  float* tail_s = dt_s + QM;     // [QM]

  const int h = blockIdx.x;
  const long bc = static_cast<long>(blockIdx.z) * nc + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row t of the chunk: x and y at ((bc Q + t) H + h) P, B and C at
  // (bc Q + t) N, dt and cum at (bc Q + t) H + h; the state at
  // ((bc H + h) P + p) N + n

  // ---- 1. the head's cum, dt, state weights and x
  for (int t = tid; t < QM; t += NT) {
    const bool in = t < Q;
    cum_s[t] = in ? cum[(bc * Q + t) * H + h] : 0.0f;
    dt_s[t] = in ? dt[(bc * Q + t) * H + h] : 0.0f;
  }
  for (int i = tid; i < QM * PM; i += NT) {
    const int t = i / PM, p = i % PM;
    xs[i] = (t < Q && p < P) ? x[((bc * Q + t) * H + h) * P + p] : 0.0f;
  }
  __syncthreads();
  for (int t = tid; t < QM; t += NT)
    tail_s[t] = t < Q ? expf(cum_s[Q - 1] - cum_s[t]) * dt_s[t] : 0.0f;

  // ---- 2. C.B^T patches and the state, tile by tile over N
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = ty * 8, s0 = tx * 8;
  const bool patch = tx <= ty && t0 < Q;  // not wholly above the diagonal
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += NK) {
    const int nk = min(NK, N - n0);
    for (int i = tid; i < QM * NK; i += NT) {
      const int t = i / NK, n = i % NK;
      const bool in = t < Q && n < nk;
      const long g = (bc * Q + t) * N + n0 + n;
      cs[n * LD + t] = in ? Cm[g] : 0.0f;
      bs[n * LD + t] = in ? Bm[g] : 0.0f;
    }
    __syncthreads();  // also publishes tail_s on the first tile

    if (patch) {
      for (int n = 0; n < nk; ++n) {
        float cr[8], br[8];
        load8(cs + n * LD + t0, cr);
        load8(bs + n * LD + s0, br);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
      }
    }

    // the warp's 4 columns of the tile, lanes on head dims lane, lane+32
    float sa[2][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) sa[0][k] = sa[1][k] = 0.0f;
    const float* bw = bs + warp * 4 * LD;
    for (int s = 0; s < Q; ++s) {
      const float tw = tail_s[s];
      const float a0 = xs[s * PM + lane] * tw;
      const float a1 = xs[s * PM + lane + 32] * tw;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float bv = bw[k * LD + s];
        sa[0][k] = fmaf(a0, bv, sa[0][k]);
        sa[1][k] = fmaf(a1, bv, sa[1][k]);
      }
    }
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const int p = lane + 32 * pi;
      if (p >= P) continue;
      float* out = st + ((bc * H + h) * P + p) * N + n0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (warp * 4 + k < nk) out[warp * 4 + k] = sa[pi][k];
    }
    __syncthreads();  // the next tile overwrites cs and bs
  }

  // ---- 3. W = (C.B^T) * decay * dt_s on and below the diagonal
  if (patch) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + i;
      const float ct = cum_s[t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = s0 + j;
        wt[s * LD + t] = (s <= t && t < Q)
                             ? acc[i][j] * expf(ct - cum_s[s]) * dt_s[s]
                             : 0.0f;
      }
    }
  }
  __syncthreads();

  // ---- 4. y = W x: rows t0..t0+7, head dims p0..p0+3, s up to the last row
  const int p0 = tx * 4;
  if (t0 < Q && p0 < P) {
    float ya[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[i][e] = 0.0f;
    const int s_end = min(t0 + 8, Q);
    for (int s = 0; s < s_end; ++s) {
      float wr[8];
      load8(wt + s * LD + t0, wr);
      const float4 xv = *reinterpret_cast<const float4*>(xs + s * PM + p0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ya[i][0] = fmaf(wr[i], xv.x, ya[i][0]);
        ya[i][1] = fmaf(wr[i], xv.y, ya[i][1]);
        ya[i][2] = fmaf(wr[i], xv.z, ya[i][2]);
        ya[i][3] = fmaf(wr[i], xv.w, ya[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + i;
      if (t < Q)
        *reinterpret_cast<float4*>(y + ((bc * Q + t) * H + h) * P + p0) =
            make_float4(ya[i][0], ya[i][1], ya[i][2], ya[i][3]);
    }
  }
}

}  // namespace

extern "C" {

// All pointers float32 and 16-byte aligned; 1 <= Q <= 128, P <= 64 and a
// multiple of 4 (so that rows of x and y are float4-aligned).
int ssd_intra_fwd(const float* x, const float* Bm, const float* Cm,
                  const float* dt, const float* cum, float* y, float* st,
                  int B, int nc, int Q, int H, int P, int N,
                  cudaStream_t stream) {
  if (B < 1 || nc < 1 || Q < 1 || Q > QM || H < 1 || P < 4 || P > PM ||
      P % 4 != 0 || N < 1 || nc > 65535 || B > 65535)
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
  ssd_intra_kernel<<<dim3(H, nc, B), NT, SMEM_BYTES, stream>>>(
      x, Bm, Cm, dt, cum, y, st, nc, Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

int ssd_intra_max_q(void) { return QM; }

int ssd_intra_max_p(void) { return PM; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
