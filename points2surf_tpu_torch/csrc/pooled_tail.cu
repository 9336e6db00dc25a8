// Train-mode pooled-tail reductions: for c = x @ W + b over a ragged point
// axis, six per-(batch row, channel) reductions in one pass, with c never
// written to device memory:
//
//   cmax, amax   max over p < n and its first arg index
//   cmin, amin   min over p < n and its first arg index
//   rsum, rsq    sum and sum of squares over p < n (sum pool, BN statistics)
//
// Replaces the TPU kernel points2surf_tpu/ops/pallas/train_tail.py (_kernel,
// reached through pooled_tail_reductions / _pooled_tail_reductions).
// Numerics class: fp32 operands, fp32 accumulation (P2S_PALLAS_TAIL_PREC=
// highest there); the bf16-operand mode is not ported.
//
// What bounds it on an H100: arithmetic. The conv3 tail of a train forward
// is x (B, n, 128) @ W (128, C): n * 128 FMAs per output against one read
// of x; the literal version would write and re-read a (B, n, C) activation
// (f32[1000, 1300, 1024] = 5.3 GB for the point-STN tail at batch 1000).
//
// Design: the layer-3 loop of chain_pool.cu. Grid = (batch row, C tile of
// 256); a block stages its W tile (128 x 256, 128 KB) and bias in shared
// memory, walks the point axis in chunks of 64 points (transposed into
// [channel][point], row stride 68), and each thread keeps the six running
// reductions of its 8 columns in registers over its 8 rows of every chunk.
// Rows past n are masked. Ties keep the first index (strict compares in row
// order inside a thread; the eight row groups interleave, so their partial
// results combine as (value, index) pairs, lower index on equal values).

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tile_product.cuh"

namespace {

constexpr int CIN = 128;  // conv2 width feeding every conv3 tail
constexpr int TC = 256;   // C columns per block
constexpr int THREADS = 256;
constexpr int RG = 8;     // row groups (8 rows each) of a 64-point chunk

// shared-memory layout, in floats
constexpr int OFF_W = 0;                   // [CIN][TC]
constexpr int OFF_X = OFF_W + CIN * TC;    // [CIN][NPS] x chunk, then partials
constexpr int OFF_B = OFF_X + CIN * NPS;   // [TC] bias
constexpr int SMEM_BYTES = (OFF_B + TC) * 4;  // 166,912 of 232,448
static_assert(SMEM_BYTES <= 232448, "shared memory over the sm_90 limit");
static_assert(4 * RG * TC <= CIN * NPS, "partials must fit in the x buffer");
static_assert(THREADS == TC, "one thread per column in the combine");

__global__ void __launch_bounds__(THREADS, 1)
pooled_tail_kernel(const float* __restrict__ x, int n,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   int cout, float* __restrict__ cmax, int* __restrict__ amax,
                   float* __restrict__ cmin, int* __restrict__ amin,
                   float* __restrict__ rsum, float* __restrict__ rsq) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem + OFF_W;
  float* xt = smem + OFF_X;
  float* bs = smem + OFF_B;

  const int b = blockIdx.x;
  const int col0 = blockIdx.y * TC;
  const int tid = threadIdx.x;

  for (int i = tid; i < CIN * TC; i += THREADS) {
    const int k = i / TC;
    const int col = col0 + (i - k * TC);
    Ws[i] = col < cout ? w[(size_t)k * cout + col] : 0.f;
  }
  for (int i = tid; i < TC; i += THREADS) {
    const int col = col0 + i;
    bs[i] = col < cout ? bias[col] : 0.f;
  }

  const int rg = tid / 32, cg = tid % 32;  // 8x8 thread tiles of 64x256
  float mx[8], mn[8], s[8], q[8];
  int ax[8], an[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[j] = -CUDART_INF_F;
    mn[j] = CUDART_INF_F;
    ax[j] = INT_MAX;
    an[j] = INT_MAX;
    s[j] = 0.f;
    q[j] = 0.f;
  }

  const float* xb = x + (size_t)b * n * CIN;
  for (int p0 = 0; p0 < n; p0 += NP) {
    __syncthreads();  // staging done / previous chunk's product left xt
    for (int i = tid; i < NP * CIN; i += THREADS) {
      const int r = i / CIN;
      const int ci = i - r * CIN;
      xt[ci * NPS + r] = (p0 + r < n) ? xb[(size_t)p0 * CIN + i] : 0.f;
    }
    __syncthreads();
    float acc[8][8];
    tile_product<TC, 8, 8>(xt, Ws, CIN, rg, cg, acc);
    const int row0 = p0 + rg * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bj = bs[cg + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (row0 + i < n) {
          const float v = acc[i][j] + bj;
          if (v > mx[j]) {
            mx[j] = v;
            ax[j] = row0 + i;
          }
          if (v < mn[j]) {
            mn[j] = v;
            an[j] = row0 + i;
          }
          s[j] += v;
          q[j] = fmaf(v, v, q[j]);
        }
      }
    }
  }

  // combine the eight row groups' partials, one column per thread
  __syncthreads();
  float* pmx = xt;                                  // [RG][TC]
  int* pax = reinterpret_cast<int*>(xt + RG * TC);  // [RG][TC]
  float* pmn = xt + 2 * RG * TC;
  int* pan = reinterpret_cast<int*>(xt + 3 * RG * TC);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = rg * TC + cg + 32 * j;
    pmx[o] = mx[j];
    pax[o] = ax[j];
    pmn[o] = mn[j];
    pan[o] = an[j];
  }
  __syncthreads();
  const int col = col0 + tid;
  const size_t out = (size_t)b * cout + col;
  if (col < cout) {
    float vmax = pmx[tid], vmin = pmn[tid];
    int imax = pax[tid], imin = pan[tid];
    for (int r = 1; r < RG; ++r) {
      const float u = pmx[r * TC + tid];
      const int iu = pax[r * TC + tid];
      if (u > vmax || (u == vmax && iu < imax)) {
        vmax = u;
        imax = iu;
      }
      const float l = pmn[r * TC + tid];
      const int il = pan[r * TC + tid];
      if (l < vmin || (l == vmin && il < imin)) {
        vmin = l;
        imin = il;
      }
    }
    cmax[out] = vmax;
    amax[out] = imax == INT_MAX ? 0 : imax;
    cmin[out] = vmin;
    amin[out] = imin == INT_MAX ? 0 : imin;
  }
  __syncthreads();
  float* ps = xt;  // [RG][TC]
  float* pq = xt + RG * TC;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = rg * TC + cg + 32 * j;
    ps[o] = s[j];
    pq[o] = q[j];
  }
  __syncthreads();
  if (col < cout) {
    float vs = ps[tid], vq = pq[tid];
    for (int r = 1; r < RG; ++r) {
      vs += ps[r * TC + tid];
      vq += pq[r * TC + tid];
    }
    rsum[out] = vs;
    rsq[out] = vq;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All arrays are contiguous on the
// current device: x (batch, n, cin) fp32 with cin == 128, w (cin, cout) and
// b (cout,) fp32; outputs (batch, cout): cmax, cmin, rsum, rsq fp32, amax,
// amin int32. Returns a cudaError_t; 0 means launched.
extern "C" int p2s_pooled_tail(const void* x, int batch, int n, int cin,
                               const void* w, const void* b, int cout,
                               void* cmax, void* amax, void* cmin, void* amin,
                               void* rsum, void* rsq, void* stream) {
  if (cin != CIN || n < 1 || batch < 1 || cout < 1 ||
      (cout + TC - 1) / TC > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      pooled_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (cout + TC - 1) / TC);
  pooled_tail_kernel<<<grid, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const float*>(w),
      static_cast<const float*>(b), cout, static_cast<float*>(cmax),
      static_cast<int*>(amax), static_cast<float*>(cmin),
      static_cast<int*>(amin), static_cast<float*>(rsum),
      static_cast<float*>(rsq));
  return static_cast<int>(cudaGetLastError());
}
