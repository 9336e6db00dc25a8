// Fused eval chain: three pointwise linear layers with folded BatchNorm
// affines, ReLU between them, then a max or sum pool over the point axis.
//
//   out[b, j] = pool_{p < n} L3(relu(L2(relu(L1(x[b, p, :])))))[j]
//   L_i(h) = (h @ W_i) * a_i + c_i        (relu after L3 only if relu_last)
//
// Replaces the TPU kernel points2surf_tpu/ops/pallas/chain_kernel.py
// (_chain_kernel, reached through chain_pool / _chain_pool). Numerics class:
// fp32 operands, fp32 accumulation (P2S_EVAL_CHAIN_PREC=highest there).
//
// What bounds it on an H100: arithmetic. Per query the model runs ~1.1 GFLOP
// in its five chains, ~92% of it in the 128 -> C_out layer. Each W3 tile is
// read once per block and reused for every point of the row, so a block does
// n * 128 * 256 FMAs per 128 KB of weights: compute-bound on the fp32 FMA
// pipes, far from the HBM roof. The literal version would instead write a
// (B, n, C_out) activation (f32[4096, 1300, 1024] = 21.8 GB for the point-STN
// chain at batch 4096); here nothing but the (B, C_out) result leaves the SM.
//
// Design: grid = (batch row, C_out tile of 256). A block stages its W3 tile
// (128 x 256) and W2 in shared memory, walks the whole point axis in chunks
// of 64 points, recomputes layers 1-2 for each chunk (the price of needing no
// other block's result: no atomics, no second pass), and keeps the running
// pool in registers. Every layer is a register-tiled SIMT product from
// shared memory; activations are stored transposed ([channel][point], row
// stride 68 floats) so a thread reads its rows as float4 broadcasts and the
// epilogue stores hit distinct banks. wgmma/TMA and lower-precision
// operands are later work here; csrc/mlp_maxpool.cu (the one-layer encoder
// tail) is the first kernel of the port built on them.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tile_product.cuh"

namespace {

constexpr int C1 = 64;         // conv1 width (fixed by the architecture)
constexpr int C2 = 128;        // conv2 width (fixed by the architecture)
constexpr int TC = 256;        // C_out columns per block
constexpr int CIN_MAX = 64;
constexpr int THREADS = 256;

// shared-memory layout, in floats (every offset a multiple of 4)
constexpr int OFF_W2 = 0;                       // [C1][C2]
constexpr int OFF_W3 = OFF_W2 + C1 * C2;        // [C2][TC]
constexpr int OFF_H1 = OFF_W3 + C2 * TC;        // [C1][NPS] layer-1 output
constexpr int OFF_R = OFF_H1 + C1 * NPS;        // x chunk + W1, then h2
constexpr int R_X = CIN_MAX * NPS;              // W1 offset inside R
constexpr int R_SIZE = (C2 * NPS > R_X + CIN_MAX * C1) ? C2 * NPS
                                                       : R_X + CIN_MAX * C1;
constexpr int OFF_A1 = OFF_R + R_SIZE;
constexpr int OFF_B1 = OFF_A1 + C1;
constexpr int OFF_A2 = OFF_B1 + C1;
constexpr int OFF_B2 = OFF_A2 + C2;
constexpr int OFF_A3 = OFF_B2 + C2;
constexpr int OFF_B3 = OFF_A3 + TC;
constexpr int SMEM_FLOATS = OFF_B3 + TC;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;     // 219,648 of 232,448
static_assert(SMEM_BYTES <= 232448, "shared memory over the sm_90 limit");
static_assert(8 * TC <= C1 * NPS, "pool reduction buffer must fit in h1");

// Ht[col][row] = relu(acc * a[col] + c[col]) for the thread's tile.
template <int N, int TM, int TN>
__device__ __forceinline__ void store_hidden(float* __restrict__ Ht,
                                             const float* __restrict__ a,
                                             const float* __restrict__ c,
                                             int rg, int cg,
                                             const float (&acc)[TM][TN]) {
  constexpr int NCG = N / TN;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = cg + NCG * j;
    const float aa = a[col];
    const float cc = c[col];
#pragma unroll
    for (int u = 0; u < TM / 4; ++u) {
      float4 v;
      v.x = fmaxf(fmaf(acc[4 * u][j], aa, cc), 0.f);
      v.y = fmaxf(fmaf(acc[4 * u + 1][j], aa, cc), 0.f);
      v.z = fmaxf(fmaf(acc[4 * u + 2][j], aa, cc), 0.f);
      v.w = fmaxf(fmaf(acc[4 * u + 3][j], aa, cc), 0.f);
      *reinterpret_cast<float4*>(Ht + col * NPS + rg * TM + 4 * u) = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
chain_pool_kernel(const float* __restrict__ x, int n, int cin,
                  const float* __restrict__ w1, const float* __restrict__ a1,
                  const float* __restrict__ c1, const float* __restrict__ w2,
                  const float* __restrict__ a2, const float* __restrict__ c2,
                  const float* __restrict__ w3, const float* __restrict__ a3,
                  const float* __restrict__ c3, int cout, int sym_max,
                  int relu_last, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* W2s = smem + OFF_W2;
  float* W3s = smem + OFF_W3;
  float* h1t = smem + OFF_H1;
  float* xt = smem + OFF_R;        // [cin][NPS], dead after layer 1
  float* W1s = smem + OFF_R + R_X; // [cin][C1], dead after layer 1
  float* h2t = smem + OFF_R;       // [C2][NPS], overwrites xt and W1s
  float* a1s = smem + OFF_A1;
  float* b1s = smem + OFF_B1;
  float* a2s = smem + OFF_A2;
  float* b2s = smem + OFF_B2;
  float* a3s = smem + OFF_A3;
  float* b3s = smem + OFF_B3;

  const int b = blockIdx.x;
  const int col0 = blockIdx.y * TC;
  const int tid = threadIdx.x;

  for (int i = tid; i < C1 * C2; i += THREADS) W2s[i] = w2[i];
  for (int i = tid; i < C2 * TC; i += THREADS) {
    const int k = i / TC;
    const int col = col0 + (i - k * TC);
    W3s[i] = col < cout ? w3[(size_t)k * cout + col] : 0.f;
  }
  for (int i = tid; i < C1; i += THREADS) {
    a1s[i] = a1[i];
    b1s[i] = c1[i];
  }
  for (int i = tid; i < C2; i += THREADS) {
    a2s[i] = a2[i];
    b2s[i] = c2[i];
  }
  for (int i = tid; i < TC; i += THREADS) {
    const int col = col0 + i;
    a3s[i] = col < cout ? a3[col] : 0.f;
    b3s[i] = col < cout ? c3[col] : 0.f;
  }

  // thread tiles: layer 1 64x64 (4x4 each), layer 2 64x128 (4x8),
  // layer 3 64x256 (8x8)
  const int rg12 = tid / 16, cg12 = tid % 16;
  const int rg3 = tid / 32, cg3 = tid % 32;

  float pool[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) pool[j] = sym_max ? -CUDART_INF_F : 0.f;

  const float* xb = x + (size_t)b * n * cin;
  for (int p0 = 0; p0 < n; p0 += NP) {
    __syncthreads();  // staging done / previous chunk's layer 3 left R
    for (int i = tid; i < NP * cin; i += THREADS) {
      const int r = i / cin;
      const int ci = i - r * cin;
      xt[ci * NPS + r] = (p0 + r < n) ? xb[(size_t)p0 * cin + i] : 0.f;
    }
    for (int i = tid; i < cin * C1; i += THREADS) W1s[i] = w1[i];
    __syncthreads();
    {
      float acc[4][4];
      tile_product<C1, 4, 4>(xt, W1s, cin, rg12, cg12, acc);
      store_hidden<C1, 4, 4>(h1t, a1s, b1s, rg12, cg12, acc);
    }
    __syncthreads();
    {
      float acc[4][8];
      tile_product<C2, 4, 8>(h1t, W2s, C1, rg12, cg12, acc);
      store_hidden<C2, 4, 8>(h2t, a2s, b2s, rg12, cg12, acc);
    }
    __syncthreads();
    {
      float acc[8][8];
      tile_product<TC, 8, 8>(h2t, W3s, C2, rg3, cg3, acc);
      const int rows_left = n - p0 - rg3 * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg3 + 32 * j;
        const float aa = a3s[col];
        const float cc = b3s[col];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < rows_left) {
            float v = fmaf(acc[i][j], aa, cc);
            if (relu_last) v = fmaxf(v, 0.f);
            pool[j] = sym_max ? fmaxf(pool[j], v) : pool[j] + v;
          }
        }
      }
    }
  }

  // combine the eight row groups' partial pools
  __syncthreads();
  float* red = h1t;  // [8][TC]
#pragma unroll
  for (int j = 0; j < 8; ++j) red[rg3 * TC + cg3 + 32 * j] = pool[j];
  __syncthreads();
  const int col = col0 + tid;
  if (col < cout) {
    float v = red[tid];
    for (int r = 1; r < 8; ++r) {
      const float u = red[r * TC + tid];
      v = sym_max ? fmaxf(v, u) : v + u;
    }
    out[(size_t)b * cout + col] = v;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All arrays are contiguous fp32 on
// the current device: x (batch, n, cin), w_i (in_i, out_i), a_i / c_i
// (out_i,), out (batch, cout). Returns a cudaError_t; 0 means launched.
extern "C" int p2s_chain_pool(const void* x, int batch, int n, int cin,
                              const void* w1, const void* a1, const void* c1,
                              int c1n, const void* w2, const void* a2,
                              const void* c2, int c2n, const void* w3,
                              const void* a3, const void* c3, int cout,
                              int sym_max, int relu_last, void* out,
                              void* stream) {
  if (c1n != C1 || c2n != C2 || cin < 1 || cin > CIN_MAX || n < 1 ||
      batch < 1 || cout < 1 || (cout + TC - 1) / TC > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      chain_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (cout + TC - 1) / TC);
  chain_pool_kernel<<<grid, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, cin, static_cast<const float*>(w1),
      static_cast<const float*>(a1), static_cast<const float*>(c1),
      static_cast<const float*>(w2), static_cast<const float*>(a2),
      static_cast<const float*>(c2), static_cast<const float*>(w3),
      static_cast<const float*>(a3), static_cast<const float*>(c3), cout,
      sym_max, relu_last, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
