// Register-tiled fp32 SIMT product from shared memory, used by the port's
// SIMT pointwise-layer kernel (chain_head.cu).
//
// Activations are stored transposed in shared memory, [channel][point] with
// row stride NPS, so a thread reads its TM rows of one channel as float4
// broadcasts; weights are [k][N] row-major in shared memory.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NP = 64;       // points per chunk
constexpr int NPS = NP + 4;  // row stride of transposed activations

// acc[i][jj] += sum_k At[k][rg*TM + i] * Bs[k][cg + NCG*jj]
// At is [K][NPS] (transposed activations), Bs is [K][N].
template <int N, int TM, int TN>
__device__ __forceinline__ void tile_product(const float* __restrict__ At,
                                             const float* __restrict__ Bs,
                                             int K, int rg, int cg,
                                             float (&acc)[TM][TN]) {
  constexpr int NCG = N / TN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM];
    float b[TN];
#pragma unroll
    for (int u = 0; u < TM / 4; ++u) {
      const float4 v =
          *reinterpret_cast<const float4*>(At + k * NPS + rg * TM + 4 * u);
      a[4 * u] = v.x;
      a[4 * u + 1] = v.y;
      a[4 * u + 2] = v.z;
      a[4 * u + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[k * N + cg + NCG * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace
