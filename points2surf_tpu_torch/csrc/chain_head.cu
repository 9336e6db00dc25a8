// Fused eval chain, layers 1-2: two pointwise linear layers with folded
// BatchNorm affines, each followed by a relu.
//
//   h2[p, :] = relu(relu(x[p, :] @ W1 * a1 + c1) @ W2 * a2 + c2)
//
// over the flattened (B n) point axis, Cin <= 64 -> 64 -> 128, fp32
// operands and accumulation: the fp32 class (P2S_EVAL_CHAIN_PREC=highest
// there; the bf16 class is chain_fused.cu). With chain_pool.cu (layer 3 and
// the pool) it replaces the TPU kernel
// points2surf_tpu/ops/pallas/chain_kernel.py (_chain_pool, :187, reached
// through chain_pool), whose body runs all three layers per point tile; on
// an H100 the pooled layer has its own tensor-core kernel, and h2 goes
// through device memory between the two.
//
// What bounds it on an H100: the SIMT pipes. Per point 2 (Cin 64 + 64 128)
// FLOP (16.8 K at Cin 3, 24.6 K at Cin 64) against 512 bytes of h2 written:
// ~33-48 FLOP per byte, so at the 67 TFLOP/s of SIMT fp32 the arithmetic
// (0.35 TFLOP, 5.2 ms per query batch of 4096) outweighs the bytes (~11 GB,
// 3.3 ms). It is ~8% of a chain's FLOPs; layer 3 is the rest.
//
// Design: persistent blocks (two per SM) keep W1, W2 and the affines in
// shared memory and walk 64-point chunks of the flattened axis. Each chunk:
// x^T into shared memory, layer 1 and layer 2 as register-tiled SIMT
// products (tile_product.cuh; activations transposed, [channel][point]),
// h2 staged point-major in shared memory and written as coalesced 16-byte
// rows of 4 floats. The products read shared memory ~9 times per
// 32 FMA a thread, which holds them near half the FMA rate. 101,888 bytes
// of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tile_product.cuh"

namespace {

constexpr int C1 = 64;         // conv1 width (fixed by the architecture)
constexpr int C2 = 128;        // conv2 width (fixed by the architecture)
constexpr int CIN_MAX = 64;
constexpr int THREADS = 256;
constexpr int HS = C2 + 4;     // row stride of the point-major h2 staging

// shared-memory layout, in floats (every offset a multiple of 4)
constexpr int OFF_W1 = 0;                       // [cin][C1]
constexpr int OFF_W2 = OFF_W1 + CIN_MAX * C1;   // [C1][C2]
constexpr int OFF_H1 = OFF_W2 + C1 * C2;        // [C1][NPS] layer-1 output
constexpr int OFF_R = OFF_H1 + C1 * NPS;        // x^T [cin][NPS], then h2
constexpr int R_SIZE = (NP * HS > CIN_MAX * NPS) ? NP * HS : CIN_MAX * NPS;
constexpr int OFF_A1 = OFF_R + R_SIZE;
constexpr int OFF_B1 = OFF_A1 + C1;
constexpr int OFF_A2 = OFF_B1 + C1;
constexpr int OFF_B2 = OFF_A2 + C2;
constexpr int SMEM_FLOATS = OFF_B2 + C2;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;     // 101,888
static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two blocks must fit an SM");

// Ht[col][row] = relu(acc * a[col] + c[col]) for the thread's tile, as the
// next product's operand.
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

__global__ void __launch_bounds__(THREADS, 2)
chain_head_kernel(const float* __restrict__ x, long long points, int cin,
                  const float* __restrict__ w1, const float* __restrict__ a1,
                  const float* __restrict__ c1, const float* __restrict__ w2,
                  const float* __restrict__ a2, const float* __restrict__ c2,
                  float* __restrict__ h2) {
  extern __shared__ __align__(16) float smem[];
  float* W1s = smem + OFF_W1;
  float* W2s = smem + OFF_W2;
  float* h1t = smem + OFF_H1;
  float* xt = smem + OFF_R;   // [cin][NPS], dead after layer 1
  float* stg = smem + OFF_R;  // [NP][HS] h2, point-major
  float* a1s = smem + OFF_A1;
  float* b1s = smem + OFF_B1;
  float* a2s = smem + OFF_A2;
  float* b2s = smem + OFF_B2;
  const int tid = threadIdx.x;

  for (int i = tid; i < cin * C1; i += THREADS) {
    W1s[i] = w1[i];
  }
  for (int i = tid; i < C1 * C2; i += THREADS) {
    W2s[i] = w2[i];
  }
  for (int i = tid; i < C1; i += THREADS) {
    a1s[i] = a1[i];
    b1s[i] = c1[i];
  }
  for (int i = tid; i < C2; i += THREADS) {
    a2s[i] = a2[i];
    b2s[i] = c2[i];
  }

  // thread tiles: layer 1 64x64 (4x4 each), layer 2 64x128 (4x8)
  const int rg = tid / 16, cg = tid % 16;
  const long long chunks = (points + NP - 1) / NP;
  for (long long ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const long long p0 = ch * NP;
    const int rows = (int)min((long long)NP, points - p0);
    __syncthreads();  // staging done / the previous chunk's h2 rows written
    const float* xc = x + p0 * cin;
    for (int i = tid; i < NP * cin; i += THREADS) {
      const int r = i / cin;
      const int ci = i - r * cin;
      xt[ci * NPS + r] = r < rows ? xc[i] : 0.f;
    }
    __syncthreads();
    {
      float acc[4][4];
      tile_product<C1, 4, 4>(xt, W1s, cin, rg, cg, acc);
      store_hidden<C1, 4, 4>(h1t, a1s, b1s, rg, cg, acc);
    }
    __syncthreads();  // h1 complete; x^T dead, so its space takes h2
    {
      float acc[4][8];
      tile_product<C2, 4, 8>(h1t, W2s, C1, rg, cg, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg + 16 * j;
        const float aa = a2s[col];
        const float cc = b2s[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          stg[(rg * 4 + i) * HS + col] = fmaxf(fmaf(acc[i][j], aa, cc), 0.f);
        }
      }
    }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(h2 + p0 * C2);
    for (int i = tid; i < rows * (C2 / 4); i += THREADS) {
      const int r = i / (C2 / 4);
      const int q = i - r * (C2 / 4);
      dst[i] = *reinterpret_cast<const float4*>(stg + r * HS + 4 * q);
    }
  }
}

}  // namespace

// On device `dev` and its stream `stream`: h2 (points, 128) = layers 1-2 of
// x (points, cin), 1 <= cin <= 64; w1 (cin, 64), w2 (64, 128), a_i / c_i
// per output channel, all fp32; h2 fp32, its base 16-byte aligned. All
// contiguous. Returns a cudaError_t; 0 means launched.
extern "C" int p2s_chain_head(int dev, const void* x, long long points,
                              int cin, const void* w1, const void* a1,
                              const void* c1, int c1n, const void* w2,
                              const void* a2, const void* c2, int c2n,
                              void* h2, void* stream) {
  if (c1n != C1 || c2n != C2 || cin < 1 || cin > CIN_MAX || points < 1 ||
      reinterpret_cast<uintptr_t>(h2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the SM count and the shared-memory attribute, once per device
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = sms_of[dev];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(chain_head_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    }
    if (err == cudaSuccess) sms_of[dev] = sms;
  }
  if (err == cudaSuccess) {
    const long long chunks = (points + NP - 1) / NP;
    const int blocks = (int)std::min<long long>(chunks, 2LL * sms);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xs = static_cast<const float*>(x);
    const float* w1s = static_cast<const float*>(w1);
    const float* a1s = static_cast<const float*>(a1);
    const float* c1s = static_cast<const float*>(c1);
    const float* w2s = static_cast<const float*>(w2);
    const float* a2s = static_cast<const float*>(a2);
    const float* c2s = static_cast<const float*>(c2);
    chain_head_kernel<<<blocks, THREADS, SMEM_BYTES, st>>>(
        xs, points, cin, w1s, a1s, c1s, w2s, a2s, c2s,
        static_cast<float*>(h2));
    err = cudaGetLastError();
  }
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}
