// Fused eval chain, layers 1-2: two pointwise linear layers with folded
// BatchNorm affines, each followed by a relu.
//
//   h2[p, :] = relu(relu(x[p, :] @ W1 * a1 + c1) @ W2 * a2 + c2)
//
// over the flattened (B n) point axis, Cin <= 64 -> 64 -> 128, with fp32
// accumulation. Operands are fp32 (P2S_EVAL_CHAIN_PREC=highest there), or,
// in the bf16 mode (default there), x, W1, h1 and W2 are rounded to the
// nearest bf16 (ties to even) before their products and h2 is stored as
// bf16: the operand layer 3 takes, at half the bytes. The products of
// exact bf16 values are exact in fp32, so the SIMT product serves both
// modes; the affines and relus stay fp32. With chain_pool.cu (layer 3 and
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
// 3.3 ms; 256 bytes of bf16 h2 make that ~2.1 ms). It is ~8% of a
// chain's FLOPs; layer 3 is the rest.
//
// Design: persistent blocks (two per SM) keep W1, W2 and the affines in
// shared memory and walk 64-point chunks of the flattened axis. Each chunk:
// x^T into shared memory, layer 1 and layer 2 as register-tiled SIMT
// products (tile_product.cuh; activations transposed, [channel][point]),
// h2 staged point-major in shared memory and written as coalesced 16-byte
// rows (4 floats or 8 bf16). The products read shared memory ~9 times per
// 32 FMA a thread, which holds them near half the FMA rate. 101,888 bytes
// of shared memory.

#include <cuda_bf16.h>
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

// v, or v rounded to the nearest bf16 (ties to even) in the bf16 mode
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Ht[col][row] = relu(acc * a[col] + c[col]) for the thread's tile, as the
// next product's operand.
template <bool kBf16, int N, int TM, int TN>
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
      v.x = operand<kBf16>(fmaxf(fmaf(acc[4 * u][j], aa, cc), 0.f));
      v.y = operand<kBf16>(fmaxf(fmaf(acc[4 * u + 1][j], aa, cc), 0.f));
      v.z = operand<kBf16>(fmaxf(fmaf(acc[4 * u + 2][j], aa, cc), 0.f));
      v.w = operand<kBf16>(fmaxf(fmaf(acc[4 * u + 3][j], aa, cc), 0.f));
      *reinterpret_cast<float4*>(Ht + col * NPS + rg * TM + 4 * u) = v;
    }
  }
}

// h2: float (fp32 mode) or __nv_bfloat16 (bf16 mode)
template <bool kBf16>
__global__ void __launch_bounds__(THREADS, 2)
chain_head_kernel(const float* __restrict__ x, long long points, int cin,
                  const float* __restrict__ w1, const float* __restrict__ a1,
                  const float* __restrict__ c1, const float* __restrict__ w2,
                  const float* __restrict__ a2, const float* __restrict__ c2,
                  void* __restrict__ h2) {
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
    W1s[i] = operand<kBf16>(w1[i]);
  }
  for (int i = tid; i < C1 * C2; i += THREADS) {
    W2s[i] = operand<kBf16>(w2[i]);
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
      xt[ci * NPS + r] = r < rows ? operand<kBf16>(xc[i]) : 0.f;
    }
    __syncthreads();
    {
      float acc[4][4];
      tile_product<C1, 4, 4>(xt, W1s, cin, rg, cg, acc);
      store_hidden<kBf16, C1, 4, 4>(h1t, a1s, b1s, rg, cg, acc);
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
    if (kBf16) {  // 8 channels rounded to bf16 per 16-byte store
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<__nv_bfloat16*>(h2) + p0 * C2);
      for (int i = tid; i < rows * (C2 / 8); i += THREADS) {
        const int r = i / (C2 / 8);
        const int q = i - r * (C2 / 8);
        const float* src = stg + r * HS + 8 * q;
        const float4 u = *reinterpret_cast<const float4*>(src);
        const float4 v = *reinterpret_cast<const float4*>(src + 4);
        uint4 o;
        __nv_bfloat162 pr = __floats2bfloat162_rn(u.x, u.y);
        o.x = *reinterpret_cast<const uint32_t*>(&pr);
        pr = __floats2bfloat162_rn(u.z, u.w);
        o.y = *reinterpret_cast<const uint32_t*>(&pr);
        pr = __floats2bfloat162_rn(v.x, v.y);
        o.z = *reinterpret_cast<const uint32_t*>(&pr);
        pr = __floats2bfloat162_rn(v.z, v.w);
        o.w = *reinterpret_cast<const uint32_t*>(&pr);
        dst[i] = o;
      }
    } else {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(h2) +
                                              p0 * C2);
      for (int i = tid; i < rows * (C2 / 4); i += THREADS) {
        const int r = i / (C2 / 4);
        const int q = i - r * (C2 / 4);
        dst[i] = *reinterpret_cast<const float4*>(stg + r * HS + 4 * q);
      }
    }
  }
}

}  // namespace

// On device `dev` and its stream `stream`: h2 (points, 128) = layers 1-2 of
// x (points, cin), 1 <= cin <= 64; w1 (cin, 64), w2 (64, 128), a_i / c_i
// per output channel, all fp32. bf16 == 0: fp32 operands, h2 fp32;
// bf16 != 0: operands rounded to bf16, h2 bf16. h2's base 16-byte aligned.
// All contiguous. Returns a cudaError_t; 0 means launched.
extern "C" int p2s_chain_head(int dev, const void* x, long long points,
                              int cin, const void* w1, const void* a1,
                              const void* c1, int c1n, const void* w2,
                              const void* a2, const void* c2, int c2n,
                              int bf16, void* h2, void* stream) {
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
      err = cudaFuncSetAttribute(chain_head_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(chain_head_kernel<true>,
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
    if (bf16) {
      chain_head_kernel<true><<<blocks, THREADS, SMEM_BYTES, st>>>(
          xs, points, cin, w1s, a1s, c1s, w2s, a2s, c2s, h2);
    } else {
      chain_head_kernel<false><<<blocks, THREADS, SMEM_BYTES, st>>>(
          xs, points, cin, w1s, a1s, c1s, w2s, a2s, c2s, h2);
    }
    err = cudaGetLastError();
  }
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}
