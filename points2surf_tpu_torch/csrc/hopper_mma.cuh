// Hopper machinery shared by the port's tensor-core kernels (mlp_maxpool.cu,
// chain_head.cu, chain_pool.cu, pooled_tail.cu, chain_fused.cu,
// pooled_tail_bf16.cu): TMA loads and mbarriers, the 3xTF32 wgmma product
// of one K chunk on 128-byte swizzled K-major tiles, the W^T hi/lo
// prologue, and the host's tensor maps and grid split; for the bf16-operand
// kernels (chain_fused.cu, pooled_tail_bf16.cu), the bf16 wgmma and the
// bf16 W^T prologue.
//
// Each kernel: a block owns one column tile of BN outputs and walks
// 128-point slabs of one batch row. A slab arrives as K chunks of 32 fp32
// (one 128-byte row) of the activation (BM x BK, by TMA from a 3-D (B, n, K)
// tensor map, so a slab never reads the next row's points; rows past n and
// columns past K arrive as zeros), against the hi and lo chunks of W^T (BN x
// BK each, from (Cout, Kp) arrays written by split_weights_kernel: tf32
// wgmma takes B K-major only). One producer thread issues the loads; two
// consumer warpgroups, 64 rows each, split their activation rows into tf32
// hi (in place) and lo and issue wgmma m64n128k8 three times per k step:
// x.W = hi.hi + hi.lo + lo.hi in fp32 accumulators, ~2^-21 of each product
// short of fp32 (the dropped lo.lo term, the tf32 truncation of lo).
//
// bf16-operand mode (P2S_*_PREC=default in the JAX package): a 128-byte
// swizzled K-major row holds 64 bf16, and one wgmma m64n128k16 step of bf16
// x bf16 into fp32 accumulators is 32 bytes, as one tf32 k8 step is, so the
// descriptors and the TMA helpers are shared. Operands are rounded to the
// nearest bf16, ties to even (__float2bfloat16_rn, XLA's astype), not with
// the cvt.rna of the tf32 split; products of bf16 values are exact in fp32.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 128;              // points per slab: two warpgroups of 64
constexpr int BN = 128;              // output columns per block
constexpr int BK = 32;               // K chunk: 32 fp32 = one 128-byte row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int X_BYTES = BM * BK * 4;   // an activation chunk
constexpr int W_BYTES = BN * BK * 4;   // a W^T chunk, hi or lo
constexpr int RED_BYTES = 8 * BN * 4;  // the 8 consumer warps' pools

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// round to the nearest tf32 (ties away from zero); the low 13 bits are zero
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// two floats rounded to bf16 (ties to even), lo at the lower address
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// 8-row atoms of 1024 bytes (stride byte offset 1024), leading byte offset
// unused, layout type 1 (B128). One k step of 8 tf32 is 32 bytes further.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 8, tf32) B (8 x 128, tf32), both from
// shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16) B (16 x 128, bf16), both from
// shared memory, both K-major (no transpose); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// max into a float in global memory: non-negative values (sign bit clear)
// order like signed integers, negative ones reversed like unsigned ones
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// Prologue: W (cin, cout) -> W^T split into tf32 hi and lo, (cout, kp)
// each, zero for k >= cin (exact: zeros add nothing to a dot product);
// and out[:out_size] = -inf. Blocks of 32 x 8 threads over 32 x 32 tiles of
// W.
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ w, int cin, int cout, int kp,
                     float* __restrict__ w_hi, float* __restrict__ w_lo,
                     float* __restrict__ out, size_t out_size) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32;
  const int j0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r;
    const int j = j0 + tx;
    tile[r][tx] = (k < cin && j < cout) ? w[(size_t)k * cout + j] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int j = j0 + r;
    const int k = k0 + tx;
    if (j < cout && k < kp) {
      const float v = tile[tx][r];
      const float hi = tf32_rna(v);
      w_hi[(size_t)j * kp + k] = hi;
      w_lo[(size_t)j * kp + k] = v - hi;
    }
  }
  const size_t stride = (size_t)gridDim.x * gridDim.y * 256;
  for (size_t i = (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 256 +
                  ty * 32 + tx;
       i < out_size; i += stride) {
    out[i] = -CUDART_INF_F;
  }
}

// Prologue of the bf16 mode: W (cin, cout) -> W^T as bf16 (cout, kp),
// rounded to the nearest (ties to even), zero for k >= cin; and
// out[:out_size] = -inf. Blocks of 32 x 8 threads over 32 x 32 tiles of W.
__global__ void __launch_bounds__(256)
bf16_weights_kernel(const float* __restrict__ w, int cin, int cout, int kp,
                    __nv_bfloat16* __restrict__ w_bf,
                    float* __restrict__ out, size_t out_size) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32;
  const int j0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r;
    const int j = j0 + tx;
    tile[r][tx] = (k < cin && j < cout) ? w[(size_t)k * cout + j] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int j = j0 + r;
    const int k = k0 + tx;
    if (j < cout && k < kp) {
      w_bf[(size_t)j * kp + k] = __float2bfloat16_rn(tile[tx][r]);
    }
  }
  const size_t stride = (size_t)gridDim.x * gridDim.y * 256;
  for (size_t i = (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 256 +
                  ty * 32 + tx;
       i < out_size; i += stride) {
    out[i] = -CUDART_INF_F;
  }
}

// Consumer warpgroup g (thread t of 128), one K chunk: split its 64 rows of
// the chunk at x (BM x BK fp32, swizzled; becomes the hi part) into tf32 hi
// and lo (at x_lo), then acc += x . W^T over the chunk's BK k, with the
// chunk's W^T hi and lo tiles (BN x BK, swizzled) at w_hi and w_lo.
// Accumulator layout: acc[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 tile.
__device__ __forceinline__ void mma_chunk(float (&acc)[64], uint8_t* x,
                                          uint8_t* x_lo, const uint8_t* w_hi,
                                          const uint8_t* w_lo, int g, int t) {
  float4* xh = reinterpret_cast<float4*>(x + g * (X_BYTES / 2));
  float4* xl = reinterpret_cast<float4*>(x_lo + g * (X_BYTES / 2));
  // the split is elementwise, so the swizzled layout carries over
#pragma unroll
  for (int i = 0; i < X_BYTES / 2 / 16 / 128; ++i) {
    const float4 v = xh[t + 128 * i];
    float4 h;
    h.x = tf32_rna(v.x);
    h.y = tf32_rna(v.y);
    h.z = tf32_rna(v.z);
    h.w = tf32_rna(v.w);
    xh[t + 128 * i] = h;
    xl[t + 128 * i] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
  // generic-proxy writes -> visible to wgmma (async proxy), then the
  // warpgroup's own barrier
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
  const uint64_t da_hi = sw128_desc(xh);
  const uint64_t da_lo = sw128_desc(xl);
  const uint64_t db_hi = sw128_desc(w_hi);
  const uint64_t db_lo = sw128_desc(w_lo);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  // every k step of the chunk, also past kp: those read TMA's zeros (a
  // branch here would make ptxas serialize the wgmma)
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint64_t off = 2 * kk;  // 32 bytes, in 16-byte units
    wgmma_tf32(acc, da_hi + off, db_hi + off);
    wgmma_tf32(acc, da_hi + off, db_lo + off);
    wgmma_tf32(acc, da_lo + off, db_hi + off);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime's
// entry-point query: the library links against nothing but the runtime
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// tensor map (fp32 unless `type` says otherwise) with 128-byte swizzle;
// dims and box innermost first, strides in bytes for dims 1.. .
// Out-of-bounds elements read as zero.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box,
            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ring's three tensor maps: x (batch, n, x_cols) by (BK, BM, 1) boxes,
// W^T hi and lo (cout, kp) by (BK, BN) boxes.
bool encode_ring_maps(CUtensorMap (&maps)[3], const void* x, int batch, int n,
                      int x_cols, const float* w_hi, const float* w_lo,
                      int cout, int kp) {
  const cuuint64_t x_dims[3] = {(cuuint64_t)x_cols, (cuuint64_t)n,
                                (cuuint64_t)batch};
  const cuuint64_t x_strides[2] = {(cuuint64_t)x_cols * 4,
                                   (cuuint64_t)x_cols * 4 * n};
  const cuuint32_t x_box[3] = {BK, BM, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)kp, (cuuint64_t)cout};
  const cuuint64_t w_strides[1] = {(cuuint64_t)kp * 4};
  const cuuint32_t w_box[2] = {BK, BN};
  return encode(&maps[0], x, 3, x_dims, x_strides, x_box) &&
         encode(&maps[1], w_hi, 2, w_dims, w_strides, w_box) &&
         encode(&maps[2], w_lo, 2, w_dims, w_strides, w_box);
}

// Splits of the point axis so that tiles * splits blocks cover `sms` SMs
// once (1 when the tiles alone do); each split takes *per_split contiguous
// slabs. Returns 0 if the grid would not fit in gridDim.x.
int point_splits(int sms, long long tiles, int n_slabs, int* per_split) {
  int splits = tiles >= sms ? 1
                            : (int)std::min<long long>(
                                  n_slabs, (sms + tiles - 1) / tiles);
  *per_split = (n_slabs + splits - 1) / splits;
  splits = (n_slabs + *per_split - 1) / *per_split;
  return tiles * splits > 0x7fffffffLL ? 0 : splits;
}

// makes `dev` the current device while it lives, then restores the caller's
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) {
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess || prev == dev) {
      prev = -1;  // nothing to restore
    } else {
      err = cudaSetDevice(dev);
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
