// Encoder tail: one pointwise layer, then a max pool over the point axis.
//
//   out[b, j] = max_{p < n} (x[b, p, :] @ W[:, j]) + c[j]
//
// Replaces the TPU kernel points2surf_tpu/ops/pallas/encoder_tail.py
// (_tail_kernel, reached through mlp_maxpool). Numerics class: fp32, as the
// TPU kernel's full fp32 operands. The products run on the tensor cores as
// three TF32 products (3xTF32): with a_hi = cvt.rna.tf32(a) and
// a_lo = a - a_hi (likewise for W), x.W = hi.hi + hi.lo + lo.hi in fp32
// accumulators; the dropped lo.lo term and the TF32 truncation of lo are
// ~2^-21 of each product.
//
// What bounds it on an H100: arithmetic at the large shapes (2 B n Cin Cout
// FLOP, three times that on the tensor cores: ~165 TFLOP/s of fp32-class
// work at the TF32 peak, against 67 TFLOP/s on the fp32 SIMT pipes), and
// filling 132 SMs at the small ones (16 rows x 4 column tiles is 64 output
// tiles). The result is (B, Cout); nothing of the (B, n, Cout) activation
// leaves the SM.
//
// Design:
// - grid = column tile of 128 (fastest, so the blocks that share an x slab
//   run together and read it from L2) x point-axis split x batch row. When
//   B * column tiles is short of the SM count, the point axis is split
//   across blocks, each taking a contiguous run of 128-point slabs.
// - A ring of 3 stages in shared memory, one (slab, 32-wide K chunk) each:
//   the x chunk (128 x 32, by TMA from a 3-D (B, n, Cin) tensor map, so a
//   slab never reads the next row's points; rows past n and columns past
//   Cin arrive as zeros) and the hi and lo chunks of W^T (128 x 32 each, by
//   TMA from (Cout, Kp) arrays that a prologue kernel transposes and splits
//   once per call: tf32 wgmma takes B K-major only). 128-byte swizzle
//   throughout. One producer thread keeps the loads in flight on
//   mbarriers; two consumer warpgroups, 64 points each, split their x rows
//   into hi (in place) and lo in shared memory and issue wgmma m64n128k8
//   tf32, three per k step, into fp32 register accumulators.
// - After each slab the rows >= n are masked to -inf (a zero-filled row
//   would win where every real product of a column is negative) and the
//   column maxima kept in registers. At the end the 8 warps combine in
//   shared memory, c is added (rounding is monotone, so max_p fl(y_p + c)
//   is fl(max_p y_p + c) bit for bit), and the splits combine with an
//   atomic max on the float's bits: non-negative values compared as signed
//   integers, negative ones as unsigned, which is the float order. The max
//   of a set does not depend on the order of the atomics, so the result is
//   deterministic. The prologue fills out with -inf. NaN inputs are not
//   propagated (fmaxf drops them).

#include <cuda.h>
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
constexpr int X_BYTES = BM * BK * 4;
constexpr int W_BYTES = BN * BK * 4;
// a stage: x (raw, then its hi part), x lo, W^T hi, W^T lo
constexpr int STAGE_BYTES = 2 * X_BYTES + 2 * W_BYTES;
constexpr int TX_BYTES = X_BYTES + 2 * W_BYTES;  // what TMA writes per stage
constexpr int RED_BYTES = 8 * BN * 4;
constexpr int BAR_BYTES = 2 * STAGES * 8;
// + 1024: the swizzled tiles need 1024-byte alignment, the base has 16
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + RED_BYTES + BAR_BYTES + 1024;
static_assert(SMEM_BYTES <= 232448, "shared memory over the sm_90 limit");

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
// and out = -inf. Blocks of 32 x 8 threads over 32 x 32 tiles of W.
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

__global__ void __launch_bounds__(THREADS, 1)
mlp_maxpool_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_hi_map,
                   const __grid_constant__ CUtensorMap w_lo_map, int n,
                   int kp, int cout, int col_tiles, int splits,
                   int slabs_per_split, const float* __restrict__ c,
                   float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + RED_BYTES);
  uint64_t* empty = full + STAGES;

  int idx = blockIdx.x;
  const int col0 = (idx % col_tiles) * BN;
  idx /= col_tiles;
  const int split = idx % splits;
  const int b = idx / splits;
  const int n_slabs = (n + BM - 1) / BM;
  const int slab0 = split * slabs_per_split;
  const int slab1 = min(n_slabs, slab0 + slabs_per_split);
  const int chunks = (kp + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp: one thread issues every load
    if (tid == CONSUMERS) {
      int it = 0;
      for (int s = slab0; s < slab1; ++s) {
        for (int k = 0; k < chunks; ++k, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          uint8_t* base = smem + st * STAGE_BYTES;
          mbar_expect_tx(&full[st], TX_BYTES);
          tma_load_3d(base, &x_map, &full[st], k * BK, s * BM, b);
          tma_load_2d(base + 2 * X_BYTES, &w_hi_map, &full[st], k * BK, col0);
          tma_load_2d(base + 2 * X_BYTES + W_BYTES, &w_lo_map, &full[st],
                      k * BK, col0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows 64 g .. 64 g + 63 of every slab
  const int g = tid / 128;
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  float acc[64];
  float run[32];  // running max of this thread's 32 columns
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = -CUDART_INF_F;

  int it = 0;
  for (int s = slab0; s < slab1; ++s) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int k = 0; k < chunks; ++k, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      uint8_t* base = smem + st * STAGE_BYTES;
      float4* x_hi = reinterpret_cast<float4*>(base + g * (X_BYTES / 2));
      float4* x_lo =
          reinterpret_cast<float4*>(base + X_BYTES + g * (X_BYTES / 2));
      // the split is elementwise, so the swizzled layout carries over
#pragma unroll
      for (int i = 0; i < X_BYTES / 2 / 16 / 128; ++i) {
        const float4 v = x_hi[t + 128 * i];
        float4 h;
        h.x = tf32_rna(v.x);
        h.y = tf32_rna(v.y);
        h.z = tf32_rna(v.z);
        h.w = tf32_rna(v.w);
        x_hi[t + 128 * i] = h;
        x_lo[t + 128 * i] =
            make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
      }
      // generic-proxy writes -> visible to wgmma (async proxy), then the
      // warpgroup's own barrier
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
      const uint64_t da_hi = sw128_desc(x_hi);
      const uint64_t da_lo = sw128_desc(x_lo);
      const uint64_t db_hi = sw128_desc(base + 2 * X_BYTES);
      const uint64_t db_lo = sw128_desc(base + 2 * X_BYTES + W_BYTES);
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
      mbar_arrive(&empty[st]);
    }
    // accumulator layout: acc[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h,
    // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 tile
    const int rows_left = n - s * BM - 64 * g - 16 * warp - lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = rows_left > 0 ? acc[4 * j + e] : -CUDART_INF_F;
        if (rows_left > 8) m = fmaxf(m, acc[4 * j + 2 + e]);
        run[2 * j + e] = fmaxf(run[2 * j + e], m);
      }
    }
  }

  // combine the 8 lanes that share a column, then the 8 consumer warps
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float v = run[i];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
    run[i] = v;
  }
  if (lane < 4) {
    float* row = red + (4 * g + warp) * BN + 2 * lane;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      row[8 * j] = run[2 * j];
      row[8 * j + 1] = run[2 * j + 1];
    }
  }
  asm volatile("bar.sync 3, 256;" ::: "memory");
  const int col = col0 + tid;
  if (tid < BN && col < cout) {
    float v = red[tid];
#pragma unroll
    for (int r = 1; r < 8; ++r) v = fmaxf(v, red[r * BN + tid]);
    atomic_max_float(out + (size_t)b * cout + col, v + c[col]);
  }
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

// fp32 tensor map with 128-byte swizzle; dims and box innermost first,
// strides in bytes for dims 1.. . Out-of-bounds elements read as zero.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// On device `dev` and its stream `stream`: out (batch, cout) =
// max_{p < n} (x[b, p, :cin] @ w) + c. x is (batch, n, x_cols) with
// x_cols >= cin a multiple of 4 (columns past cin zero), base 16-byte
// aligned; w (cin, cout); c (cout,); scratch holds 2 * cout * kp + batch *
// cout floats, kp = cin rounded up to 8: the split W^T, then out. All
// contiguous fp32. Returns a cudaError_t; 0 means launched.
extern "C" int p2s_mlp_maxpool(int dev, const void* x, int batch, int n,
                               int x_cols, const void* w, int cin,
                               const void* c, int cout, void* scratch,
                               void* stream) {
  const int kp = (cin + 7) / 8 * 8;
  if (batch < 1 || n < 1 || cin < 1 || cout < 1 || x_cols < cin ||
      x_cols % 4 != 0 || x_cols > kp ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the SM count and the shared-memory attribute, once per device: at the
  // small shapes the host's work per call is the critical path
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const DeviceGuard guard(dev);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = sms_of[dev];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(mlp_maxpool_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[dev] = sms;
  }

  // split the point axis until the grid covers the SMs once
  const int col_tiles = (cout + BN - 1) / BN;
  const int n_slabs = (n + BM - 1) / BM;
  const long long tiles = (long long)batch * col_tiles;
  int splits = tiles >= sms ? 1
                            : (int)std::min<long long>(
                                  n_slabs, (sms + tiles - 1) / tiles);
  const int per_split = (n_slabs + splits - 1) / splits;
  splits = (n_slabs + per_split - 1) / per_split;
  if (tiles * splits > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  float* w_hi = static_cast<float*>(scratch);
  float* w_lo = w_hi + (size_t)cout * kp;
  float* out = w_lo + (size_t)cout * kp;
  CUtensorMap maps[3];
  const cuuint64_t x_dims[3] = {(cuuint64_t)x_cols, (cuuint64_t)n,
                                (cuuint64_t)batch};
  const cuuint64_t x_strides[2] = {(cuuint64_t)x_cols * 4,
                                   (cuuint64_t)x_cols * 4 * n};
  const cuuint32_t x_box[3] = {BK, BM, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)kp, (cuuint64_t)cout};
  const cuuint64_t w_strides[1] = {(cuuint64_t)kp * 4};
  const cuuint32_t w_box[2] = {BK, BN};
  if (!encode(&maps[0], x, 3, x_dims, x_strides, x_box) ||
      !encode(&maps[1], w_hi, 2, w_dims, w_strides, w_box) ||
      !encode(&maps[2], w_lo, 2, w_dims, w_strides, w_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const dim3 prep_grid((kp + 31) / 32, (cout + 31) / 32);
  split_weights_kernel<<<prep_grid, dim3(32, 8), 0, st>>>(
      static_cast<const float*>(w), cin, cout, kp, w_hi, w_lo,
      static_cast<float*>(out), (size_t)batch * cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_maxpool_kernel<<<(unsigned)(tiles * splits), THREADS, SMEM_BYTES, st>>>(
      maps[0], maps[1], maps[2], n, kp, cout, col_tiles, splits, per_split,
      static_cast<const float*>(c), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
