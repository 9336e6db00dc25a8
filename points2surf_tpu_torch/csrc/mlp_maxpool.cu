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
// - The chunk product, its TMA and wgmma helpers and the prologue are shared
//   with chain_pool.cu in hopper_mma.cuh.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

// a stage: x (raw, then its hi part), x lo, W^T hi, W^T lo
constexpr int STAGE_BYTES = 2 * X_BYTES + 2 * W_BYTES;
constexpr int TX_BYTES = X_BYTES + 2 * W_BYTES;  // what TMA writes per stage
constexpr int BAR_BYTES = 2 * STAGES * 8;
// + 1024: the swizzled tiles need 1024-byte alignment, the base has 16
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + RED_BYTES + BAR_BYTES + 1024;
static_assert(SMEM_BYTES <= 232448, "shared memory over the sm_90 limit");

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
      mma_chunk(acc, base, base + X_BYTES, base + 2 * X_BYTES,
                base + 2 * X_BYTES + W_BYTES, g, t);
      mbar_arrive(&empty[st]);
    }
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

  const int col_tiles = (cout + BN - 1) / BN;
  const long long tiles = (long long)batch * col_tiles;
  int per_split = 0;
  const int splits = point_splits(sms, tiles, (n + BM - 1) / BM, &per_split);
  if (splits == 0) return static_cast<int>(cudaErrorInvalidValue);

  float* w_hi = static_cast<float*>(scratch);
  float* w_lo = w_hi + (size_t)cout * kp;
  float* out = w_lo + (size_t)cout * kp;
  CUtensorMap maps[3];
  if (!encode_ring_maps(maps, x, batch, n, x_cols, w_hi, w_lo, cout, kp)) {
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
