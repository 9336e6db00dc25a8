// Fused eval chain, layer 3 and the pool: the last pointwise layer with its
// folded BatchNorm affine, then a max or sum pool over the point axis.
//
//   out[b, j] = pool_{p < n} act(h2[b, p, :] @ W3[:, j] * a3[j] + c3[j])
//   act = relu with relu_last, else the identity
//
// h2 = relu(L2(relu(L1(x)))) comes from chain_head.cu; the two kernels
// together replace the TPU kernel points2surf_tpu/ops/pallas/chain_kernel.py
// (_chain_pool, :187, reached through chain_pool) in its fp32 class
// (P2S_EVAL_CHAIN_PREC=highest there; the bf16 class is chain_fused.cu):
// 3xTF32 products on the tensor cores (hopper_mma.cuh), ~2^-21 of each
// product short of fp32; the affine, the relu and the pools are fp32.
//
// What bounds it on an H100: arithmetic. A query forward's five chains do
// 2 n (Cin 64 + 64 128 + 128 Cout) FLOP per row and chain, 4.54 TFLOP per
// batch of 4096 (92% of it here, in 128 -> 1024); at the 165 TFLOP/s of
// fp32-class work that 3xTF32 gets from the 495 TFLOP/s dense TF32 peak
// that is 27.5 ms, against ~0.8 ms to read the inputs once. The SIMT fp32
// kernel this replaces ran near 27 TFLOP/s, well under the 67 TFLOP/s that
// the fp32 pipes could give at best.
//
// Design: mlp_maxpool.cu's, generalised (the W3^T hi/lo prologue, the
// 3xTF32 chunk product and the helpers are hopper_mma.cuh). grid = column
// tile of 128 (fastest, so the 8 blocks that read one h2 slab run together
// and share it in L2) x point split x batch row. A block loads its W3^T
// tile, hi and lo (128 KB for k = 128), once by TMA and keeps it resident;
// only h2 streams through a 3-stage ring, by TMA from its 3-D tensor map
// (128, n, B): a third of the shared-memory traffic of mlp_maxpool's ring,
// which streams W beside x for every slab. After each slab every
// accumulator gets fmaf(acc, a3, c3) and the optional relu before it is
// pooled, so a negative scale needs no special case; rows >= n are masked
// to -inf for max, to 0 for sum (TMA's zero rows would otherwise win a max
// or add relu(c3)). Max may split the point axis when batch * column tiles
// is short of the SM count (an atomic max on the float's bits: order-free,
// so deterministic); sum never splits, and its per-thread, shuffle and
// per-warp orders are fixed, so it is deterministic too. 231,480 bytes of
// shared memory, one block per SM.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

// W3^T stays resident: a block's column tile, hi and lo, every K chunk of
// k <= 128; only h2 streams through the ring.
constexpr int K_MAX = 128;
constexpr int AC_BYTES = 2 * BN * 4;          // the tile's a3, then c3
constexpr int BARS_BYTES = (2 * STAGES + 1) * 8;

// Shared-memory plan: the resident W^T (hi chunks then lo chunks), one ring
// stage (an h2 chunk, split in place into its hi part, then its lo part)
// and the bytes TMA brings into it.
constexpr int WRES_BYTES = 2 * (K_MAX / BK) * W_BYTES;
constexpr int STAGE_BYTES = 2 * X_BYTES;
constexpr int TX_BYTES = X_BYTES;

// + 1024: the swizzled tiles need 1024-byte alignment, the base has 16
constexpr int SMEM_BYTES =
    WRES_BYTES + STAGES * STAGE_BYTES + AC_BYTES + BARS_BYTES + 1024;
static_assert(SMEM_BYTES <= 232448, "shared memory over the limit");
static_assert(RED_BYTES <= STAGES * STAGE_BYTES, "red aliases the ring");

// w_hi_map / w_lo_map: W3^T's tf32 hi and lo parts
template <bool kMax, bool kRelu>
__global__ void __launch_bounds__(THREADS, 1)
chain_pool_kernel(const __grid_constant__ CUtensorMap h_map,
                  const __grid_constant__ CUtensorMap w_hi_map,
                  const __grid_constant__ CUtensorMap w_lo_map, int n,
                  int kp, int cout, int col_tiles, int splits,
                  int slabs_per_split, const float* __restrict__ a3,
                  const float* __restrict__ c3, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* w_res = smem;  // hi chunks, then lo chunks
  uint8_t* w_lo = smem + WRES_BYTES / 2;
  uint8_t* ring = smem + WRES_BYTES;
  float* red = reinterpret_cast<float*>(ring);  // after the last slab
  float* ac = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ac + 2 * BN);
  uint64_t* empty = full + STAGES;
  uint64_t* w_full = empty + STAGES;

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
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < BN) {
    const int col = col0 + tid;
    ac[tid] = col < cout ? a3[col] : 0.f;
    ac[BN + tid] = col < cout ? c3[col] : 0.f;
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp: one thread issues every load
    if (tid == CONSUMERS) {
      mbar_expect_tx(w_full, 2 * chunks * W_BYTES);
      for (int k = 0; k < chunks; ++k) {
        tma_load_2d(w_res + k * W_BYTES, &w_hi_map, w_full, k * BK, col0);
        tma_load_2d(w_lo + k * W_BYTES, &w_lo_map, w_full, k * BK, col0);
      }
      int it = 0;
      for (int s = slab0; s < slab1; ++s) {
        for (int k = 0; k < chunks; ++k, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[st], TX_BYTES);
          tma_load_3d(ring + st * STAGE_BYTES, &h_map, &full[st], k * BK,
                      s * BM, b);
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
  const float empty_row = kMax ? -CUDART_INF_F : 0.f;
  float acc[64];
  float run[32];  // running pool of this thread's 32 columns
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = empty_row;

  mbar_wait(w_full, 0);
  int it = 0;
  for (int s = slab0; s < slab1; ++s) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int k = 0; k < chunks; ++k, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      uint8_t* base = ring + st * STAGE_BYTES;
      mma_chunk(acc, base, base + X_BYTES, w_res + k * W_BYTES,
                w_lo + k * W_BYTES, g, t);
      mbar_arrive(&empty[st]);
    }
    // this thread's rows: r and r + 8 (acc[4 j + e] and acc[4 j + 2 + e])
    const int rows_left = n - s * BM - 64 * g - 16 * warp - lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 a = *reinterpret_cast<const float2*>(ac + col);
      const float2 c = *reinterpret_cast<const float2*>(ac + BN + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float aa = e ? a.y : a.x;
        const float cc = e ? c.y : c.x;
        float v0 = fmaf(acc[4 * j + e], aa, cc);
        float v1 = fmaf(acc[4 * j + 2 + e], aa, cc);
        if (kRelu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        float m = rows_left > 0 ? v0 : empty_row;
        if (rows_left > 8) m = kMax ? fmaxf(m, v1) : m + v1;
        run[2 * j + e] = kMax ? fmaxf(run[2 * j + e], m) : run[2 * j + e] + m;
      }
    }
  }

  // combine the 8 lanes that share a column, then the 8 consumer warps
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float v = run[i];
#pragma unroll
    for (int o = 4; o < 32; o *= 2) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? fmaxf(v, u) : v + u;
    }
    run[i] = v;
  }
  // red aliases the ring: both warpgroups are done with it first
  asm volatile("bar.sync 3, 256;" ::: "memory");
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
    for (int r = 1; r < 8; ++r) {
      v = kMax ? fmaxf(v, red[r * BN + tid]) : v + red[r * BN + tid];
    }
    float* dst = out + (size_t)b * cout + col;
    if (kMax && splits > 1) {
      atomic_max_float(dst, v);
    } else {
      *dst = v;
    }
  }
}

template <bool kMax, bool kRelu>
cudaError_t launch(const CUtensorMap (&maps)[3], unsigned blocks,
                   cudaStream_t st, int n, int kp, int cout, int col_tiles,
                   int splits, int per_split, const float* a3,
                   const float* c3, float* out) {
  chain_pool_kernel<kMax, kRelu><<<blocks, THREADS, SMEM_BYTES, st>>>(
      maps[0], maps[1], maps[2], n, kp, cout, col_tiles, splits, per_split,
      a3, c3, out);
  return cudaGetLastError();
}

template <bool kMax, bool kRelu>
cudaError_t allow_smem_one() {
  return cudaFuncSetAttribute(chain_pool_kernel<kMax, kRelu>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

// the shared-memory attribute of all four instantiations
cudaError_t allow_smem() {
  const cudaError_t errs[4] = {
      allow_smem_one<true, false>(), allow_smem_one<true, true>(),
      allow_smem_one<false, false>(), allow_smem_one<false, true>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t launch_mode(bool sym_max, bool relu_last,
                        const CUtensorMap (&maps)[3], unsigned blocks,
                        cudaStream_t st, int n, int kp, int cout,
                        int col_tiles, int splits, int per_split,
                        const float* a3, const float* c3, float* out) {
  if (sym_max) {
    return relu_last ? launch<true, true>(maps, blocks, st, n, kp, cout,
                                          col_tiles, splits, per_split, a3,
                                          c3, out)
                     : launch<true, false>(maps, blocks, st, n, kp, cout,
                                           col_tiles, splits, per_split, a3,
                                           c3, out);
  }
  return relu_last ? launch<false, true>(maps, blocks, st, n, kp, cout,
                                         col_tiles, splits, per_split, a3,
                                         c3, out)
                   : launch<false, false>(maps, blocks, st, n, kp, cout,
                                          col_tiles, splits, per_split, a3,
                                          c3, out);
}

}  // namespace

// On device `dev` and its stream `stream`: out (batch, cout) =
// pool_{p < n} act(h[b, p, :] @ w * a + c), max if sym_max else sum, relu
// if relu_last. h is (batch, n, k), k <= 128 a multiple of 4, base 16-byte
// aligned; w (k, cout); a, c (cout,), all fp32; fp32-class products.
// scratch holds 2 * cout * kp + batch * cout floats, kp = k rounded up to
// 8: the split W^T, then out; 16-byte aligned. All contiguous. Returns a
// cudaError_t; 0 means launched.
extern "C" int p2s_chain_pool(int dev, const void* h, int batch, int n, int k,
                              const void* w, const void* a, const void* c,
                              int cout, int sym_max, int relu_last,
                              void* scratch, void* stream) {
  const int kp = (k + 7) / 8 * 8;
  if (batch < 1 || n < 1 || k < 4 || k % 4 != 0 || kp > K_MAX || cout < 1 ||
      reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the SM count and the shared-memory attribute, once per device
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
    if (err == cudaSuccess) err = allow_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[dev] = sms;
  }

  const int col_tiles = (cout + BN - 1) / BN;
  const int n_slabs = (n + BM - 1) / BM;
  const long long tiles = (long long)batch * col_tiles;
  int per_split = n_slabs;
  // a sum keeps each row's points in one block, in a fixed order
  const int splits =
      sym_max ? point_splits(sms, tiles, n_slabs, &per_split)
              : (tiles > 0x7fffffffLL ? 0 : 1);
  if (splits == 0) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap maps[3];
  float* w_hi = static_cast<float*>(scratch);
  float* w_lo = w_hi + (size_t)cout * kp;
  float* out = w_lo + (size_t)cout * kp;
  if (!encode_ring_maps(maps, h, batch, n, k, w_hi, w_lo, cout, kp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the prologue fills out with -inf only where split blocks combine in it
  const dim3 prep_grid((kp + 31) / 32, (cout + 31) / 32);
  const size_t fill = splits > 1 ? (size_t)batch * cout : 0;
  split_weights_kernel<<<prep_grid, dim3(32, 8), 0, st>>>(
      static_cast<const float*>(w), k, cout, kp, w_hi, w_lo, out, fill);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)(tiles * splits);
  const float* a3 = static_cast<const float*>(a);
  const float* c3 = static_cast<const float*>(c);
  err = launch_mode(sym_max, relu_last, maps, blocks, st, n, kp, cout,
                    col_tiles, splits, per_split, a3, c3, out);
  return static_cast<int>(err);
}
