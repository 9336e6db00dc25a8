// Train-mode pooled-tail reductions: for c = x @ W + b over a ragged point
// axis, six per-(batch row, channel) reductions in one pass, with c never
// written to device memory:
//
//   cmax, amax   max over p < n and its first arg index
//   cmin, amin   min over p < n and its first arg index
//   rsum, rsq    sum and sum of squares over p < n (sum pool, BN statistics)
//
// Replaces the TPU kernel points2surf_tpu/ops/pallas/train_tail.py (_kernel,
// reached through pooled_tail_reductions / _pooled_tail_reductions) in its
// fp32 class (P2S_PALLAS_TAIL_PREC=highest): 3xTF32 products on the tensor
// cores (hopper_mma.cuh), ~2^-21 of each product short of fp32. The bf16
// class (default there) is pooled_tail_bf16.cu.
//
// What bounds it on an H100: arithmetic. The five conv3 tails of a train
// step at batch 1000 are x (B, n, 128) @ W (128, 1024) over n = 1300, 1000,
// 1000, 300, 300: 1.022 TFLOP, 6.20 ms at the 165 TFLOP/s of fp32-class
// work that 3xTF32 gets from the 495 TFLOP/s dense TF32 peak, against
// 0.6 ms to read x (2.0 GB) once at 3.35 TB/s. The literal version would
// write and re-read a (B, n, C) activation (5.3 GB for the 1,300-point
// tail).
//
// Design: chain_pool.cu's main loop with another epilogue. One block per
// (128-column tile, batch row), column tile fastest so that the 8 tiles of
// a row share its x slabs in L2. The block's W^T tile (hi and lo, 128 KB,
// from split_weights_kernel) is loaded once by TMA and stays resident; x
// streams in 128-point slabs through a 3-stage ring by TMA from its 3-D
// tensor map; two consumer warpgroups issue the wgmma, one thread of a
// producer warpgroup the loads. A stage is one 32-column chunk, split in
// place into tf32 hi and lo (mma_chunk). The point axis is not split, so
// every result, the sums included, is reduced in a fixed order: bitwise
// reproducible.
//
// Epilogue per slab: a thread holds 32 columns at 2 rows of its warp's 16
// (rows lane / 4 and lane / 4 + 8); their six running reductions would
// take 192 registers beside the 64 accumulators. Instead lanes rr and
// rr ^ 1 (rr = lane / 4) trade half their accumulators (32 shuffles), so
// that each holds 16 columns at 4 rows. It adds the bias and walks its rows
// in order into a running state of 16 x 6 registers that persists across
// slabs: strict compares keep the first index; rows >= n (TMA's zero rows)
// are skipped. A block of 288 threads would get at most 168 registers a
// thread (ptxas allocates for whole warpgroups); the producer warpgroup
// gives its registers to the consumers (setmaxnreg: 40 and 232). After the
// last slab the 32 partial states of each column (8 warps x 4 lane pairs)
// combine through shared memory that aliases the ring, in a fixed order
// ((value, index) pairs: the larger value, the lower index on equal
// values).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "hopper_mma.cuh"

namespace {

constexpr int CIN = 128;              // conv2 width feeding every conv3 tail
constexpr int BARS_BYTES = (2 * STAGES + 1) * 8;
constexpr int BLOCK = CONSUMERS + 128;  // and a producer warpgroup
constexpr int NC = 16;     // columns a lane reduces
constexpr int PARTS = 32;  // partial states of a column: 8 warps x 4 pairs
constexpr int NRED = 6;    // reductions per column

// Shared-memory plan: K chunks per slab, the resident W^T tiles (hi then
// lo), one ring stage (x chunk (raw, then hi), then lo).
constexpr int CHUNKS = CIN / BK;
constexpr int WRES_BYTES = 2 * CHUNKS * W_BYTES;
constexpr int STAGE_BYTES = 2 * X_BYTES;
// + 1024: the swizzled tiles need 1024-byte alignment, the base has 16
constexpr int SMEM_BYTES = WRES_BYTES + STAGES * STAGE_BYTES + BARS_BYTES +
                           1024;
static_assert(SMEM_BYTES <= 232448, "shared memory over the sm_90 limit");
static_assert(NRED * PARTS * BN * 4 <= STAGES * STAGE_BYTES,
              "the partial states alias the ring");

// column of the tile that lane slot c (of NC) holds after the exchange
__device__ __forceinline__ int lane_col(int c, int rr, int lane) {
  return 16 * (2 * (c >> 2) + (rr & 1)) + 8 * ((c >> 1) & 1) +
         2 * (lane % 4) + (c & 1);
}

// w_hi_map, w_lo_map: W^T split into tf32 hi and lo
__global__ void __launch_bounds__(BLOCK, 1)
pooled_tail_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_hi_map,
                   const __grid_constant__ CUtensorMap w_lo_map, int n,
                   int cout, int col_tiles, const float* __restrict__ bias,
                   float* __restrict__ cmax, int* __restrict__ amax,
                   float* __restrict__ cmin, int* __restrict__ amin,
                   float* __restrict__ rsum, float* __restrict__ rsq) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* w_res = smem;  // hi chunks, then lo chunks
  uint8_t* w_lo = smem + WRES_BYTES / 2;
  uint8_t* ring = smem + WRES_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* w_full = empty + STAGES;

  const int col0 = (blockIdx.x % col_tiles) * BN;
  const int b = blockIdx.x / col_tiles;
  const int n_slabs = (n + BM - 1) / BM;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == CONSUMERS) {
      mbar_expect_tx(w_full, WRES_BYTES);
      for (int k = 0; k < CHUNKS; ++k) {
        tma_load_2d(w_res + k * W_BYTES, &w_hi_map, w_full, k * BK, col0);
        tma_load_2d(w_lo + k * W_BYTES, &w_lo_map, w_full, k * BK, col0);
      }
      int it = 0;
      for (int s = 0; s < n_slabs; ++s) {
        for (int k = 0; k < CHUNKS; ++k, ++it) {
          const int st = it % STAGES;
          uint8_t* dst = ring + st * STAGE_BYTES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[st], X_BYTES);
          tma_load_3d(dst, &x_map, &full[st], k * BK, s * BM, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows 64 g .. 64 g + 63 of every slab
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int g = tid / 128;
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int rr = lane / 4;
  float bc[NC];
  float mx[NC], mn[NC], sm[NC], sq[NC];
  int ax[NC], an[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = col0 + lane_col(c, rr, lane);
    bc[c] = col < cout ? bias[col] : 0.f;
    mx[c] = -CUDART_INF_F;
    mn[c] = CUDART_INF_F;
    ax[c] = INT_MAX;
    an[c] = INT_MAX;
    sm[c] = 0.f;
    sq[c] = 0.f;
  }
  float acc[64];

  mbar_wait(w_full, 0);
  int it = 0;
  for (int s = 0; s < n_slabs; ++s) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int k = 0; k < CHUNKS; ++k, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      uint8_t* base = ring + st * STAGE_BYTES;
      mma_chunk(acc, base, base + X_BYTES, w_res + k * W_BYTES,
                w_lo + k * W_BYTES, g, t);
      mbar_arrive(&empty[st]);
    }
    // acc[8 J + 4 jj + 2 h + e] is row rr + 8 h, column 16 J + 8 jj +
    // 2 (lane % 4) + e. Lane rr keeps the blocks J with J % 2 == rr % 2 and
    // trades the others for lane rr ^ 1's: afterwards block 2 d + i holds
    // rows (rr & 6) + i and (rr & 6) + i + 8 of columns 16 (2 d + rr % 2) +
    // 8 jj + 2 (lane % 4) + e.
    const bool odd = (rr & 1) != 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float& p0 = acc[16 * d + i];
        float& p1 = acc[16 * d + 8 + i];
        const float got = __shfl_xor_sync(0xffffffffu, odd ? p0 : p1, 4);
        p0 = odd ? got : p0;
        p1 = odd ? p1 : got;
      }
    }
    // this lane's 4 rows in order; rows >= n are TMA's zeros, skipped
    const int row0 = s * BM + 64 * g + 16 * warp + (rr & 6);
    const int rows_left = n - row0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = i + 8 * h;
        if (r < rows_left) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float v = acc[8 * (2 * (c >> 2) + i) + 4 * ((c >> 1) & 1) +
                                2 * h + (c & 1)] +
                            bc[c];
            if (v > mx[c]) {
              mx[c] = v;
              ax[c] = row0 + r;
            }
            if (v < mn[c]) {
              mn[c] = v;
              an[c] = row0 + r;
            }
            sm[c] += v;
            sq[c] = fmaf(v, v, sq[c]);
          }
        }
      }
    }
  }

  // combine the partial states: red[q][part][column], aliasing the ring
  // once both warpgroups are done with it
  float* red = reinterpret_cast<float*>(ring);
  int* ired = reinterpret_cast<int*>(ring);
  constexpr int Q = PARTS * BN;  // one reduction's partials
  asm volatile("bar.sync 3, 256;" ::: "memory");
  const int part = 4 * (4 * g + warp) + rr / 2;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int o = part * BN + lane_col(c, rr, lane);
    red[o] = mx[c];
    ired[Q + o] = ax[c];
    red[2 * Q + o] = mn[c];
    ired[3 * Q + o] = an[c];
    red[4 * Q + o] = sm[c];
    red[5 * Q + o] = sq[c];
  }
  asm volatile("bar.sync 3, 256;" ::: "memory");
  const int col = col0 + tid;
  if (tid < BN && col < cout) {
    float vmax = red[tid], vmin = red[2 * Q + tid];
    int imax = ired[Q + tid], imin = ired[3 * Q + tid];
    float vs = red[4 * Q + tid], vq = red[5 * Q + tid];
    for (int p = 1; p < PARTS; ++p) {
      const int o = p * BN + tid;
      const float u = red[o];
      const int iu = ired[Q + o];
      if (u > vmax || (u == vmax && iu < imax)) {
        vmax = u;
        imax = iu;
      }
      const float l = red[2 * Q + o];
      const int il = ired[3 * Q + o];
      if (l < vmin || (l == vmin && il < imin)) {
        vmin = l;
        imin = il;
      }
      vs += red[4 * Q + o];
      vq += red[5 * Q + o];
    }
    const size_t out = (size_t)b * cout + col;
    cmax[out] = vmax;
    amax[out] = imax;
    cmin[out] = vmin;
    amin[out] = imin;
    rsum[out] = vs;
    rsq[out] = vq;
  }
}

}  // namespace

// On device `dev` and its stream `stream`: for c = x @ w + b, the six
// reductions over p < n, each (batch, cout): cmax, cmin, rsum, rsq fp32,
// amax, amin int32 (first index on ties), with fp32-class products. x is
// (batch, n, k) with k == 128, base 16-byte aligned; w (k, cout); b
// (cout,). scratch (16-byte aligned) holds 2 * cout * 128 floats (the split
// W^T). All contiguous. Returns a cudaError_t; 0 means launched.
extern "C" int p2s_pooled_tail(int dev, const void* x, int batch, int n,
                               int k, const void* w, const void* b, int cout,
                               void* scratch, void* cmax,
                               void* amax, void* cmin, void* amin,
                               void* rsum, void* rsq, void* stream) {
  const int col_tiles = (cout + BN - 1) / BN;
  if (k != CIN || n < 1 || batch < 1 || cout < 1 ||
      (long long)batch * col_tiles > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the shared-memory attribute, once per device
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const DeviceGuard guard(dev);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(pooled_tail_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 prep_grid(CIN / 32, (cout + 31) / 32);
  const unsigned blocks = (unsigned)(batch * col_tiles);
  const float* bias = static_cast<const float*>(b);

  CUtensorMap maps[3];
  float* w_hi = static_cast<float*>(scratch);
  float* w_lo = w_hi + (size_t)cout * CIN;
  if (!encode_ring_maps(maps, x, batch, n, CIN, w_hi, w_lo, cout, CIN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_weights_kernel<<<prep_grid, dim3(32, 8), 0, st>>>(
      static_cast<const float*>(w), CIN, cout, CIN, w_hi, w_lo, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pooled_tail_kernel<<<blocks, BLOCK, SMEM_BYTES, st>>>(
      maps[0], maps[1], maps[2], n, cout, col_tiles, bias,
      static_cast<float*>(cmax), static_cast<int*>(amax),
      static_cast<float*>(cmin), static_cast<int*>(amin),
      static_cast<float*>(rsum), static_cast<float*>(rsq));
  return static_cast<int>(cudaGetLastError());
}
