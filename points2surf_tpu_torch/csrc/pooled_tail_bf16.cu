// Train-mode pooled-tail reductions in the bf16-operand class: for
// c = r(x) @ r(W) + b over a ragged point axis (r rounds to the nearest
// bf16, ties to even; products accumulate in fp32, then the bias is added),
// six per-(batch row, channel) reductions in one pass, c never written:
//
//   cmax, amax   max over p < n and its first arg index
//   cmin, amin   min over p < n and its first arg index
//   rsum, rsq    sum and sum of squares over p < n
//
// Replaces the TPU kernel points2surf_tpu/ops/pallas/train_tail.py
// (_kernel with bf16_operands, reached through _pooled_tail_reductions, :138;
// P2S_PALLAS_TAIL_PREC=default). The fp32 class stays with pooled_tail.cu.
//
// What bounds it on an H100. The five conv3 tails of a train step at batch
// 1000 are x (B, n, 128) @ W (128, 1024) over n = 1300, 1000, 1000, 300,
// 300: 3.99e9 products, 1.03 ms at the 989 TFLOP/s dense bf16 peak, against
// 0.6 ms to read x (2.0 GB, fp32) once at 3.35 TB/s. Beside the tensor work
// the six reductions cost 9 CUDA-core instructions per product (the bias
// add, two compare-and-selects that carry an index, an add and an fma):
// 36e9 lane instructions, 1.1-1.5 ms at 132 SMs x 128 lanes, as much as the
// tensor bound; the register layout of the accumulators adds the lane
// exchanges below.
//
// Design. Persistent blocks, one per SM, from the wrapper's launch plan
// (ops/kernels/pooled_tail.py bf16_launch_plan): block i keeps the W^T
// slice i % slices (256 columns, 64 KB in bf16, loaded once by TMA) and
// walks the batch rows i / slices, + blocks / slices, ...; the blocks that
// share a row are neighbours in launch order, so they read its x at about
// the same time and x crosses L2 four times at C = 1024 (a 128-column
// block read it eight times). A row's 128-point slabs stream by TMA as
// four fp32 32-column chunks into a staging ring; the producer warpgroup
// rounds each chunk to bf16 into the slab's 128-byte swizzled tile (two
// stages), once per block, and refills the chunk's staging slot with the
// next slab's chunk. Two consumer warpgroups each own 128 of the slice's
// columns and walk both 64-row halves of every slab, each an m64n128 bf16
// wgmma product over K = 128 into one 64-register accumulator. The tensor
// work of one warpgroup runs beside the other warpgroup's epilogue. A
// second accumulator per warpgroup, to overlap an epilogue with the next
// product, measured slower: the registers it takes spill the running state
// (blocks of 384 threads get 168 registers a thread), and carried across a
// loop iteration it makes ptxas serialize every wgmma (C7514). The point
// axis is never split, so every result, the sums included, is reduced in
// one fixed order: reruns are bit-identical.
//
// Epilogue per row half: a lane holds 32 columns at 2 rows (rr = lane / 4
// and rr + 8 of its warp's 16). Lanes rr and rr ^ 1 trade half of them,
// then lanes rr and rr ^ 2 (64 shuffles), so that each holds 8 columns at
// 8 rows; it adds the bias and walks its rows in order into a running
// state of 8 columns x 6 registers: strict compares keep the first index;
// rows >= n (TMA's zero rows) are skipped, tested only in a row's last
// slab. At a row's end the lanes rr and rr ^ 4 that
// share a column combine by shuffles, then the 4 warps through shared
// memory in warp order ((value, index) pairs: the larger value, the lower
// index on equal values), and each consumer thread writes one column. The
// producer warpgroup gives its registers to the consumers (setmaxnreg 40 /
// 232).
//
// Shared memory (bytes): W^T slice 65,536 (2 K chunks of 256 x 64 bf16),
// bf16 x tiles 65,536 (2 stages x 2 K chunks of 128 x 64), fp32 staging
// 65,536 (4 chunks of 128 x 32), the warps' partials 24,576 (2 warpgroups x
// 4 warps x 6 x 128 fp32), 9 mbarriers 72; 222,280 with the 1,024-byte
// alignment of the swizzled tiles, of the 232,448 a block may have.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "hopper_mma.cuh"

namespace {

constexpr int CIN = 128;            // conv2 width feeding every conv3 tail
constexpr int SLICE = 256;          // W^T columns a block keeps
constexpr int WG_COLS = 128;        // columns a consumer warpgroup owns
constexpr int SLAB = 128;           // points per slab: two 64-row halves
constexpr int WGS = 2;              // consumer warpgroups
constexpr int BLOCK = 128 * (WGS + 1);  // and a producer warpgroup
constexpr int ROW_BYTES = 128;      // one swizzled row: 64 bf16 or 32 fp32
constexpr int W_CHUNK = SLICE * ROW_BYTES;   // 256 columns x 64 k
constexpr int XB_CHUNK = SLAB * ROW_BYTES;   // 128 points x 64 k, bf16
constexpr int XB_TILE = 2 * XB_CHUNK;        // a slab in bf16
constexpr int XB_STAGES = 2;
constexpr int STG_CHUNK = SLAB * ROW_BYTES;  // 128 points x 32 k, fp32
constexpr int STG_CHUNKS = CIN / 32;         // a slab: the staging ring
constexpr int NC = 8;     // columns a lane reduces
constexpr int NRED = 6;   // reductions per column
constexpr int RED_FLOATS = 4 * NRED * WG_COLS;  // a warpgroup's four warps
constexpr int OFF_W = 0;
constexpr int OFF_XB = OFF_W + 2 * W_CHUNK;
constexpr int OFF_STG = OFF_XB + XB_STAGES * XB_TILE;
constexpr int OFF_RED = OFF_STG + STG_CHUNKS * STG_CHUNK;
constexpr int OFF_BARS = OFF_RED + WGS * RED_FLOATS * 4;
constexpr int N_BARS = 1 + STG_CHUNKS + 2 * XB_STAGES;
// + 1024: the swizzled tiles need 1024-byte alignment, the base has 16
constexpr int SMEM_BYTES = OFF_BARS + N_BARS * 8 + 1024;
static_assert(SMEM_BYTES == 222280, "the plan in pooled_tail.py differs");
static_assert(SMEM_BYTES <= 232448, "shared memory over the limit");

// The producer's share of one fp32 chunk j (128 points x 32 k, as TMA
// writes it with the 128-byte swizzle) of a slab: thread pt rounds row pt
// to bf16 into units 4 (j % 2) .. + 3 of K chunk j / 2 of the bf16 tile.
// The 16-byte unit p of row r holds logical unit p ^ (r % 8) in either
// layout; bf16 unit u is fp32 units 2 u and 2 u + 1 (u taken mod 4). Eight
// consecutive threads take eight rows, so every load and store of a phase
// hits distinct banks. Shared-space loads and stores on 32-bit addresses:
// generic ones cost 64-bit address arithmetic (4% slower on an H100).
__device__ __forceinline__ void round_chunk(uint32_t tile, uint32_t src, int j,
                                            int pt) {
  const int s = pt & 7;
  const uint32_t in = src + ROW_BYTES * pt;
  const uint32_t out = tile + (j >> 1) * XB_CHUNK + ROW_BYTES * pt;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float a0, a1, a2, a3, b0, b1, b2, b3;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(a0), "=f"(a1), "=f"(a2), "=f"(a3)
                 : "r"(in + 16 * ((2 * u) ^ s)));
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(b0), "=f"(b1), "=f"(b2), "=f"(b3)
                 : "r"(in + 16 * ((2 * u + 1) ^ s)));
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                     out + 16 * ((4 * (j & 1) + u) ^ s)),
                 "r"(pack_bf16x2(a0, a1)), "r"(pack_bf16x2(a2, a3)),
                 "r"(pack_bf16x2(b0, b1)), "r"(pack_bf16x2(b2, b3))
                 : "memory");
  }
}

// sw128_desc of the K-major tile at shared address `a`, from its low word
// (the start address in 16-byte units; the high word is constant), so that
// a k step or a chunk further is a 32-bit add
__device__ __forceinline__ uint32_t desc_lo(uint32_t a) {
  return ((a & 0x3FFFF) >> 4) | (1u << 16);
}

__device__ __forceinline__ uint64_t desc(uint32_t lo) {
  return (static_cast<uint64_t>(64u | (1u << 30)) << 32) | lo;
}

// Issue one row half's product and wait for it: d = x rows (64, from the
// tile at descriptor word xa) . the warpgroup's W^T columns (128, at wb),
// K = 128 in eight k16 steps over the two 64-k chunks of each tile
__device__ __forceinline__ void product(float (&d)[64], uint32_t xa,
                                        uint32_t wb) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < CIN / 16; ++kk) {
    wgmma_bf16(d, desc(xa + (kk / 4) * (XB_CHUNK >> 4) + 2 * (kk % 4)),
               desc(wb + (kk / 4) * (W_CHUNK >> 4) + 2 * (kk % 4)), kk);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);
}

// column of the warpgroup's 128 that lane slot c (of NC) holds after the
// two exchanges: 16-column block 4 (c / 4) + 2 ((rr >> 1) & 1) + (rr & 1)
__device__ __forceinline__ int slot_col(int c, int rr, int lane) {
  return 64 * (c >> 2) + 16 * (2 * ((rr >> 1) & 1) + (rr & 1)) +
         8 * ((c >> 1) & 1) + 2 * (lane % 4) + (c & 1);
}

struct State {
  float mx[NC], mn[NC], sm[NC], sq[NC];
  int ax[NC], an[NC];
};

// One row half's epilogue. acc[4 j + 2 h + e] is row rr + 8 h of the
// warp's 16, column 8 j + 2 (lane % 4) + e. First lanes rr and rr ^ 1 trade
// the 16-column blocks J = j / 2: lane rr keeps the blocks with J % 2 ==
// rr % 2 (acc[16 d + 8 i + 4 jj + 2 h + e]: row (rr & 6) + i + 8 h, block
// 2 d + rr % 2); then lanes rr and rr ^ 2 trade the blocks d: lane rr keeps
// d % 2 == (rr >> 1) & 1. Afterwards acc[32 q + 16 a + 8 i + 4 jj + 2 h +
// e] is row row0 + 2 a + i + 8 h, slot 4 q + 2 jj + e; row0: the lane's
// first row in the batch row. Each trade keeps the lower rows first, so
// the rows are walked in order.
template <bool kMasked>
__device__ __forceinline__ void reduce_half(float (&acc)[64], int rr,
                                            int row0, int n,
                                            const float (&bc)[NC],
                                            State& st) {
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
  const bool hi2 = (rr & 2) != 0;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      float& p0 = acc[32 * q + m];
      float& p1 = acc[32 * q + 16 + m];
      const float got = __shfl_xor_sync(0xffffffffu, hi2 ? p0 : p1, 8);
      p0 = hi2 ? got : p0;
      p1 = hi2 ? p1 : got;
    }
  }
  const int rows_left = n - row0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * a + i + 8 * h;
        if (!kMasked || r < rows_left) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float v = acc[32 * (c >> 2) + 16 * a + 8 * i +
                                4 * ((c >> 1) & 1) + 2 * h + (c & 1)] +
                            bc[c];
            if (v > st.mx[c]) {
              st.mx[c] = v;
              st.ax[c] = row0 + r;
            }
            if (v < st.mn[c]) {
              st.mn[c] = v;
              st.an[c] = row0 + r;
            }
            st.sm[c] += v;
            st.sq[c] = fmaf(v, v, st.sq[c]);
          }
        }
      }
    }
  }
}

// (value, index) of the other lane or warp into (v, a) for a max (kMax) or
// a min: the better value, the lower index on equal values
template <bool kMax>
__device__ __forceinline__ void take(float u, int iu, float& v, int& a) {
  if ((kMax ? u > v : u < v) || (u == v && iu < a)) {
    v = u;
    a = iu;
  }
}

__global__ void __launch_bounds__(BLOCK, 1)
pooled_tail_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w_map, int batch,
                        int n, int cout, int slices,
                        const float* __restrict__ bias,
                        float* __restrict__ cmax, int* __restrict__ amax,
                        float* __restrict__ cmin, int* __restrict__ amin,
                        float* __restrict__ rsum, float* __restrict__ rsq) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ws = smem + OFF_W;
  uint8_t* stg = smem + OFF_STG;
  const uint32_t xb_s = smem_u32(smem + OFF_XB);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + OFF_BARS);
  uint64_t* stg_full = w_full + 1;
  uint64_t* xb_full = stg_full + STG_CHUNKS;
  uint64_t* xb_empty = xb_full + XB_STAGES;

  // the block's slice and rows (bf16_launch_plan in ops/kernels/
  // pooled_tail.py; tests/test_torch_pooled_tail_bf16.py mirrors them)
  const int col0 = (blockIdx.x % slices) * SLICE;
  const int row_first = blockIdx.x / slices;
  const int row_step = gridDim.x / slices;
  const int n_slabs = (n + SLAB - 1) / SLAB;
  const int rows_mine =
      row_first < batch ? (batch - 1 - row_first) / row_step + 1 : 0;
  const int total = rows_mine * n_slabs;  // slabs the block walks
  const int tid = threadIdx.x;
  // the warpgroup index, warp-uniform (the descriptors stay uniform)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    mbar_init(w_full, 1);
    for (int j = 0; j < STG_CHUNKS; ++j) mbar_init(&stg_full[j], 1);
    for (int s = 0; s < XB_STAGES; ++s) {
      mbar_init(&xb_full[s], 128);
      mbar_init(&xb_empty[s], 128 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (g == WGS) {
    // producer warpgroup: thread 0 issues the TMA loads, all 128 round
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pt = tid - 128 * WGS;
    if (pt == 0) {
      // columns past cout arrive as zeros (and count in full)
      mbar_expect_tx(w_full, 2 * W_CHUNK);
      tma_load_2d(ws, &w_map, w_full, 0, col0);
      tma_load_2d(ws + W_CHUNK, &w_map, w_full, 64, col0);
      if (total > 0) {
        for (int j = 0; j < STG_CHUNKS; ++j) {
          mbar_expect_tx(&stg_full[j], STG_CHUNK);
          tma_load_3d(stg + j * STG_CHUNK, &x_map, &stg_full[j], 32 * j, 0,
                      row_first);
        }
      }
    }
    const uint32_t stg_s = smem_u32(stg);
    for (int it = 0; it < total; ++it) {
      const int xs = it % XB_STAGES;
      const int nx = it + 1;  // the slab whose chunks refill the staging
      const int nb = row_first + (nx / n_slabs) * row_step;
      const int nrow0 = (nx % n_slabs) * SLAB;
      mbar_wait(&xb_empty[xs], ((it / XB_STAGES) & 1) ^ 1);
      for (int j = 0; j < STG_CHUNKS; ++j) {
        mbar_wait(&stg_full[j], it & 1);
        round_chunk(xb_s + xs * XB_TILE, stg_s + j * STG_CHUNK, j, pt);
        // every producer thread is done with the staged chunk
        asm volatile("bar.sync 3, 128;" ::: "memory");
        if (pt == 0 && nx < total) {
          mbar_expect_tx(&stg_full[j], STG_CHUNK);
          tma_load_3d(stg + j * STG_CHUNK, &x_map, &stg_full[j], 32 * j,
                      nrow0, nb);
        }
      }
      // generic-proxy writes -> visible to wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&xb_full[xs]);
    }
    return;
  }

  // consumer warpgroup g: columns 128 g .. 128 g + 127 of the slice
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int rr = lane / 4;
  const int wcol0 = col0 + WG_COLS * g;
  float bc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = wcol0 + slot_col(c, rr, lane);
    bc[c] = col < cout ? bias[col] : 0.f;
  }
  float* red = reinterpret_cast<float*>(smem + OFF_RED) + g * RED_FLOATS;
  int* ired = reinterpret_cast<int*>(red);
  // descriptor words: the warpgroup's 128 W^T columns, the bf16 tiles
  const uint32_t wd = desc_lo(smem_u32(ws) + WG_COLS * g * ROW_BYTES);
  const uint32_t xd = desc_lo(xb_s);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  State st;

  mbar_wait(w_full, 0);
  int it = 0;
  for (int i = 0; i < rows_mine; ++i) {
    const int b = row_first + i * row_step;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      st.mx[c] = -CUDART_INF_F;
      st.mn[c] = CUDART_INF_F;
      st.ax[c] = INT_MAX;
      st.an[c] = INT_MAX;
      st.sm[c] = 0.f;
      st.sq[c] = 0.f;
    }
    for (int s = 0; s < n_slabs; ++s, ++it) {
      const int xs = it % XB_STAGES;
      const int row0 = s * SLAB + 16 * warp + (rr & 4);
      const bool masked = (s + 1) * SLAB > n;
      mbar_wait(&xb_full[xs], (it / XB_STAGES) & 1);
      // the row halves: not unrolled, which keeps the loop's code small
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        product(acc, xd + ((xs * XB_TILE + h * 64 * ROW_BYTES) >> 4), wd);
        if (h == 1) mbar_arrive(&xb_empty[xs]);
        if (masked) {
          reduce_half<true>(acc, rr, row0 + 64 * h, n, bc, st);
        } else {
          reduce_half<false>(acc, rr, row0 + 64 * h, n, bc, st);
        }
      }
    }
    // the row's end: the two lanes of a column (lane ^ 16), then the four
    // warps in order through shared memory
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      take<true>(__shfl_xor_sync(0xffffffffu, st.mx[c], 16),
                 __shfl_xor_sync(0xffffffffu, st.ax[c], 16), st.mx[c],
                 st.ax[c]);
      take<false>(__shfl_xor_sync(0xffffffffu, st.mn[c], 16),
                  __shfl_xor_sync(0xffffffffu, st.an[c], 16), st.mn[c],
                  st.an[c]);
      st.sm[c] += __shfl_xor_sync(0xffffffffu, st.sm[c], 16);
      st.sq[c] += __shfl_xor_sync(0xffffffffu, st.sq[c], 16);
    }
    if (lane < 16) {
      float* wr = red + warp * NRED * WG_COLS;
      int* iwr = ired + warp * NRED * WG_COLS;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = slot_col(c, rr, lane);
        wr[col] = st.mx[c];
        iwr[WG_COLS + col] = st.ax[c];
        wr[2 * WG_COLS + col] = st.mn[c];
        iwr[3 * WG_COLS + col] = st.an[c];
        wr[4 * WG_COLS + col] = st.sm[c];
        wr[5 * WG_COLS + col] = st.sq[c];
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
    const int col = wcol0 + t;
    if (col < cout) {
      float vmax = red[t], vmin = red[2 * WG_COLS + t];
      int imax = ired[WG_COLS + t], imin = ired[3 * WG_COLS + t];
      float vs = red[4 * WG_COLS + t], vq = red[5 * WG_COLS + t];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const int o = w * NRED * WG_COLS + t;
        take<true>(red[o], ired[WG_COLS + o], vmax, imax);
        take<false>(red[2 * WG_COLS + o], ired[3 * WG_COLS + o], vmin,
                    imin);
        vs += red[4 * WG_COLS + o];
        vq += red[5 * WG_COLS + o];
      }
      const size_t out = (size_t)b * cout + col;
      cmax[out] = vmax;
      amax[out] = imax;
      cmin[out] = vmin;
      amin[out] = imin;
      rsum[out] = vs;
      rsq[out] = vq;
    }
    // the partials are read before the next row writes them
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
  }
}

}  // namespace

// On device `dev` and its stream `stream`: for c = r(x) @ r(w) + b (r:
// round to bf16, ties to even; fp32 accumulation), the six reductions over
// p < n, each (batch, cout): cmax, cmin, rsum, rsq fp32, amax, amin int32
// (first index on ties). x is (batch, n, k) with k == 128, base 16-byte
// aligned; w (k, cout); b (cout,). The launch plan: blocks (a multiple of
// the cout / 256 slices, at most batch per slice), smem_bytes as this file
// computes it. scratch (16-byte aligned) holds cout * 128 bf16 (W^T). All
// contiguous. Returns a cudaError_t; 0 means launched.
extern "C" int p2s_pooled_tail_bf16(int dev, const void* x, int batch, int n,
                                    int k, const void* w, const void* b,
                                    int cout, int blocks, int smem_bytes,
                                    void* scratch, void* cmax, void* amax,
                                    void* cmin, void* amin, void* rsum,
                                    void* rsq, void* stream) {
  const int slices = (cout + SLICE - 1) / SLICE;
  if (k != CIN || n < 1 || batch < 1 || cout < 1 ||
      smem_bytes != SMEM_BYTES || blocks < slices || blocks % slices != 0 ||
      blocks / slices > batch ||
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
    err = cudaFuncSetAttribute(pooled_tail_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* w_bf = static_cast<__nv_bfloat16*>(scratch);
  // x (batch, n, 128) fp32 by (32, SLAB, 1) boxes; W^T (cout, 128) bf16 by
  // (64, SLICE) boxes; both with the 128-byte swizzle
  const cuuint64_t x_dims[3] = {CIN, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t x_strides[2] = {CIN * 4, (cuuint64_t)CIN * 4 * n};
  const cuuint32_t x_box[3] = {32, SLAB, 1};
  const cuuint64_t w_dims[2] = {CIN, (cuuint64_t)cout};
  const cuuint64_t w_strides[1] = {CIN * 2};
  const cuuint32_t w_box[2] = {64, SLICE};
  CUtensorMap x_map, w_map;
  if (!encode(&x_map, x, 3, x_dims, x_strides, x_box) ||
      !encode(&w_map, w_bf, 2, w_dims, w_strides, w_box,
              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bf16_weights_kernel<<<dim3(CIN / 32, (cout + 31) / 32), dim3(32, 8), 0,
                        st>>>(static_cast<const float*>(w), CIN, cout, CIN,
                              w_bf, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pooled_tail_bf16_kernel<<<blocks, BLOCK, SMEM_BYTES, st>>>(
      x_map, w_map, batch, n, cout, slices, static_cast<const float*>(b),
      static_cast<float*>(cmax), static_cast<int*>(amax),
      static_cast<float*>(cmin), static_cast<int*>(amin),
      static_cast<float*>(rsum), static_cast<float*>(rsq));
  return static_cast<int>(cudaGetLastError());
}
