// Fused eval chain, layers 1-2: two pointwise linear layers with folded
// BatchNorm affines, each followed by a relu.
//
//   h2[p, :] = relu(relu(x[p, :] @ W1 * a1 + c1) @ W2 * a2 + c2)
//
// over the flattened (B n) point axis, Cin <= 64 -> 64 -> 128, in the fp32
// class (P2S_EVAL_CHAIN_PREC=highest there; the bf16 class is
// chain_fused.cu): 3xTF32 products on the tensor cores, as chain_pool.cu and
// pooled_tail.cu run them (each operand split by cvt.rna into tf32 hi and
// lo, hi.hi + hi.lo + lo.hi into fp32 accumulators, ~2^-21 of each product
// short of fp32); the affines and relus are fp32. With chain_pool.cu (layer
// 3 and the pool) it replaces the TPU kernel
// points2surf_tpu/ops/pallas/chain_kernel.py (_chain_pool, :187, reached
// through chain_pool), whose body runs all three layers per point tile; on
// an H100 the pooled layer has its own kernel, and h2 goes through device
// memory between the two.
//
// What bounds it on an H100: bytes. Per point it writes 512 bytes of h2 and
// reads 4 Cin of x for 2 (Cin 64 + 64 128) FLOP. A query forward's five
// chains at batch 4096 write 8.2 GB and read 2.8 GB, 3.27 ms at 3.35 TB/s,
// against 0.35 TFLOP, 2.1 ms at the 165 TFLOP/s of fp32-class work that
// 3xTF32 gets from the 495 TFLOP/s dense TF32 peak. The SIMT kernel this
// replaces needed 5.2 ms for the arithmetic at the 67 TFLOP/s of the fp32
// pipes alone, and its shared-memory reads held it near half that rate
// (11.7 ms, 28% of the bound).
//
// Design. Persistent blocks, one per SM, walk 64-point tiles of the
// flattened axis (tiles block, block + grid, ...; only the last tile is
// ragged); a block's tiles go to its two consumer warpgroups in turn. The
// block first writes W1^T and W2^T, split into tf32 hi and lo, into shared
// memory in the 128-byte swizzled K-major layout wgmma reads (96 KB,
// resident), and the affines beside them. x tiles come through a 4-stage
// ring: by TMA from a 2-D map over (B n, Cin) when Cin is a multiple of 4
// and x is 16-byte aligned (Cin 64 at every call site but the point STN;
// one thread of the producer warpgroup issues them), else (Cin 3: 12-byte
// rows, which TMA cannot describe) by coalesced plain loads, each producer
// warp filling one stage. A consumer reads its A fragments of the tile from
// the stage into registers, splits them there and frees the stage. Layer 1
// is wgmma m64n64k8 with A from registers, Cin padded with zeros to one k8
// step (Cin <= 8; a second template, rather than a SIMT layer 1, so that
// every Cin shares the one tensor-core path) or eight. Layer 2 is m64n128k8
// with A from registers too: the prologue permutes W2^T's K rows so that a
// thread's layer-1 accumulators, affined, relu'd and split, are layer 2's
// tf32 A fragments as they stand (accumulator columns 2q and 2q + 1 of each
// group of 8 are fragment slots q and q + 4), and h1 never touches shared
// memory. The epilogue writes relu(acc * a2 + c2) into the warpgroup's
// staging tile (the 128-byte swizzled boxes of the store's map; 2-way bank
// conflicts on the 8-byte stores), and one thread stores it by TMA to a 2-D
// map over (B n, 128), which clips the ragged last tile; the store drains
// while the warpgroup computes its next tile. Every value is computed in a
// fixed order, so reruns are bit-identical.
//
// Shared memory (bytes): W1^T hi and lo 32,768, W2^T hi and lo 65,536, the
// x ring 65,536 (4 stages of 64 x 64 fp32), two h2 staging tiles 65,536,
// packed affines 1,536, 8 mbarriers 64; 232,000 with the 1,024-byte
// alignment of the swizzled tiles, of the 232,448 a block may have. The
// launch plan (grid) comes from the wrapper (ops/kernels/chain_pool.py
// head_launch_plan), which reckons the same size; a launch whose size
// differs is refused.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hopper_mma.cuh"

namespace {

constexpr int C1 = 64;          // conv1 width (fixed by the architecture)
constexpr int C2 = 128;         // conv2 width (fixed by the architecture)
constexpr int CIN_MAX = 64;
constexpr int TP = 64;          // points per tile: one warpgroup's rows
constexpr int RING = 4;         // x stages: one producer warp each
constexpr int WGS = 2;          // consumer warpgroups
constexpr int BLOCK = 128 * (WGS + 1);  // and a producer warpgroup
constexpr int ROW = 128;        // one swizzled row: 32 fp32
constexpr int BOX = TP * ROW;   // 64 rows of 32 columns

// shared-memory plan, in bytes from the 1,024-byte aligned base
constexpr int W1_BYTES = C1 * CIN_MAX * 4;  // W1^T hi or lo: 2 k chunks
constexpr int W2_BYTES = C2 * C1 * 4;       // W2^T hi or lo: 2 k chunks
constexpr int W1_CHUNK = C1 * ROW;
constexpr int W2_CHUNK = C2 * ROW;
constexpr int STAGE_BYTES = TP * CIN_MAX * 4;  // an x tile: 2 boxes
constexpr int STG_BYTES = TP * C2 * 4;         // an h2 tile: 4 boxes
constexpr int OFF_W1 = 0;                      // hi, then lo
constexpr int OFF_W2 = OFF_W1 + 2 * W1_BYTES;  // hi, then lo
constexpr int OFF_X = OFF_W2 + 2 * W2_BYTES;
constexpr int OFF_STG = OFF_X + RING * STAGE_BYTES;
// (a, a', c, c') per column pair: layer 1, then layer 2
constexpr int AC2 = C1 / 2;
constexpr int AC_PAIRS = AC2 + C2 / 2;
constexpr int OFF_AC = OFF_STG + WGS * STG_BYTES;
constexpr int OFF_BARS = OFF_AC + AC_PAIRS * 16;
// + 1024: the swizzled tiles need 1024-byte alignment, the base has 16
constexpr int SMEM_BYTES = OFF_BARS + 2 * RING * 8 + 1024;
static_assert(SMEM_BYTES == 232000, "the plan in chain_pool.py differs");
static_assert(SMEM_BYTES <= 232448, "shared memory over the limit");
static_assert(RING * 32 == 128, "one producer warp per stage");

// byte offset of fp32 element (r, c), c < 32, in a box of 128-byte rows
// with the 128-byte swizzle: 16-byte unit u of row r sits at unit u ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

// v split into tf32 hi (rounded to the nearest) and lo = v - hi, as the
// bits a tf32 wgmma operand register takes (lo's low 13 bits are ignored)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(v - h);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void fence_acc32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define P2S_ACC32(m)                                                        \
  m(d[0]), m(d[1]), m(d[2]), m(d[3]), m(d[4]), m(d[5]), m(d[6]), m(d[7]),  \
      m(d[8]), m(d[9]), m(d[10]), m(d[11]), m(d[12]), m(d[13]), m(d[14]),  \
      m(d[15]), m(d[16]), m(d[17]), m(d[18]), m(d[19]), m(d[20]),          \
      m(d[21]), m(d[22]), m(d[23]), m(d[24]), m(d[25]), m(d[26]),          \
      m(d[27]), m(d[28]), m(d[29]), m(d[30]), m(d[31])
#define P2S_ACC64(m)                                                        \
  P2S_ACC32(m), m(d[32]), m(d[33]), m(d[34]), m(d[35]), m(d[36]),          \
      m(d[37]), m(d[38]), m(d[39]), m(d[40]), m(d[41]), m(d[42]),          \
      m(d[43]), m(d[44]), m(d[45]), m(d[46]), m(d[47]), m(d[48]),          \
      m(d[49]), m(d[50]), m(d[51]), m(d[52]), m(d[53]), m(d[54]),          \
      m(d[55]), m(d[56]), m(d[57]), m(d[58]), m(d[59]), m(d[60]),          \
      m(d[61]), m(d[62]), m(d[63])
#define P2S_RW(x) "+f"(x)
#define P2S_W(x) "=f"(x)
#define P2S_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define P2S_REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, fp32) = or += A (64 x 8, tf32: the register fragment
// a0..a3, rows lane / 4 (+ 8 for a1, a3) of the warp's 16, k slots
// lane % 4 (+ 4 for a2, a3)) B (8 x 64, tf32, shared memory, K-major).
// The first product of a sum overwrites d (kFirst: d is only written, so
// the compiler keeps no accumulator alive from one tile to the next).
template <bool kFirst>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint64_t desc_b) {
  if (kFirst) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                 P2S_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : P2S_ACC32(P2S_W)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(0));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
                 P2S_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : P2S_ACC32(P2S_RW)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
}

// as mma_n64, 128 columns: d (64 x 128) = or += A (64 x 8) B (8 x 128)
template <bool kFirst>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  if (kFirst) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
                 P2S_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : P2S_ACC64(P2S_W)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(0));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
                 P2S_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : P2S_ACC64(P2S_RW)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
  }
}

#undef P2S_REGS64
#undef P2S_REGS32
#undef P2S_W
#undef P2S_RW
#undef P2S_ACC64
#undef P2S_ACC32

// the three products of k step s (fragments 4 s .. 4 s + 3 of hi and lo)
// against the hi and lo B tiles, hi.hi first
template <bool kFirst, int N, int A>
__device__ __forceinline__ void mma3(float (&d)[N / 2], uint32_t (&hi)[A],
                                     uint32_t (&lo)[A], int s,
                                     uint64_t b_hi, uint64_t b_lo) {
  if constexpr (N == 64) {
    mma_n64<kFirst>(d, hi[4 * s], hi[4 * s + 1], hi[4 * s + 2],
                    hi[4 * s + 3], b_hi);
    mma_n64<false>(d, hi[4 * s], hi[4 * s + 1], hi[4 * s + 2],
                   hi[4 * s + 3], b_lo);
    mma_n64<false>(d, lo[4 * s], lo[4 * s + 1], lo[4 * s + 2],
                   lo[4 * s + 3], b_hi);
  } else {
    mma_n128<kFirst>(d, hi[4 * s], hi[4 * s + 1], hi[4 * s + 2],
                     hi[4 * s + 3], b_hi);
    mma_n128<false>(d, hi[4 * s], hi[4 * s + 1], hi[4 * s + 2],
                    hi[4 * s + 3], b_lo);
    mma_n128<false>(d, lo[4 * s], lo[4 * s + 1], lo[4 * s + 2],
                    lo[4 * s + 3], b_hi);
  }
}

// shared-space loads and stores on 32-bit addresses (generic ones cost
// 64-bit address arithmetic); volatile, so none moves across a barrier wait
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void sts(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void sts2(uint32_t a, float v0, float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(v0),
               "f"(v1)
               : "memory");
}

// the box at shared address src to the box of `map` at (c0, c1), rows past
// the map's edge clipped; one bulk group per thread
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// K1: layer 1's k8 steps (1 for Cin <= 8, else 8). x_boxes: the TMA boxes
// of 32 columns per x tile (1 or 2), or 0 for the plain loads (x_map
// unused).
template <int K1>
__global__ void __launch_bounds__(BLOCK, 1)
chain_head_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap h2_map,
                  const float* __restrict__ x, int points, int cin,
                  int x_boxes, const float* __restrict__ w1,
                  const float* __restrict__ a1, const float* __restrict__ c1,
                  const float* __restrict__ w2, const float* __restrict__ a2,
                  const float* __restrict__ c2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem + OFF_X;
  float4* ac = reinterpret_cast<float4*>(smem + OFF_AC);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BARS);
  uint64_t* empty = full + RING;
  const int tiles = (points + TP - 1) / TP;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], x_boxes > 0 ? 1 : 32);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // W1^T (C1 rows of CIN_MAX k, zero for k >= cin) and W2^T (C2 rows of C1
  // k), split into tf32 hi and lo. W2^T's k 8 s + 2 q sits at slot 8 s + q
  // and k 8 s + 2 q + 1 at slot 8 s + q + 4: the slots of a layer-1
  // accumulator's columns in layer 2's A fragments.
  for (int i = tid; i < CIN_MAX * C1; i += BLOCK) {
    const int k = i / C1;
    const int col = i % C1;
    const float v = k < cin ? w1[i] : 0.f;
    const int off = OFF_W1 + (k / 32) * W1_CHUNK + swz(col, k % 32);
    const float h = tf32_rna(v);
    *reinterpret_cast<float*>(smem + off) = h;
    *reinterpret_cast<float*>(smem + off + W1_BYTES) = v - h;
  }
  for (int i = tid; i < C1 * C2; i += BLOCK) {
    const int k = i / C2;
    const int col = i % C2;
    const float v = w2[i];
    const int slot = (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1);
    const int off = OFF_W2 + (slot / 32) * W2_CHUNK + swz(col, slot % 32);
    const float h = tf32_rna(v);
    *reinterpret_cast<float*>(smem + off) = h;
    *reinterpret_cast<float*>(smem + off + W2_BYTES) = v - h;
  }
  for (int m = tid; m < AC_PAIRS; m += BLOCK) {
    const bool l1 = m < AC2;
    const float* a = l1 ? a1 : a2;
    const float* c = l1 ? c1 : c2;
    const int col = 2 * (l1 ? m : m - AC2);
    ac[m] = make_float4(a[col], a[col + 1], c[col], c[col + 1]);
  }
  // the ring's columns past cin stay zero: the padding of Cin to k8 steps
  for (int i = tid; i < RING * STAGE_BYTES / 16; i += BLOCK) {
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(0, 0, 0, 0);
  }
  // generic-proxy writes -> visible to wgmma and TMA (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (tid >= WGS * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pt = tid - WGS * 128;
    if (x_boxes > 0) {
      // one thread issues every x tile's boxes; the block's j-th tile goes
      // to stage j % RING
      if (pt == 0) {
        int j = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
          const int st = j % RING;
          mbar_wait(&empty[st], ((j / RING) & 1) ^ 1);
          mbar_expect_tx(&full[st], x_boxes * BOX);
          for (int b = 0; b < x_boxes; ++b) {
            tma_load_2d(xs + st * STAGE_BYTES + b * BOX, &x_map, &full[st],
                        32 * b, tile * TP);
          }
        }
      }
    } else {
      // producer warp w fills stage w: the block's tiles j = w, w + RING, ..
      const int w = pt / 32;
      const int lane = pt % 32;
      const uint32_t stage = smem_u32(xs) + w * STAGE_BYTES;
      int j = w;
      for (int tile = blockIdx.x + w * gridDim.x; tile < tiles;
           tile += RING * gridDim.x, j += RING) {
        mbar_wait(&empty[w], ((j / RING) & 1) ^ 1);
        const int rows = min(TP, points - tile * TP);
        const int total = rows * cin;
        const float* src = x + (long long)tile * TP * cin;
        for (int i0 = lane; i0 < total; i0 += 8 * 32) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = i0 + 32 * u;
            v[u] = i < total ? __ldg(src + i) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int i = i0 + 32 * u;
            if (i < total) {
              const int r = i / cin;
              const int c = i - r * cin;
              sts(stage + (c / 32) * BOX + swz(r, c % 32), v[u]);
            }
          }
        }
        mbar_arrive(&full[w]);
      }
    }
    return;
  }

  // consumer warpgroup g: the block's tiles j = g, g + 2, ...
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int g = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int gq = lane >> 2;  // rows r0 = 16 warp + gq and r0 + 8
  const int tq = lane & 3;
  const int r0 = 16 * (t / 32) + gq;
  const uint32_t x_u32 = smem_u32(xs);
  const uint32_t ac_u32 = smem_u32(ac);
  const uint32_t stg_u32 = smem_u32(smem + OFF_STG + g * STG_BYTES);
  const uint64_t d_w1 = sw128_desc(smem + OFF_W1);
  const uint64_t d_w1_lo = sw128_desc(smem + OFF_W1 + W1_BYTES);
  const uint64_t d_w2 = sw128_desc(smem + OFF_W2);
  const uint64_t d_w2_lo = sw128_desc(smem + OFF_W2 + W2_BYTES);
  float acc1[32];
  float acc2[64];
  uint32_t xh[4 * K1];
  uint32_t xl[4 * K1];
  uint32_t hh[4 * C1 / 8];
  uint32_t hl[4 * C1 / 8];

  int j = g;
  for (int tile = blockIdx.x + g * gridDim.x; tile < tiles;
       tile += WGS * gridDim.x, j += WGS) {
    const int st = j % RING;
    mbar_wait(&full[st], (j / RING) & 1);
    // layer 1's A fragments: x at rows r0, r0 + 8 and columns 8 s + tq,
    // 8 s + tq + 4 of k step s
    const uint32_t xt = x_u32 + st * STAGE_BYTES + r0 * ROW + 4 * tq;
#pragma unroll
    for (int s = 0; s < K1; ++s) {
      const uint32_t box = xt + (s / 4) * BOX;
      const uint32_t u0 = ((2 * (s % 4)) ^ gq) << 4;
      const uint32_t u1 = ((2 * (s % 4) + 1) ^ gq) << 4;
      split(lds(box + u0), xh[4 * s], xl[4 * s]);
      split(lds(box + 8 * ROW + u0), xh[4 * s + 1], xl[4 * s + 1]);
      split(lds(box + u1), xh[4 * s + 2], xl[4 * s + 2]);
      split(lds(box + 8 * ROW + u1), xh[4 * s + 3], xl[4 * s + 3]);
    }
    mbar_arrive(&empty[st]);

    // layer 1: acc1 = x . W1^T
    fence_regs(xh);
    fence_regs(xl);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < K1; ++s) {
      const uint64_t off = (s / 4) * (W1_CHUNK / 16) + 2 * (s % 4);
      if (s == 0) {
        mma3<true, C1>(acc1, xh, xl, s, d_w1 + off, d_w1_lo + off);
      } else {
        mma3<false, C1>(acc1, xh, xl, s, d_w1 + off, d_w1_lo + off);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc32(acc1);
    fence_regs(xh);
    fence_regs(xl);

    // layer 2's A fragments: h1 = relu(acc1 a1 + c1), split; accumulator
    // element 4 s + 2 h + e (row r0 + 8 h, column 8 s + 2 tq + e) is
    // fragment register 4 s + h + 2 e of k step s
#pragma unroll
    for (int s = 0; s < C1 / 8; ++s) {
      const float4 f = lds4(ac_u32 + 16 * (4 * s + tq));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = fmaxf(
              fmaf(acc1[4 * s + 2 * h + e], e ? f.y : f.x, e ? f.w : f.z),
              0.f);
          split(v, hh[4 * s + h + 2 * e], hl[4 * s + h + 2 * e]);
        }
      }
    }
    // layer 2: acc2 = h1 . W2^T (K rows permuted to the fragments' slots)
    fence_regs(hh);
    fence_regs(hl);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < C1 / 8; ++s) {
      const uint64_t off = (s / 4) * (W2_CHUNK / 16) + 2 * (s % 4);
      if (s == 0) {
        mma3<true, C2>(acc2, hh, hl, s, d_w2 + off, d_w2_lo + off);
      } else {
        mma3<false, C2>(acc2, hh, hl, s, d_w2 + off, d_w2_lo + off);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc2);
    fence_regs(hh);
    fence_regs(hl);

    // epilogue: the staging tile is free once the previous store has read
    // it (the thread that issued it waits)
    if (t == 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
#pragma unroll
    for (int s = 0; s < C2 / 8; ++s) {
      const float4 f = lds4(ac_u32 + 16 * (AC2 + 4 * s + tq));
      const uint32_t dst = stg_u32 + (s / 4) * BOX + r0 * ROW +
                           (((2 * (s % 4) + (tq >> 1)) ^ gq) << 4) +
                           8 * (tq & 1);
      sts2(dst, fmaxf(fmaf(acc2[4 * s], f.x, f.z), 0.f),
           fmaxf(fmaf(acc2[4 * s + 1], f.y, f.w), 0.f));
      sts2(dst + 8 * ROW, fmaxf(fmaf(acc2[4 * s + 2], f.x, f.z), 0.f),
           fmaxf(fmaf(acc2[4 * s + 3], f.y, f.w), 0.f));
    }
    // generic-proxy writes -> visible to the TMA store (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < C2 / 32; ++b) {
        tma_store_2d(&h2_map, stg_u32 + b * BOX, 32 * b, tile * TP);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (t == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

template <int K1>
cudaError_t allow_smem_one() {
  return cudaFuncSetAttribute(chain_head_kernel<K1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

}  // namespace

// On device `dev` and its stream `stream`: h2 (points, 128) = layers 1-2 of
// x (points, cin), 1 <= cin <= 64, points < 2^31 - 64; w1 (cin, 64), w2
// (64, 128), a_i / c_i per output channel, all fp32 and contiguous; h2
// fp32, its base 16-byte aligned. The launch plan: `blocks` persistent
// blocks (at most one per 64-point tile), smem_bytes as this file computes
// it. Returns a cudaError_t; 0 means launched.
extern "C" int p2s_chain_head(int dev, const void* x, long long points,
                              int cin, const void* w1, const void* a1,
                              const void* c1, int c1n, const void* w2,
                              const void* a2, const void* c2, int c2n,
                              void* h2, int blocks, int smem_bytes,
                              void* stream) {
  if (c1n != C1 || c2n != C2 || cin < 1 || cin > CIN_MAX || points < 1 ||
      points > INT_MAX - TP || smem_bytes != SMEM_BYTES || blocks < 1 ||
      blocks > (points + TP - 1) / TP ||
      reinterpret_cast<uintptr_t>(h2) % 16 != 0) {
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
    err = allow_smem_one<1>();
    if (err == cudaSuccess) err = allow_smem_one<8>();
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  // TMA takes x when its rows are whole 16-byte units and its base is
  // aligned; else the producer loads it
  const bool tma = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int x_boxes = tma ? (cin + 31) / 32 : 0;
  CUtensorMap maps[2] = {};
  const cuuint32_t box[2] = {32, TP};
  const cuuint64_t x_dims[2] = {(cuuint64_t)cin, (cuuint64_t)points};
  const cuuint64_t x_strides[1] = {(cuuint64_t)cin * 4};
  const cuuint64_t h_dims[2] = {(cuuint64_t)C2, (cuuint64_t)points};
  const cuuint64_t h_strides[1] = {(cuuint64_t)C2 * 4};
  if ((tma && !encode(&maps[0], x, 2, x_dims, x_strides, box)) ||
      !encode(&maps[1], h2, 2, h_dims, h_strides, box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* w1s = static_cast<const float*>(w1);
  const float* a1s = static_cast<const float*>(a1);
  const float* c1s = static_cast<const float*>(c1);
  const float* w2s = static_cast<const float*>(w2);
  const float* a2s = static_cast<const float*>(a2);
  const float* c2s = static_cast<const float*>(c2);
  if (cin <= 8) {
    chain_head_kernel<1><<<blocks, BLOCK, SMEM_BYTES, st>>>(
        maps[0], maps[1], xs, (int)points, cin, x_boxes, w1s, a1s, c1s, w2s,
        a2s, c2s);
  } else {
    chain_head_kernel<8><<<blocks, BLOCK, SMEM_BYTES, st>>>(
        maps[0], maps[1], xs, (int)points, cin, x_boxes, w1s, a1s, c1s, w2s,
        a2s, c2s);
  }
  return static_cast<int>(cudaGetLastError());
}
