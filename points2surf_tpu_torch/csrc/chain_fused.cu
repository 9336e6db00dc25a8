// Fused eval chain in the bf16-operand class: layers 1-3, their folded
// BatchNorm affines and relus, and the pool over the point axis, in one
// launch.
//
//   out[b, j] = pool_{p < n} act(r(h2[b, p, :]) @ r(W3)[:, j] a3[j] + c3[j])
//   h2 = relu(r(h1) @ r(W2) a2 + c2),  h1 = relu(r(x) @ r(W1) a1 + c1)
//
// r rounds to the nearest bf16 (ties to even); products accumulate in fp32;
// the affines, relus and pools are fp32; act = relu with relu_last. The
// numerics of chain_pool_reference(..., bf16_operands=True) and of the TPU
// kernel's bf16 class (P2S_EVAL_CHAIN_PREC=default). Replaces the TPU kernel
// points2surf_tpu/ops/pallas/chain_kernel.py (_chain_pool, :187), which runs
// all three layers per point tile; the fp32 class stays with chain_head.cu
// and chain_pool.cu.
//
// What bounds it on an H100: operations. A query forward's five chains
// ((Cin, n) = (3, 1300), (64, 1000) x2, (64, 300) x2 at batch 4096) do
// 2 n (Cin 64 + 64 128 + 128 1024) FLOP per row: 4.54 TFLOP, 4.59 ms at the
// 989 TFLOP/s dense bf16 peak, against 0.83 ms to read x (2.79 GB, fp32)
// once at 3.35 TB/s. Layer 3 is 4.19 TFLOP of that.
//
// Design. All three products run on bf16 wgmma, and h1 and h2 never leave
// registers: the fp32 accumulator of an m64n64 product, relu'd, affined and
// packed two columns to a 32-bit register, is exactly the register A
// fragment of the next product's k16 steps (accumulator elements 2i and
// 2i + 1 make register i), so layers 2 and 3 take A from registers and only
// x and the weights come from shared memory. Cin <= 16 is zero-padded to one
// k16 step (Cin 3: the zero W1^T rows keep it exact), Cin <= 64 to four.
// W3^T (256 KB in bf16) does not fit a block, so a block keeps a slice of
// 512 columns resident (plan (a): layers 1-2 are recomputed once per slice,
// +8% of the FLOP at Cout 1024) and walks rows with no W3 traffic after its
// prologue. Persistent blocks, one per SM: block i takes slice i % slices;
// each of its two consumer warpgroups is a worker that owns whole items
// (batch row, point range) from a static schedule, walking 64-point tiles:
// layer 1 (m64n64k16 from shared memory), layer 2 (two m64n64k16 halves, A
// in registers), then layer 3 in 64-column halves of the slice's 128-column
// tiles (m64n64k16, A = h2 in registers), two 32-register accumulators in
// turn, so that a half's epilogue runs while the next half's product is in
// flight. The epilogue: fmaf(acc, a3, c3), the optional relu, rows >= n
// masked to -inf (max) or 0 (sum), the thread's two rows combined, then
// halved twice across lanes (lanes ^ 16, ^ 8: each keeps 4 of its 16
// columns) into a running pool of 8 x 4 registers per thread. The two
// warpgroups work on different rows, so one's epilogue also overlaps the
// other's products. At an item's end a third halving and the four warps'
// partials (through shared memory, in warp order) give the slice's columns.
// The producer warpgroup gives its registers to the consumers (setmaxnreg
// 40 / 232); one thread loads the weights by TMA, and 64 threads per
// consumer warpgroup round each fp32 x tile to bf16 into the 128-byte
// swizzled layout wgmma reads, through a 3-stage ring per warpgroup. Max may
// split a row's points over workers when the batch is at most half the
// workers (an atomic max on the float's bits into an output the prologue
// fills with -inf: order-free, so deterministic); sum never splits, and
// every sum is taken in a fixed order, so reruns are bit-identical. The
// launch plan (grid, splits) comes from the wrapper
// (ops/kernels/chain_pool.py fused_launch_plan). Column tiles past cout
// (cout not a multiple of 512) load as TMA's zeros, are computed and not
// written.
//
// Shared memory (bytes): W3^T slice 131,072 (4 column tiles x 2 K chunks of
// 128 x 64 bf16), W2^T 16,384, W1^T 8,192, x rings 49,152 (2 warpgroups x 3
// stages x 64 x 64 bf16), pool partials 16,384 (2 x 4 warps x 512 fp32),
// packed affines 5,632, 13 mbarriers 104; 227,944 with the 1,024-byte
// alignment of the swizzled tiles, of the 232,448 a block may have.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int C1 = 64;             // conv1 width
constexpr int C2 = 128;            // conv2 width
constexpr int CIN_MAX = 64;
constexpr int TP = 64;             // points per tile: one warpgroup's rows
constexpr int CT = 4;              // 128-column tiles per slice
constexpr int SLICE = CT * 128;    // columns of W3 a block keeps
constexpr int XSTAGES = 3;         // x ring stages per consumer warpgroup
constexpr int WGS = 2;             // consumer warpgroups
constexpr int BLOCK = 128 * (WGS + 1);  // and a producer warpgroup
constexpr int PAIR = 64;           // producer threads per consumer warpgroup

constexpr int ROW_BYTES = 128;             // 64 bf16: one swizzled row
constexpr int TILE_BYTES = TP * ROW_BYTES;  // an x tile: 64 x 64 bf16
constexpr int W3_CHUNK = 128 * ROW_BYTES;   // 128 columns x 64 k
constexpr int OFF_W3 = 0;
constexpr int OFF_W2 = OFF_W3 + CT * 2 * W3_CHUNK;
constexpr int OFF_W1 = OFF_W2 + C2 * ROW_BYTES;
constexpr int OFF_X = OFF_W1 + C1 * ROW_BYTES;
constexpr int OFF_RED = OFF_X + WGS * XSTAGES * TILE_BYTES;
constexpr int RED_FLOATS = 4 * SLICE;  // a warpgroup's four warps
constexpr int OFF_AC = OFF_RED + WGS * RED_FLOATS * 4;
// (a, a', c, c') per column pair: layer 1, layer 2, the slice of layer 3
constexpr int AC1 = 0;
constexpr int AC2 = AC1 + C1 / 2;
constexpr int AC3 = AC2 + C2 / 2;
constexpr int AC_PAIRS = AC3 + SLICE / 2;
constexpr int OFF_BARS = OFF_AC + AC_PAIRS * 16;
constexpr int N_BARS = 2 * WGS * XSTAGES + 1;
// + 1024: the swizzled tiles need 1024-byte alignment, the base has 16
constexpr int SMEM_BYTES = OFF_BARS + N_BARS * 8 + 1024;
static_assert(SMEM_BYTES == 227944, "the plan in chain_pool.py differs");
static_assert(SMEM_BYTES <= 232448, "shared memory over the limit");
static_assert(OFF_X % 1024 == 0 && OFF_W1 % 1024 == 0, "tile alignment");

// byte offset of element (r, c) in a tile of 128-byte rows with the 128-byte
// swizzle: 16-byte unit u of row r sits at unit u ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW_BYTES + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void fence_acc32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define P2S_ACC32                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64, fp32) (+)= A (64 x 16, bf16) B (16 x 64, bf16), both from
// shared memory, K-major; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : P2S_ACC32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) (+)= A (64 x 16, bf16, the register fragment a0..a3)
// B (16 x 64, bf16, shared memory, K-major); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, "
      "0;\n"
      "}\n"
      : P2S_ACC32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

#undef P2S_ACC32

__device__ __forceinline__ void wgmma_begin() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_end() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The next product's A fragments from a 64-column accumulator: h[OFF + i]
// = bf16x2(relu(acc * a + c)) of accumulator elements 2i and 2i + 1 (row
// lane / 4 for even i, + 8 for odd i; columns 8 (i / 2) + 2 (lane % 4) and
// + 1 of the 64), which is register i % 4 of the fragment of k16 step
// (OFF + i) / 4. ac: (a, a', c, c') per column pair of these 64 columns.
template <int OFF>
__device__ __forceinline__ void hidden_frags(const float (&acc)[32],
                                             const float4* ac, int q,
                                             uint32_t (&h)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 s = ac[4 * j + q];
    h[OFF + 2 * j] = pack_bf16x2(fmaxf(fmaf(acc[4 * j], s.x, s.z), 0.f),
                                 fmaxf(fmaf(acc[4 * j + 1], s.y, s.w), 0.f));
    h[OFF + 2 * j + 1] =
        pack_bf16x2(fmaxf(fmaf(acc[4 * j + 2], s.x, s.z), 0.f),
                    fmaxf(fmaf(acc[4 * j + 3], s.y, s.w), 0.f));
  }
}

template <bool kMax>
__device__ __forceinline__ float pool_op(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// Layer 3's epilogue for one 64-column half tile: value v = 2 j + e of this
// thread is column 8 j + 2 (lane % 4) + e, its two rows affined, relu'd,
// masked and combined; then two halvings across lanes (^ 16, ^ 8) leave
// values 8 bit4 + 4 bit3 + i (i < 4, bitk = lane bit k), combined into run.
template <bool kMax, bool kRelu, bool kMasked>
__device__ __forceinline__ void pool_half(const float (&acc)[32],
                                          const float4* ac, int q, int lane,
                                          bool in0, bool in1,
                                          float (&run)[4]) {
  const float empty = kMax ? -CUDART_INF_F : 0.f;
  float p[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 s = ac[4 * j + q];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = e ? s.y : s.x;
      const float c = e ? s.w : s.z;
      float v0 = fmaf(acc[4 * j + e], a, c);
      float v1 = fmaf(acc[4 * j + 2 + e], a, c);
      if (kRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (kMasked) {
        v0 = in0 ? v0 : empty;
        v1 = in1 ? v1 : empty;
      }
      p[2 * j + e] = pool_op<kMax>(v0, v1);
    }
  }
  const bool up16 = lane & 16;
  float h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = up16 ? p[i] : p[8 + i];
    const float keep = up16 ? p[8 + i] : p[i];
    h[i] = pool_op<kMax>(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
  const bool up8 = lane & 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up8 ? h[i] : h[4 + i];
    const float keep = up8 ? h[4 + i] : h[i];
    run[i] = pool_op<kMax>(
        run[i], pool_op<kMax>(keep, __shfl_xor_sync(0xffffffffu, send, 8)));
  }
}

// Issue layer 3's product for one 64-column half tile into d: h2 (registers,
// eight k16 steps) . the half's W3^T rows (two 64-k chunks from w3), as
// one committed group, not waited for.
__device__ __forceinline__ void issue_half(float (&d)[32], uint32_t (&h)[32],
                                           const uint8_t* w3) {
  fence_regs(h);
  fence_acc32(d);
  wgmma_begin();
#pragma unroll
  for (int kk = 0; kk < C2 / 16; ++kk) {
    const uint64_t desc = sw128_desc(w3 + (kk / 4) * W3_CHUNK) + 2 * (kk % 4);
    wgmma_n64_rs(d, h[4 * kk], h[4 * kk + 1], h[4 * kk + 2], h[4 * kk + 3],
                 desc, kk);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The producer's share of one x tile: rows [0, rows) of src (rows x cin
// fp32, contiguous) rounded to bf16 into the swizzled tile; vec4: cin % 4
// == 0 and src 16-byte aligned.
__device__ __forceinline__ void fill_tile(uint8_t* tile,
                                          const float* __restrict__ src,
                                          int rows, int cin, bool vec4,
                                          int pl) {
  if (vec4) {
    const int q4 = cin / 4;
    const int total = rows * q4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i0 = pl; i0 < total; i0 += 4 * PAIR) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * PAIR;
        v[u] = i < total ? __ldg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * PAIR;
        if (i < total) {
          const int r = i / q4;
          const int c = 4 * (i - r * q4);
          *reinterpret_cast<uint2*>(tile + swz(r, c)) =
              make_uint2(pack_bf16x2(v[u].x, v[u].y),
                         pack_bf16x2(v[u].z, v[u].w));
        }
      }
    }
  } else {
    const int total = rows * cin;
    for (int i = pl; i < total; i += PAIR) {
      const int r = i / cin;
      const int c = i - r * cin;
      *reinterpret_cast<__nv_bfloat16*>(tile + swz(r, c)) =
          __float2bfloat16_rn(__ldg(src + i));
    }
  }
}

template <bool kMax, bool kRelu>
__global__ void __launch_bounds__(BLOCK, 1)
chain_fused_kernel(const __grid_constant__ CUtensorMap w1_map,
                   const __grid_constant__ CUtensorMap w2_map,
                   const __grid_constant__ CUtensorMap w3_map,
                   const float* __restrict__ x, int n, int cin, bool vec4,
                   const float* __restrict__ a1, const float* __restrict__ c1,
                   const float* __restrict__ a2, const float* __restrict__ c2,
                   const float* __restrict__ a3, const float* __restrict__ c3,
                   int cout, int slices, long long items, int splits,
                   int per_split, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* w3s = smem + OFF_W3;
  uint8_t* w2s = smem + OFF_W2;
  uint8_t* w1s = smem + OFF_W1;
  uint8_t* xs = smem + OFF_X;
  float4* ac = reinterpret_cast<float4*>(smem + OFF_AC);
  uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + OFF_BARS);
  uint64_t* x_empty = x_full + WGS * XSTAGES;
  uint64_t* w_full = x_empty + WGS * XSTAGES;

  const int col0 = (blockIdx.x % slices) * SLICE;
  const int n_ct = min(CT, (cout - col0) / 128);
  const int tiles = (n + TP - 1) / TP;
  // worker w of the slice: warpgroup w / bps of block slot w % bps, so the
  // first warpgroups of all blocks take items before the second ones do
  const int bps = (int)(gridDim.x / slices);
  const int workers = bps * WGS;
  const int bslot = (int)(blockIdx.x / slices);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < WGS * XSTAGES; ++s) {
      mbar_init(&x_full[s], PAIR);
      mbar_init(&x_empty[s], 128);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int m = tid; m < AC_PAIRS; m += BLOCK) {
    const float* a;
    const float* c;
    int col;
    bool in = true;
    if (m < AC2) {
      a = a1, c = c1, col = 2 * (m - AC1);
    } else if (m < AC3) {
      a = a2, c = c2, col = 2 * (m - AC2);
    } else {
      a = a3, c = c3, col = col0 + 2 * (m - AC3);
      in = col < cout;
    }
    ac[m] = in ? make_float4(a[col], a[col + 1], c[col], c[col + 1])
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  if (tid >= WGS * 128) {
    // producer warpgroup: the weights by TMA, the x tiles by 64 threads
    // per consumer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int pt = tid - WGS * 128;
    if (pt == 0) {
      // column tiles past cout arrive as zeros (and count in full)
      mbar_expect_tx(w_full, (C1 + C2) * ROW_BYTES + CT * 2 * W3_CHUNK);
      tma_load_2d(w1s, &w1_map, w_full, 0, 0);
      tma_load_2d(w2s, &w2_map, w_full, 0, 0);
      for (int t = 0; t < CT; ++t) {
        for (int k = 0; k < 2; ++k) {
          tma_load_2d(w3s + (2 * t + k) * W3_CHUNK, &w3_map, w_full, 64 * k,
                      col0 + 128 * t);
        }
      }
    }
    const int g = pt / PAIR;
    const int pl = pt % PAIR;
    uint8_t* ring = xs + g * XSTAGES * TILE_BYTES;
    // zeros in the columns past cin of every stage stay zero: the padding
    // of Cin to the k16 steps
    for (int i = pl; i < XSTAGES * TILE_BYTES / 16; i += PAIR) {
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("bar.sync %0, %1;" ::"r"(3 + g), "n"(PAIR) : "memory");
    int it = 0;
    for (long long i = g * bps + bslot; i < items; i += workers) {
      const long long b = i / splits;
      const int t0 = (int)(i % splits) * per_split;
      const int t1 = min(tiles, t0 + per_split);
      for (int t = t0; t < t1; ++t, ++it) {
        const int st = it % XSTAGES;
        mbar_wait(&x_empty[g * XSTAGES + st], ((it / XSTAGES) & 1) ^ 1);
        const float* src = x + (b * n + (long long)t * TP) * cin;
        fill_tile(ring + st * TILE_BYTES, src, min(TP, n - t * TP), cin,
                  vec4, pl);
        // generic-proxy writes -> visible to wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&x_full[g * XSTAGES + st]);
      }
    }
    return;
  }

  // consumer warpgroup g: a worker of its own
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int g = tid / 128;
  const int t128 = tid % 128;
  const int warp = t128 / 32;
  const int lane = t128 % 32;
  const int q = lane & 3;
  const int k1 = cin <= 16 ? 1 : CIN_MAX / 16;
  const float empty = kMax ? -CUDART_INF_F : 0.f;
  float* red = reinterpret_cast<float*>(smem + OFF_RED) + g * RED_FLOATS;
  // two 64-column accumulators: layer 1; layer 2's two halves; layer 3's
  // half tiles in turn, the next one's product in flight while this one's
  // epilogue runs
  float acc0[32];
  float acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  uint32_t h[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0u;
  const uint64_t d_w1 = sw128_desc(w1s);
  const uint64_t d_w2 = sw128_desc(w2s);
  const uint64_t d_w2_hi = sw128_desc(w2s + 64 * ROW_BYTES);

  mbar_wait(w_full, 0);
  int it = 0;
  for (long long i = g * bps + bslot; i < items; i += workers) {
    const long long b = i / splits;
    const int t0 = (int)(i % splits) * per_split;
    const int t1 = min(tiles, t0 + per_split);
    float run[2 * CT][4];  // per half tile
#pragma unroll
    for (int c = 0; c < 2 * CT; ++c) {
#pragma unroll
      for (int v = 0; v < 4; ++v) run[c][v] = empty;
    }
    for (int t = t0; t < t1; ++t, ++it) {
      const int st = g * XSTAGES + it % XSTAGES;
      mbar_wait(&x_full[st], (it / XSTAGES) & 1);
      // layer 1: x (64 x Cin) . W1^T, Cin in k1 k16 steps
      const uint64_t d_x = sw128_desc(xs + st * TILE_BYTES);
      fence_acc32(acc0);
      wgmma_begin();
      wgmma_n64_ss(acc0, d_x, d_w1, 0);
      if (k1 > 1) {
        wgmma_n64_ss(acc0, d_x + 2, d_w1 + 2, 1);
        wgmma_n64_ss(acc0, d_x + 4, d_w1 + 4, 1);
        wgmma_n64_ss(acc0, d_x + 6, d_w1 + 6, 1);
      }
      wgmma_end();
      fence_acc32(acc0);
      mbar_arrive(&x_empty[st]);
      hidden_frags<0>(acc0, ac + AC1, q, h);
      // layer 2: h1 (registers) . W2^T, columns 0-63 and 64-127
      fence_regs(h);
      fence_acc32(acc0);
      fence_acc32(acc1);
      wgmma_begin();
#pragma unroll
      for (int kk = 0; kk < C1 / 16; ++kk) {
        wgmma_n64_rs(acc0, h[4 * kk], h[4 * kk + 1], h[4 * kk + 2],
                     h[4 * kk + 3], d_w2 + 2 * kk, kk);
        wgmma_n64_rs(acc1, h[4 * kk], h[4 * kk + 1], h[4 * kk + 2],
                     h[4 * kk + 3], d_w2_hi + 2 * kk, kk);
      }
      wgmma_end();
      fence_acc32(acc0);
      fence_acc32(acc1);
      fence_regs(h);
      hidden_frags<0>(acc0, ac + AC2, q, h);
      hidden_frags<16>(acc1, ac + AC2 + 32, q, h);
      // layer 3 and the pool, one 64-column half of a column tile of the
      // slice at a time (tiles past cout multiply TMA's zero rows and are
      // not written)
      const int rows_left = n - (t * TP + 16 * warp + lane / 4);
      const bool masked = (t + 1) * TP > n;
      issue_half(acc0, h, w3s);
#pragma unroll
      for (int u = 0; u < 2 * CT; ++u) {
        if (u + 1 < 2 * CT) {
          issue_half(u % 2 ? acc0 : acc1, h,
                     w3s + (u + 1) / 2 * 2 * W3_CHUNK +
                         (u + 1) % 2 * 64 * ROW_BYTES);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        float (&cur)[32] = u % 2 ? acc1 : acc0;
        fence_acc32(cur);
        const float4* ac3 = ac + AC3 + 32 * u;
        if (masked) {
          pool_half<kMax, kRelu, true>(cur, ac3, q, lane, rows_left > 0,
                                       rows_left > 8, run[u]);
        } else {
          pool_half<kMax, kRelu, false>(cur, ac3, q, lane, true, true,
                                        run[u]);
        }
      }
      fence_regs(h);
    }
    // the third halving (lanes ^ 4), then the four warps in order
    const bool up4 = lane & 4;
    const int base = 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1) +
                     2 * ((lane >> 2) & 1);
#pragma unroll
    for (int u = 0; u < 2 * CT; ++u) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float send = up4 ? run[u][v] : run[u][2 + v];
        const float keep = up4 ? run[u][2 + v] : run[u][v];
        const float r =
            pool_op<kMax>(keep, __shfl_xor_sync(0xffffffffu, send, 4));
        const int val = base + v;
        red[warp * SLICE + 64 * u + 8 * (val >> 1) + 2 * q + (val & 1)] = r;
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
    for (int c = 0; c < n_ct; ++c) {
      const int col = 128 * c + t128;
      float v = red[col];
#pragma unroll
      for (int w = 1; w < 4; ++w) v = pool_op<kMax>(v, red[w * SLICE + col]);
      float* dst = out + b * cout + col0 + col;
      if (kMax && splits > 1) {
        atomic_max_float(dst, v);
      } else {
        *dst = v;
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
  }
}

struct Args {
  const float* x;
  int n, cin;
  bool vec4;
  const float *a1, *c1, *a2, *c2, *a3, *c3;
  int cout, slices;
  long long items;
  int splits, per_split;
  float* out;
};

template <bool kMax, bool kRelu>
cudaError_t launch(const CUtensorMap (&maps)[3], int blocks, cudaStream_t st,
                   const Args& p) {
  chain_fused_kernel<kMax, kRelu><<<blocks, BLOCK, SMEM_BYTES, st>>>(
      maps[0], maps[1], maps[2], p.x, p.n, p.cin, p.vec4, p.a1, p.c1, p.a2,
      p.c2, p.a3, p.c3, p.cout, p.slices, p.items, p.splits, p.per_split,
      p.out);
  return cudaGetLastError();
}

template <bool kMax, bool kRelu>
cudaError_t allow_smem_one() {
  return cudaFuncSetAttribute(chain_fused_kernel<kMax, kRelu>,
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

// a bf16 W^T (rows, 64 k per box) tensor map by (64, box_rows) boxes
bool encode_wt(CUtensorMap* map, const void* base, int kp, int rows,
               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode(map, base, 2, dims, strides, box,
                CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

}  // namespace

// On device `dev` and its stream `stream`: out (batch, cout) =
// pool_{p < n} act(L3(relu(L2(relu(L1(x[b, p, :])))))) in the bf16-operand
// class, max if sym_max else sum, relu if relu_last. x (batch, n, cin) fp32,
// 1 <= cin <= 64; w1 (cin, 64), w2 (64, 128), w3 (128, cout), cout a
// multiple of 128; a_i, c_i per output channel; all fp32 and contiguous.
// The launch plan: blocks (a multiple of the cout / 512 slices, rounded
// up), splits of each row's 64-point tiles (1 for a sum) of per_split tiles
// each, smem_bytes as this file computes it. scratch (16-byte aligned)
// holds the bf16 W1^T (64 x 64), W2^T (128 x 64) and W3^T (cout x 128),
// then batch * cout floats (out). Returns a cudaError_t; 0 means launched.
extern "C" int p2s_chain_fused(int dev, const void* x, int batch, int n,
                               int cin, const void* w1, const void* a1,
                               const void* c1, const void* w2,
                               const void* a2, const void* c2,
                               const void* w3, const void* a3,
                               const void* c3, int cout, int sym_max,
                               int relu_last, int blocks, int splits,
                               int per_split, int smem_bytes, void* scratch,
                               void* stream) {
  const int slices = (cout + SLICE - 1) / SLICE;
  const int tiles = (n + TP - 1) / TP;
  if (batch < 1 || n < 1 || cin < 1 || cin > CIN_MAX || cout < 128 ||
      cout % 128 != 0 || smem_bytes != SMEM_BYTES || blocks < slices ||
      blocks % slices != 0 || splits < 1 || per_split < 1 ||
      (long long)(splits - 1) * per_split >= tiles ||
      (long long)splits * per_split < tiles || (!sym_max && splits != 1) ||
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
    err = allow_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* w1t = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* w2t = w1t + C1 * CIN_MAX;
  __nv_bfloat16* w3t = w2t + C2 * C1;
  float* out = reinterpret_cast<float*>(w3t + (size_t)cout * C2);
  CUtensorMap maps[3];
  if (!encode_wt(&maps[0], w1t, CIN_MAX, C1, C1) ||
      !encode_wt(&maps[1], w2t, C1, C2, C2) ||
      !encode_wt(&maps[2], w3t, C2, cout, 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the prologue: W^T in bf16, zero for k >= cin; out = -inf where split
  // workers combine in it
  const size_t fill = splits > 1 ? (size_t)batch * cout : 0;
  bf16_weights_kernel<<<dim3(CIN_MAX / 32, C1 / 32), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(w1), cin, C1, CIN_MAX, w1t, out, fill);
  bf16_weights_kernel<<<dim3(C1 / 32, C2 / 32), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(w2), C1, C2, C1, w2t, out, 0);
  bf16_weights_kernel<<<dim3(C2 / 32, cout / 32), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(w3), C2, cout, C2, w3t, out, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args p{static_cast<const float*>(x),
               n,
               cin,
               cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
               static_cast<const float*>(a1),
               static_cast<const float*>(c1),
               static_cast<const float*>(a2),
               static_cast<const float*>(c2),
               static_cast<const float*>(a3),
               static_cast<const float*>(c3),
               cout,
               slices,
               (long long)batch * splits,
               splits,
               per_split,
               out};
  if (sym_max) {
    err = relu_last ? launch<true, true>(maps, blocks, st, p)
                    : launch<true, false>(maps, blocks, st, p);
  } else {
    err = relu_last ? launch<false, true>(maps, blocks, st, p)
                    : launch<false, false>(maps, blocks, st, p);
  }
  return static_cast<int>(err);
}
