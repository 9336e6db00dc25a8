// The one-hot terms of the max-pooled train tail's backward
// (models/pointnet._LinearPoolReductions.backward, need_minmax), in fp32:
//
//   grad_x[b, p, :] += sum_{c: amax[b,c] = p} gmax[b,c] W[:, c]
//                    + sum_{c: amin[b,c] = p} gmin[b,c] W[:, c]
//   grad_W[:, c]    += sum_b gmax[b,c] x[b, amax[b,c], :]
//                    + gmin[b,c] x[b, amin[b,c], :]
//
// with x (B, n, 128), W^T (C, 128), the arg indices and their cotangents
// (B, C). grad_x holds the backward's dense terms on entry and is updated
// in place, and so is grad_W (128, C).
//
// Replaces no TPU kernel: the JAX package leaves this backward to XLA,
// which fuses an implicit one-hot (iota == arg) into the two contractions
// (points2surf_tpu/models/pointnet.py, _lpr_bwd). Eager PyTorch cannot fuse
// it; its scatter-add of g W^T and gather of x through a (B, C, 128)-
// expanded index wrote and read several (B, C, 128) fp32 temporaries per
// arg (525 MB each at B 1001, C 1024), and the scatter's float atomics
// contend, since the 1,024 channels' args fall on a few extreme points of
// each row. Here no (B, C, 128) tensor is formed and no atomic is used.
//
// What bounds it on an H100: bytes. A tail is ~4 B C 128 FLOP (0.52 GFLOP
// at B 1001, C 1024: 8 us at 67 TFLOP/s of fp32 FMA) against the arg
// indices and cotangents (16 MB at that shape) and 1,536 bytes for each
// touched (row, arg) pair, read of x and read and written of grad_x: up
// to 2C pairs a row (random inputs come near it: 0.9 GB, 0.27 ms at
// 3.35 TB/s at B 1000, n 1300). The rows of W^T and x behind the entries
// are re-read from L2 (~0.5 GB a tail), so L2 and the latency of those
// loads bound it in practice. Entries with a cotangent of exactly 0 are
// skipped (adding 0 * x changes no sum for a finite x): the forward's
// torch.where gives cmin a zero cotangent on every channel whose BN scale
// is >= 0 and cmax on the others, about half of them.
//
// tail_grad_dx_kernel: one block per batch row. Its 2C entries (e < C: the
// max of channel e, else the min of channel e - C; in passes of ENT
// entries for a wide C) are counting-sorted by point in shared memory:
// a histogram over the n points, an exclusive scan, then a stable
// placement by one warp (__match_any_sync ranks equal points within 32
// entries), so each point's bucket lists its entries in entry order. One
// warp then takes each touched point, sums its bucket in that order with
// each lane holding 4 of the 128 columns (W^T rows read as float4, four
// loads in flight), and adds the sum to its row of grad_x once. A point
// belongs to one warp of one block: no atomics, and a fixed order.
//
// tail_grad_dw_kernel: a block of DW_CH channels x DW_SEG warps each.
// The warp of channel c and segment s walks the 32-row groups g = s, s +
// DW_SEG, ... of the batch: it loads the group's args and cotangents (one
// row per lane; the block's DW_CH channels share their sectors), takes the
// nonzero entries by ballot, the max entries then the min entries, and
// adds g x[b, arg, :] with four row loads in flight. The DW_SEG partial
// sums of a channel then add in segment order through shared memory and
// into grad_W's column c. Deterministic: every sum has a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CIN = 128;  // conv2 width feeding every conv3 tail
constexpr int LANES = CIN / 4;  // a lane holds 4 columns (one float4)
static_assert(LANES == 32, "one warp spans the 128 columns");
constexpr unsigned FULL = 0xffffffffu;

constexpr int DX_THREADS = 256;
constexpr int DX_WARPS = DX_THREADS / 32;
constexpr int ENT = 2048;  // entries sorted per pass: 1,024 channels
constexpr int MAX_POINTS = 32768;
// bins (n), entry points and cotangents, the sorted entries (ENT each)
constexpr int DX_SMEM_MAX = 4 * MAX_POINTS + 12 * ENT;
static_assert(DX_SMEM_MAX + 1024 <= 232448,
              "shared memory over the sm_90 limit");

constexpr int DW_CH = 8;   // channels per block: 32 bytes of an arg row
constexpr int DW_SEG = 4;  // warps per channel, over the batch rows
constexpr int DW_THREADS = 32 * DW_CH * DW_SEG;

__device__ __forceinline__ void fma4(float4& acc, float g, const float4& v) {
  acc.x = fmaf(g, v.x, acc.x);
  acc.y = fmaf(g, v.y, acc.y);
  acc.z = fmaf(g, v.z, acc.z);
  acc.w = fmaf(g, v.w, acc.w);
}

// In place, over a[0..n): the exclusive prefix sums. Every thread calls it.
__device__ void block_exclusive_scan(int* a, int n, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + DX_THREADS - 1) / DX_THREADS;
  const int i0 = min(tid * per, n), i1 = min(i0 + per, n);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
  for (int i = i0; i < i1; ++i) {
    const int t = a[i];
    a[i] = run;
    run += t;
  }
}

__global__ void __launch_bounds__(DX_THREADS)
tail_grad_dx_kernel(const float4* __restrict__ wt, const int* __restrict__ amax,
                    const int* __restrict__ amin,
                    const float* __restrict__ gmax,
                    const float* __restrict__ gmin, int n, int cout,
                    float4* __restrict__ grad_x) {
  extern __shared__ int smem[];
  int* bins = smem;             // counts, then starts, then bucket ends
  int* ent_p = bins + n;        // point of each entry, -1 if skipped
  float* ent_g = reinterpret_cast<float*>(ent_p + ENT);
  int* slot = reinterpret_cast<int*>(ent_g + ENT);  // entries by point
  __shared__ int warp_tot[DX_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)blockIdx.x * cout;
  float4* gx = grad_x + (size_t)blockIdx.x * n * LANES;

  for (int c0 = 0; c0 < cout; c0 += ENT / 2) {
    const int cc = min(ENT / 2, cout - c0);
    const int ne = 2 * cc;
    for (int i = tid; i < n; i += DX_THREADS) bins[i] = 0;
    __syncthreads();
    for (int e = tid; e < ne; e += DX_THREADS) {
      const bool is_max = e < cc;
      const size_t i = row + c0 + (is_max ? e : e - cc);
      const float g = is_max ? gmax[i] : gmin[i];
      int p = is_max ? amax[i] : amin[i];
      if (g == 0.0f || p < 0 || p >= n) p = -1;
      ent_p[e] = p;
      ent_g[e] = g;
      if (p >= 0) atomicAdd(&bins[p], 1);  // a count: order-free
    }
    __syncthreads();
    block_exclusive_scan(bins, n, warp_tot);
    __syncthreads();
    // stable placement: bins[p] advances from the start of p's bucket to
    // its end (= the start of p + 1's)
    if (warp == 0) {
      for (int e0 = 0; e0 < ne; e0 += 32) {
        const int e = e0 + lane;
        const int p = e < ne ? ent_p[e] : -1;
        const unsigned peers = __match_any_sync(FULL, p);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int start = p >= 0 ? bins[p] : 0;
        __syncwarp();
        if (p >= 0) {
          slot[start + rank] = e;
          if (rank == 0) bins[p] = start + __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int q0 = warp * 32; q0 < n; q0 += DX_THREADS) {
      const int q = q0 + lane;
      const int end = q < n ? bins[q] : 0;
      const int begin = q < n && q > 0 ? bins[q - 1] : 0;
      unsigned todo = __ballot_sync(FULL, end > begin);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int s1 = __shfl_sync(FULL, end, j);
        int s = __shfl_sync(FULL, begin, j);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (; s + 4 <= s1; s += 4) {
          float g[4];
          float4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = slot[s + u];
            g[u] = ent_g[e];
            v[u] = __ldg(wt + (size_t)(c0 + (e < cc ? e : e - cc)) * LANES +
                         lane);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) fma4(acc, g[u], v[u]);
        }
        for (; s < s1; ++s) {
          const int e = slot[s];
          fma4(acc, ent_g[e],
               __ldg(wt + (size_t)(c0 + (e < cc ? e : e - cc)) * LANES + lane));
        }
        float4* dst = gx + (size_t)(q0 + j) * LANES + lane;
        float4 o = *dst;
        o.x += acc.x;
        o.y += acc.y;
        o.z += acc.z;
        o.w += acc.w;
        *dst = o;
      }
    }
    __syncthreads();  // the next pass reuses the bins and may add to a row
  }
}

// acc += g[j] * x[b0 + j, p[j], :] over the lanes j whose g is nonzero, in
// lane order, four row loads in flight
__device__ __forceinline__ void add_rows(const float4* __restrict__ x, int b0,
                                         int n, int p, float g, int lane,
                                         float4& acc) {
  unsigned todo = __ballot_sync(FULL, g != 0.0f);
  while (todo) {
    int j[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      j[u] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
    }
    float gg[4];
    float4 v[4] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = j[u] < 0 ? j[0] : j[u];  // warp-uniform
      const int pp = __shfl_sync(FULL, p, jj);
      gg[u] = __shfl_sync(FULL, g, jj);
      if (j[u] >= 0) {
        v[u] = __ldg(x + ((size_t)(b0 + jj) * n + pp) * LANES + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j[u] >= 0) fma4(acc, gg[u], v[u]);
    }
  }
}

__global__ void __launch_bounds__(DW_THREADS)
tail_grad_dw_kernel(const float4* __restrict__ x, const int* __restrict__ amax,
                    const int* __restrict__ amin,
                    const float* __restrict__ gmax,
                    const float* __restrict__ gmin, int batch, int n,
                    int cout, float* __restrict__ grad_w) {
  __shared__ float4 part[DW_SEG][DW_CH][LANES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = warp % DW_CH, seg = warp / DW_CH;
  const int c = blockIdx.x * DW_CH + ch;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < cout) {  // warp-uniform
    for (int b0 = seg * 32; b0 < batch; b0 += DW_SEG * 32) {
      const int b = b0 + lane;
      int pmax = 0, pmin = 0;
      float gm = 0.0f, gn = 0.0f;
      if (b < batch) {
        const size_t i = (size_t)b * cout + c;
        pmax = amax[i];
        pmin = amin[i];
        gm = gmax[i];
        gn = gmin[i];
        if (pmax < 0 || pmax >= n) gm = 0.0f;
        if (pmin < 0 || pmin >= n) gn = 0.0f;
      }
      add_rows(x, b0, n, pmax, gm, lane, acc);
      add_rows(x, b0, n, pmin, gn, lane, acc);
    }
  }
  part[seg][ch][lane] = acc;
  __syncthreads();
  if (seg == 0 && c < cout) {
    float4 s = part[0][ch][lane];
#pragma unroll
    for (int k = 1; k < DW_SEG; ++k) {
      const float4 t = part[k][ch][lane];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    float* col = grad_w + (size_t)(4 * lane) * cout + c;
    col[0] += s.x;
    col[(size_t)cout] += s.y;
    col[2 * (size_t)cout] += s.z;
    col[3 * (size_t)cout] += s.w;
  }
}

}  // namespace

// Adds the one-hot terms to grad_x (B, n, 128) and grad_w (128, C) in place,
// both kernels on ``stream``. x and grad_x 16-byte aligned, wt = W^T (C,
// 128) as well; args int32, cotangents fp32, all (B, C) and contiguous.
// Returns a cudaError_t.
extern "C" int p2s_tail_grad(int dev, const void* x, int batch, int n, int k,
                             const void* wt, int cout, const void* amax,
                             const void* amin, const void* gmax,
                             const void* gmin, void* grad_x, void* grad_w,
                             void* stream) {
  if (k != CIN || batch < 1 || n < 1 || n > MAX_POINTS || cout < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(grad_x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the shared-memory attribute, once per device
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(tail_grad_dx_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DX_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* imax = static_cast<const int*>(amax);
  const int* imin = static_cast<const int*>(amin);
  const float* fmax = static_cast<const float*>(gmax);
  const float* fmin = static_cast<const float*>(gmin);
  tail_grad_dx_kernel<<<batch, DX_THREADS, 4 * n + 12 * ENT, st>>>(
      static_cast<const float4*>(wt), imax, imin, fmax, fmin, n, cout,
      static_cast<float4*>(grad_x));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_grad_dw_kernel<<<(cout + DW_CH - 1) / DW_CH, DW_THREADS, 0, st>>>(
      static_cast<const float4*>(x), imax, imin, fmax, fmin, batch, n, cout,
      static_cast<float*>(grad_w));
  return static_cast<int>(cudaGetLastError());
}
