// CSR sparse-dense product for Hopper (sm_90a): out = A @ x.
//
// Replaces the TPU kernel pytextgcn_tpu/ops/spmm_pallas.py::_spmm_kernel,
// which computes out[r] = sum_{e: dst_e = r} w_e * x[src_e] as a one-hot
// [row_block, edge_tile] @ [edge_tile, h_pad] MXU product per
// destination-sorted tile, on rows gathered by XLA outside the kernel. Here
// the same function is computed from a destination-sorted CSR plan built on
// the host (ops/spmm_cuda.py::build_csr_plan): the kernel gathers x[col]
// itself, so nothing of size E*H is written, and the one-hot product
// becomes f32 FMA (both the 'highest' and the 'split2' class of the TPU
// kernel).
//
// What bounds it on an H100. Its bytes bound counts x once (169 MB at the
// 50k-document synthetic-amazon graph, H = 100: 50.5 us at 3.35 TB/s), but
// a row gather reads x[col] once per edge: E * H * 4 = 5.3 GB at H = 100,
// through the SM's L1 and, where L1 misses, from L2 (x, 31 MB, stays in the
// 50 MB L2: an evict-last policy for x changes nothing). Timing builds of
// this source (PERF.md) split a launch at H = 100 (0.59 ms) into about
// 0.27 ms that does not read x (the (col, val) stream, the shuffles, the
// FMAs, the stores), 0.13 ms more when every row read hits L1, and 0.19 ms
// more for the rows that miss L1. What the design does about it:
//
//   * x rows are read as 16-byte (f32) or 8-byte (bf16) vectors, 4 columns
//     a lane, always: the wrapper pads a row whose width is not a multiple
//     of 4 (or an x off 16 bytes) into an aligned copy, so H = 43 reads 176
//     bytes in one instruction instead of two scalar chunks of 128 and 44.
//   * A row of W = ld/4 vectors takes L = min(W, 32) lanes; a warp runs
//     G = 32 / L edges at once (G = 2 at H = 43, 8 at H = 16), each group of
//     L lanes on its own edges, and adds the groups' sums in group order at
//     the end, so narrow rows leave fewer lanes idle and need fewer steps.
//     Rows wider than 128 columns take more column blocks (blockIdx.y).
//   * (col, val) come from the plan as one interleaved [E] array of 8-byte
//     pairs: one coalesced load a lane brings 32 edges' pairs, and each
//     edge's pair reaches its group by two shuffles (one an edge at G = 2).
//   * Few registers, so many warps an SM hide the gather's latency: no
//     shared memory (a staging buffer for the pairs took L1 from x and ran
//     slower), kUnroll = 4 row loads in flight a step (8 and 16 ran slower),
//     and masks only on the last steps of a 32-edge window, which go one
//     edge at a time (masked batches needed 60-80 registers).
//   * Work item = one "segment" of at most SEG_EDGES consecutive edges of
//     one row (the plan cuts long rows; an empty row has one empty segment
//     and writes exact zeros). One warp a segment. A row that fits in one
//     segment is written directly; a longer row's segments write partial
//     sums to scratch and a second kernel adds them in segment order. No
//     atomics anywhere: results repeat bit for bit.
//   * bf16 mode reads x as bf16 and accumulates in f32; out is always f32.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Timing builds (never used for a result; ops/spmm_cuda.py builds them
// under their own tags, chip_smoke.py times them beside the kernel):
//   SPMM_L1_RESIDENT  gather x[col & 511] (a row of x, as col & 511 <= col):
//                     every row read hits L1
//   SPMM_NO_GATHER    no x loads: the FMAs take the column bits instead
//   SPMM_CACHE_HINTS  (col, val) read and out written evict-first, x read
//                     with an L2 evict-last policy

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // row loads a group has in flight
constexpr unsigned kFull = 0xffffffffu;

#ifdef SPMM_L1_RESIDENT
__device__ __forceinline__ int gather_row(int c) { return c & 511; }
#else
__device__ __forceinline__ int gather_row(int c) { return c; }
#endif

#ifdef SPMM_CACHE_HINTS
__device__ __forceinline__ uint64_t x_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ int2 ld_pair(const int2* p) { return __ldcs(p); }
__device__ __forceinline__ void st_out(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_out(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ float4 ld_x(const float4* p, uint64_t pol) {
  float4 q;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w) : "l"(p), "l"(pol));
  return q;
}
__device__ __forceinline__ uint2 ld_x(const uint2* p, uint64_t pol) {
  uint2 q;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(q.x), "=r"(q.y) : "l"(p), "l"(pol));
  return q;
}
#else
__device__ __forceinline__ uint64_t x_policy() { return 0; }
__device__ __forceinline__ int2 ld_pair(const int2* p) { return __ldg(p); }
__device__ __forceinline__ void st_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_out(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ float4 ld_x(const float4* p, uint64_t) { return __ldg(p); }
__device__ __forceinline__ uint2 ld_x(const uint2* p, uint64_t) { return __ldg(p); }
#endif

// Four consecutive columns of one row, converted to f32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4], uint64_t pol) {
  const float4 q = ld_x(reinterpret_cast<const float4*>(p), pol);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4], uint64_t pol) {
  const uint2 q = ld_x(reinterpret_cast<const uint2*>(p), pol);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Columns c..c+3 of a row of width h (c < h): one 16-byte store when the
// row is 16-byte aligned (h % 4 == 0), else one store a column.
__device__ __forceinline__ void store4(float* row, int c, int h, const float (&v)[4]) {
  if ((h & 3) == 0) {
    st_out(reinterpret_cast<float4*>(row + c), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < h) st_out(row + c + k, v[k]);
  }
}

// One warp per segment, G groups of L lanes; lane i of group g holds
// columns 4 * (blockIdx.y * 32 + i) .. + 3 of its edges' rows. The warp
// reads the (col, val) pairs of 32 edges at a time, one coalesced 8-byte
// load a lane; group g takes edges g, g + G, g + 2G, ... of them, each
// broadcast from the lane that read it by two shuffles. While every group
// has an edge left, kUnroll steps go at once (their row loads issued
// before their FMAs, no masks); the last steps of the 32 go one at a time.
template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_segments_kernel(const int* __restrict__ seg_ptr,
                     const int* __restrict__ seg_row,
                     const int* __restrict__ seg_slot,
                     const int2* __restrict__ pairs,
                     const T* __restrict__ x,
                     int n_seg, int h, int ld, int lanes, int groups,
                     float* __restrict__ out,
                     float* __restrict__ partial) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= n_seg) return;  // uniform across the warp
  const int g = lane / lanes;
  const int c = (blockIdx.y * kWarp + lane - g * lanes) * 4;
  const bool active = g < groups && c < ld;
  const int gs = g < groups ? g : 0;  // idle lanes shuffle as group 0 does
  const int begin = seg_ptr[seg];
  const int end = seg_ptr[seg + 1];
  const uint64_t pol = x_policy();
  const T* xc = x + c;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int wb = begin; wb < end; wb += kWarp) {  // uniform across the warp
    const int2 p = wb + lane < end ? ld_pair(pairs + wb + lane) : make_int2(0, 0);
    const int n = min(kWarp, end - wb);
    const int full = n / groups;  // steps in which every group has an edge
    int s = 0;
    for (; s + kUnroll <= full; s += kUnroll) {  // uniform across the warp
      int col[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = gs + groups * (s + u);
        col[u] = __shfl_sync(kFull, p.x, src);
        w[u] = __int_as_float(__shfl_sync(kFull, p.y, src));
      }
      if (active) {
        float xv[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#ifdef SPMM_NO_GATHER
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[u][k] = __int_as_float(col[u] + k);
#else
          load4(xc + (size_t)gather_row(col[u]) * ld, xv[u], pol);
#endif
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = fmaf(w[u], xv[u][k], acc[k]);
      }
    }
    for (; groups * s < n; ++s) {  // uniform across the warp
      const int src = (gs + groups * s) & (kWarp - 1);
      const int cs = __shfl_sync(kFull, p.x, src);
      const float ws = __int_as_float(__shfl_sync(kFull, p.y, src));
      if (active && g + groups * s < n) {
        float xv[4];
#ifdef SPMM_NO_GATHER
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = __int_as_float(cs + k);
#else
        load4(xc + (size_t)gather_row(cs) * ld, xv, pol);
#endif
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(ws, xv[k], acc[k]);
      }
    }
  }
  // group sums in group order, into group 0
  float tot[4] = {acc[0], acc[1], acc[2], acc[3]};
  for (int gg = 1; gg < groups; ++gg)
#pragma unroll
    for (int k = 0; k < 4; ++k) tot[k] += __shfl_down_sync(kFull, acc[k], gg * lanes);
  if (g != 0 || !active) return;
  const int slot = seg_slot[seg];
  if (slot < 0) {
    if (c < h) store4(out + (size_t)seg_row[seg] * h, c, h, tot);
  } else {
    st_out(reinterpret_cast<float4*>(partial + (size_t)slot * ld + c),
           make_float4(tot[0], tot[1], tot[2], tot[3]));
  }
}

// One warp per cut row: adds its segments' partial sums (rows of width ld)
// in segment order, with kUnroll partial rows in flight (a hub row has
// hundreds of segments), into out (rows of width h).
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
combine_partials_kernel(const int* __restrict__ split_row,
                        const int* __restrict__ split_ptr,
                        const float* __restrict__ partial,
                        int n_split, int h, int ld,
                        float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n_split) return;
  const int c = (blockIdx.y * kWarp + lane) * 4;
  if (c >= h) return;
  const uint64_t pol = x_policy();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int end = split_ptr[k + 1];
  int s = split_ptr[k];
  for (; s + kUnroll <= end; s += kUnroll) {
    float v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load4(partial + (size_t)(s + u) * ld + c, v[u], pol);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += v[u][i];
  }
  for (; s < end; ++s) {
    float v[4];
    load4(partial + (size_t)s * ld + c, v, pol);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += v[i];
  }
  store4(out + (size_t)split_row[k] * h, c, h, acc);
}

template <typename T>
cudaError_t launch(const int* seg_ptr, const int* seg_row, const int* seg_slot, int n_seg,
                   const int2* pairs, const T* x, int h, int ld, float* out,
                   float* partial, const int* split_row, const int* split_ptr,
                   int n_split, cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const int vecs = ld / 4;                       // 4-column vectors a row
  const int col_blocks = (vecs + kWarp - 1) / kWarp;
  const int lanes = vecs < kWarp ? vecs : kWarp;
  const int groups = kWarp / lanes;
  if (n_seg > 0) {
    const dim3 grid((unsigned)((n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock),
                    (unsigned)col_blocks);
    spmm_segments_kernel<T><<<grid, block, 0, stream>>>(
        seg_ptr, seg_row, seg_slot, pairs, x, n_seg, h, ld, lanes, groups, out, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_split > 0) {
    const dim3 grid((unsigned)((n_split + kWarpsPerBlock - 1) / kWarpsPerBlock),
                    (unsigned)col_blocks);
    combine_partials_kernel<<<grid, block, 0, stream>>>(split_row, split_ptr, partial,
                                                         n_split, h, ld, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. x is [n_cols, ld] with ld % 4 == 0,
// ld >= h, and its rows 16-byte (f32) or 8-byte (bf16) aligned; out is
// [n_rows, h], partial [n_partials, ld]. pairs holds (col, val bits) of
// each edge. Returns a cudaError_t as int; 0 is
// success.
extern "C" int spmm_csr_launch(const int* seg_ptr, const int* seg_row,
                               const int* seg_slot, int n_seg, const void* pairs,
                               const void* x, int x_dtype, int h, int ld, float* out,
                               float* partial, const int* split_row,
                               const int* split_ptr, int n_split, void* stream) {
  if (h <= 0) return (int)cudaSuccess;
  if (ld < h || ld % 4 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* pr = static_cast<const int2*>(pairs);
  if (x_dtype == 0)
    return (int)launch<float>(seg_ptr, seg_row, seg_slot, n_seg, pr,
                              static_cast<const float*>(x), h, ld, out, partial,
                              split_row, split_ptr, n_split, s);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16>(seg_ptr, seg_row, seg_slot, n_seg, pr,
                                      static_cast<const __nv_bfloat16*>(x), h, ld, out,
                                      partial, split_row, split_ptr, n_split, s);
  return (int)cudaErrorInvalidValue;
}
