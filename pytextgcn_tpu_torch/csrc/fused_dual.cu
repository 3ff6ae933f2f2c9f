// Dual dense product for Hopper (sm_90a): out = D @ xh and hot = D^T @ x,
// reading each element of D from device memory once.
//
// Replaces the three TPU kernels of pytextgcn_tpu/ops/fused_dual.py, which
// compute the same pair in one pass over D with a sequential Pallas grid:
//   * _kernel_split (:185) -- D as a bf16 (hi, lo) pair, x and xh split to
//     hi/lo bf16, three bf16 products (hi*hi + hi*lo + lo*hi) with f32
//     accumulation: variant kSplit here;
//   * _kernel (:53) -- one D, f32 at HIGHEST or bf16 at DEFAULT: variants
//     kF32 (f32 FMA on the CUDA cores, which meets HIGHEST; TF32 would not)
//     and kBf16 (one bf16 tensor-core pass, f32 accumulation);
//   * _kernel_t (:159) -- _kernel with the hot product held as [H, K]: the
//     HOT_T template flag, which only changes where hot is written.
// Outputs are always f32. The hybrid SpMM (ops/hybrid.py) calls it through
// ops/fused_dual.py, forward with (x, xh) and backward with (g_out, g_hot).
//
// The TPU grid runs in order, so its hot block stays resident and sums over
// every row block. Hopper runs blocks in parallel, so here each block owns
// a slab of kBN rows of D and walks all of K in tiles of kBK columns:
//   * its out rows are summed in registers across the whole K loop and
//     written once, by this block alone;
//   * each tile's [kBK, H] hot partial (over the slab's rows) is added into
//     a zeroed f32 hot buffer (1.6 MB at K = 4096, H = 100: it stays in the
//     50 MB L2) with atomicAdd. The order of those additions differs from
//     run to run, so hot varies in its last bits between runs; checks scale
//     their tolerance by |D|^T @ |x| instead of asking for equal bits.
//   * The slab of x (hi/lo for kSplit) sits in shared memory for the whole
//     block; D and xh tiles for step kt+1 are loaded into registers while
//     step kt computes, then stored to shared memory.
//   * Tensor-core variants use mma.sync.m16n8k16 (bf16 in, f32 accumulate)
//     fed by ldmatrix (.trans for D^T and for the row-major x and xh).
//     Eight warps: for out, warp w owns rows 16w..16w+15 and all column
//     tiles; for hot, warp w owns tile rows 16(w&3).. and half the column
//     tiles. kF32 uses the same tiling with plain FMA.
//   * N, K and H are masked in the kernel (zero-filled loads, masked stores
//     and atomics), so any shape runs: no padding of D, no tiny-K fallback.
//     A block covers 8*NT columns (NT = 8 for H <= 64, else 16); wider H
//     takes more column blocks (blockIdx.y), each reading D again.
//
// What bounds it on an H100 at the main path's shape (N = 77,923,
// K = 4096; chip_smoke.py prints the figures from its run): bytes. The D
// pair is 1,277 MB; with x, xh, out and hot at H = 100 that is 1,342 MB,
// 0.40 ms at 3.35 TB/s. kSplit runs 3 x 2 x 2*N*K*H = 383 GFLOP at H = 100
// (165 at H = 43), 0.39 ms (0.17 ms) at 989 TFLOP/s dense bf16: the tensor
// cores are close behind the bytes at H = 100. This first version keeps one
// block per SM (141 KB of shared memory) and reads every mma operand
// through ldmatrix, so shared-memory bandwidth and the L2 atomics of hot,
// not device memory, are expected to limit it (PERF.md has the times).
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // rows of D a block owns
constexpr int kBK = 64;        // columns of D per K step
constexpr int kPadB = 8;       // bf16 row padding in shared memory (16 bytes)
constexpr int kPadF = 4;       // f32 row padding (16 bytes)

enum Variant { kSplit = 0, kBf16 = 1, kF32 = 2 };

template <int V>
struct Traits;
template <>
struct Traits<kSplit> {
  using DT = __nv_bfloat16;  // D element
  using XT = float;          // x and xh element
  using ST = __nv_bfloat16;  // shared-memory element
  static constexpr int kPlanes = 2;  // hi, lo
  static constexpr int kPad = kPadB;
};
template <>
struct Traits<kBf16> {
  using DT = __nv_bfloat16;
  using XT = __nv_bfloat16;
  using ST = __nv_bfloat16;
  static constexpr int kPlanes = 1;
  static constexpr int kPad = kPadB;
};
template <>
struct Traits<kF32> {
  using DT = float;
  using XT = float;
  using ST = float;
  static constexpr int kPlanes = 1;
  static constexpr int kPad = kPadF;
};

template <int V, int NT>
constexpr size_t smem_bytes() {
  using Tr = Traits<V>;
  constexpr size_t ldd = kBK + Tr::kPad;
  constexpr size_t ldx = 8 * NT + Tr::kPad;
  return sizeof(typename Tr::ST) * Tr::kPlanes * (kBN * ldd + (kBK + kBN) * ldx);
}

__device__ __forceinline__ float ld_or0(const float* p, bool ok) {
  return ok ? __ldg(p) : 0.f;
}

__device__ __forceinline__ __nv_bfloat16 ld_or0(const __nv_bfloat16* p, bool ok) {
  return __ushort_as_bfloat16(
      ok ? __ldg(reinterpret_cast<const unsigned short*>(p)) : (unsigned short)0);
}

// One x or xh element into shared memory: split to (hi, lo) for kSplit,
// copied for the others. hi is bf16 round-to-nearest-even of v, lo the same
// rounding of v - hi (ops/fused_dual.py::split_bf16).
template <int V>
__device__ __forceinline__ void put_x(typename Traits<V>::ST* hi, size_t plane, int off,
                                      typename Traits<V>::XT v) {
  if constexpr (V == kSplit) {
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    hi[off] = h;
    hi[plane + off] = __float2bfloat16_rn(v - __bfloat162float(h));
  } else {
    hi[off] = v;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16, row) @ b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int V, int NT, bool HOT_T>
__global__ void __launch_bounds__(kThreads, 1)
fused_dual_kernel(const void* __restrict__ d_hi_, const void* __restrict__ d_lo_,
                  const void* __restrict__ x_, const void* __restrict__ xh_, int n, int k,
                  int h, int vec_ok, float* __restrict__ out, float* __restrict__ hot) {
  using Tr = Traits<V>;
  using DT = typename Tr::DT;
  using XT = typename Tr::XT;
  using ST = typename Tr::ST;
  // raw element bits of D: the tile loader copies D without converting it
  using RT = typename std::conditional<sizeof(DT) == 2, uint16_t, uint32_t>::type;
  constexpr int P = Tr::kPlanes;
  constexpr int CW = 8 * NT;                   // columns of x/xh/out a block covers
  constexpr int LDD = kBK + Tr::kPad;          // shared row stride of a D tile
  constexpr int LDX = CW + Tr::kPad;           // shared row stride of x and xh
  constexpr int EPC = 16 / sizeof(DT);         // D elements per 16-byte chunk
  constexpr int CPR = kBK / EPC;               // chunks per D tile row
  constexpr int DCH = kBN * CPR / kThreads;    // chunks per thread per D plane
  constexpr int XPT = kBK * CW / kThreads;     // xh elements per thread per tile
  constexpr size_t DPLANE = (size_t)kBN * LDD;
  constexpr size_t XHPLANE = (size_t)kBK * LDX;
  constexpr size_t XPLANE = (size_t)kBN * LDX;
  static_assert(kBN * CPR % kThreads == 0 && kBK * CW % kThreads == 0, "tile split");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  ST* const d_s = reinterpret_cast<ST*>(smem_raw);  // P planes [kBN][LDD]
  ST* const xh_s = d_s + P * DPLANE;                // P planes [kBK][LDX]
  ST* const x_s = xh_s + P * XHPLANE;               // P planes [kBN][LDX]

  const DT* const d_pl[2] = {static_cast<const DT*>(d_hi_), static_cast<const DT*>(d_lo_)};
  const XT* const x = static_cast<const XT*>(x_);
  const XT* const xh = static_cast<const XT*>(xh_);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBN;
  const int c0 = blockIdx.y * CW;
  const int nt = min(NT, (h - c0 + 7) / 8);  // column tiles with live columns

  // the block's slab of x, once
  for (int i = tid; i < kBN * CW; i += kThreads) {
    const int r = i / CW, c = i % CW;
    const int row = r0 + r, col = c0 + c;
    put_x<V>(x_s, XPLANE, r * LDX + c,
             ld_or0(x + (size_t)row * h + col, row < n && col < h));
  }

  uint4 dreg[P][DCH];
  XT xreg[XPT];
  auto load_tile = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < DCH; ++i) {
        const int ch = tid + i * kThreads;
        const int row = r0 + ch / CPR;
        const int kk = k0 + (ch % CPR) * EPC;
        const DT* src = d_pl[p] + (size_t)row * k + kk;
        if (vec_ok && row < n && kk + EPC <= k) {
          dreg[p][i] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          alignas(16) RT bits[EPC];
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            bits[e] = (row < n && kk + e < k) ? __ldg(reinterpret_cast<const RT*>(src) + e)
                                              : (RT)0;
          dreg[p][i] = *reinterpret_cast<const uint4*>(bits);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = k0 + idx / CW, col = c0 + idx % CW;
      xreg[i] = ld_or0(xh + (size_t)kk * h + col, kk < k && col < h);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < DCH; ++i) {
        const int ch = tid + i * kThreads;
        *reinterpret_cast<uint4*>(d_s + p * DPLANE + (ch / CPR) * LDD + (ch % CPR) * EPC) =
            dreg[p][i];
      }
    }
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int idx = tid + i * kThreads;
      put_x<V>(xh_s, XHPLANE, (idx / CW) * LDX + idx % CW, xreg[i]);
    }
  };
  auto add_hot = [&](int kk, int col, float v) {
    if (hot != nullptr && kk < k && col < h)
      atomicAdd(hot + (HOT_T ? (size_t)col * k + kk : (size_t)kk * h + col), v);
  };

  const int nkt = (k + kBK - 1) / kBK;
  if (nkt > 0) load_tile(0);

  if constexpr (V != kF32) {
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;   // mma fragment row group, column pair
    const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row, matrix index
    const int mt = warp & 3, nh = warp >> 2;  // hot: tile row block, column half
    float acc1[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc1[j][q] = 0.f;

    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      store_tile();
      __syncthreads();
      if (kt + 1 < nkt) load_tile(kt + 1);

      // out[16 warp.., :] += D[16 warp.., tile] @ xh[tile, :]
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t ahi[4], alo[4];
        const int aoff = (16 * warp + lr + (lm & 1) * 8) * LDD + 16 * ks + (lm >> 1) * 8;
        ldsm_x4(ahi, d_s + aoff);
        if constexpr (V == kSplit) ldsm_x4(alo, d_s + DPLANE + aoff);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j < nt) {
            const int boff = (16 * ks + lr + (lm & 1) * 8) * LDX + 8 * j + (lm >> 1) * 8;
            uint32_t bhi[4];
            ldsm_x4_t(bhi, xh_s + boff);
            mma(acc1[j], ahi, bhi[0], bhi[1]);
            if (j + 1 < nt) mma(acc1[j + 1], ahi, bhi[2], bhi[3]);
            if constexpr (V == kSplit) {
              uint32_t blo[4];
              ldsm_x4_t(blo, xh_s + XHPLANE + boff);
              mma(acc1[j], ahi, blo[0], blo[1]);
              mma(acc1[j], alo, bhi[0], bhi[1]);
              if (j + 1 < nt) {
                mma(acc1[j + 1], ahi, blo[2], blo[3]);
                mma(acc1[j + 1], alo, bhi[2], bhi[3]);
              }
            }
          }
        }
      }

      // hot[tile rows 16 mt.., half nh of the columns] = D^T @ x over the slab
      float acc2[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc2[j][q] = 0.f;
#pragma unroll
      for (int rs = 0; rs < kBN / 16; ++rs) {
        uint32_t ahi[4], alo[4];
        const int aoff = (16 * rs + lr + (lm >> 1) * 8) * LDD + 16 * mt + (lm & 1) * 8;
        ldsm_x4_t(ahi, d_s + aoff);
        if constexpr (V == kSplit) ldsm_x4_t(alo, d_s + DPLANE + aoff);
#pragma unroll
        for (int jj = 0; jj < NT / 2; jj += 2) {
          const int j = nh * (NT / 2) + jj;
          if (j < nt) {
            const int boff = (16 * rs + lr + (lm & 1) * 8) * LDX + 8 * j + (lm >> 1) * 8;
            uint32_t bhi[4];
            ldsm_x4_t(bhi, x_s + boff);
            mma(acc2[jj], ahi, bhi[0], bhi[1]);
            if (j + 1 < nt) mma(acc2[jj + 1], ahi, bhi[2], bhi[3]);
            if constexpr (V == kSplit) {
              uint32_t blo[4];
              ldsm_x4_t(blo, x_s + XPLANE + boff);
              mma(acc2[jj], alo, bhi[0], bhi[1]);
              mma(acc2[jj], ahi, blo[0], blo[1]);
              if (j + 1 < nt) {
                mma(acc2[jj + 1], alo, bhi[2], bhi[3]);
                mma(acc2[jj + 1], ahi, blo[2], blo[3]);
              }
            }
          }
        }
      }
      const int kbase = kt * kBK + 16 * mt + g;
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        const int col = c0 + 8 * (nh * (NT / 2) + jj) + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) add_hot(kbase + (q >> 1) * 8, col + (q & 1), acc2[jj][q]);
      }
    }

#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + 16 * warp + g + (q >> 1) * 8;
        const int col = c0 + 8 * j + 2 * t + (q & 1);
        if (row < n && col < h) out[(size_t)row * h + col] = acc1[j][q];
      }
    }
  } else {
    // f32 FMA. out: thread owns rows rg + 32 i (i < 4), columns cg + 8 j.
    // hot: thread owns tile rows kg + 16 i (i < 4), columns cg2 + 16 j.
    const int rg = tid >> 3, cg = tid & 7;
    const int kg = tid >> 4, cg2 = tid & 15;
    float acc1[4][NT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc1[i][j] = 0.f;

    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      store_tile();
      __syncthreads();
      if (kt + 1 < nkt) load_tile(kt + 1);

#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], b[NT];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = d_s[(rg + 32 * i) * LDD + kk];
#pragma unroll
        for (int j = 0; j < NT; ++j) b[j] = xh_s[kk * LDX + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc1[i][j] = fmaf(a[i], b[j], acc1[i][j]);
      }

      float acc2[4][NT / 2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) acc2[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < kBN; ++r) {
        float a[4], b[NT / 2];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = d_s[r * LDD + kg + 16 * i];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) b[j] = x_s[r * LDX + cg2 + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) acc2[i][j] = fmaf(a[i], b[j], acc2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          add_hot(kt * kBK + kg + 16 * i, c0 + cg2 + 16 * j, acc2[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = r0 + rg + 32 * i, col = c0 + cg + 8 * j;
        if (row < n && col < h) out[(size_t)row * h + col] = acc1[i][j];
      }
    }
  }
}

template <int V, int NT, bool HOT_T>
cudaError_t launch(const void* d_hi, const void* d_lo, const void* x, const void* xh, int n,
                   int k, int h, int vec_ok, float* out, float* hot, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<V, NT>();
  auto kern = fused_dual_kernel<V, NT, HOT_T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + kBN - 1) / kBN), (unsigned)((h + 8 * NT - 1) / (8 * NT)));
  kern<<<grid, kThreads, smem, s>>>(d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch(int hot_t, const void* d_hi, const void* d_lo, const void* x,
                     const void* xh, int n, int k, int h, int vec_ok, float* out, float* hot,
                     cudaStream_t s) {
#define FD_LAUNCH(NT, HT) launch<V, NT, HT>(d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot, s)
  if (h <= 64) return hot_t ? FD_LAUNCH(8, true) : FD_LAUNCH(8, false);
  return hot_t ? FD_LAUNCH(16, true) : FD_LAUNCH(16, false);
#undef FD_LAUNCH
}

}  // namespace

// variant: 0 = split (d_hi, d_lo bf16; x, xh f32), 1 = bf16 (d_hi, x, xh
// bf16), 2 = f32 (d_hi, x, xh f32). D is [n, k], x [n, h], xh [k, h], all
// contiguous; out [n, h] f32 is written whole; hot is f32, [k, h] (hot_t 0)
// or [h, k] (hot_t 1), and must be zeroed by the caller. A null hot skips
// the hot side's atomics (its product is still computed): chip_smoke.py
// times the kernel so to see what the atomics cost. vec_ok: k and the
// D pointers allow 16-byte loads of D rows. Returns a cudaError_t as int.
extern "C" int fused_dual_launch(int variant, int hot_t, const void* d_hi, const void* d_lo,
                                 const void* x, const void* xh, int n, int k, int h,
                                 int vec_ok, float* out, float* hot, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kSplit)
    return (int)dispatch<kSplit>(hot_t, d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot, s);
  if (variant == kBf16)
    return (int)dispatch<kBf16>(hot_t, d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot, s);
  if (variant == kF32)
    return (int)dispatch<kF32>(hot_t, d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot, s);
  return (int)cudaErrorInvalidValue;
}
