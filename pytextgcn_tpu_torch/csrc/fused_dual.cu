// Dual dense product for Hopper (sm_90a): out = D @ xh and hot = D^T @ x,
// reading each element of D from device memory once.
//
// Replaces the three TPU kernels of pytextgcn_tpu/ops/fused_dual.py, which
// compute the same pair in one pass over D with a sequential Pallas grid:
//   * _kernel_split (:185) -- D as a bf16 (hi, lo) pair, x and xh split to
//     hi/lo bf16, three bf16 products (hi*hi + hi*lo + lo*hi) with f32
//     accumulation: variant kSplit here;
//   * _kernel (:53) -- one D, f32 at HIGHEST or bf16 at DEFAULT: variants
//     kF32 (f32-class: three TF32 tensor-core passes, below) and kBf16 (one
//     bf16 tensor-core pass, f32 accumulation);
//   * _kernel_t (:159) -- _kernel with the hot product held as [H, K]: the
//     HOT_T template flag, which only changes where hot is written.
// Outputs are always f32. The hybrid SpMM (ops/hybrid.py) calls it through
// ops/fused_dual.py, forward with (x, xh) and backward with (g_out, g_hot).
//
// The TPU grid runs in order, so its hot block stays resident and sums over
// every row block. Hopper runs blocks in parallel, so here each block owns
// a slab of rows of D and walks all of K in tiles:
//   * its out rows are summed in registers across the whole K loop and
//     written once, by this block alone (no atomics: the same bits on
//     every run);
//   * each tile's [tile, H] hot partial (over the slab's rows) is added into
//     a zeroed f32 hot buffer (1.6 MB at K = 4096, H = 100: it stays in the
//     50 MB L2) with atomicAdd. The order of those additions differs from
//     run to run, so hot varies in its last bits between runs; checks scale
//     their tolerance by |D|^T @ |x| instead of asking for equal bits.
//   * N, K and H are masked in the kernel (zero-filled loads, masked stores
//     and atomics), so any shape runs: no padding of D, no tiny-K fallback.
//     Wide H takes more column blocks (blockIdx.y), each reading D again.
//
// kSplit and kBf16 (fused_dual_kernel): 128-row slabs, 64-column K tiles,
// one block of 8 warps a SM (141 KB of shared memory); D and xh tiles for
// step kt+1 are loaded into registers while step kt computes; bf16
// mma.sync.m16n8k16 fed by ldmatrix (.trans for D^T and for the row-major
// x and xh). For out, warp w owns rows 16w..16w+15 and all column tiles;
// for hot, tile rows 16(w&3).. and half the column tiles.
//
// kF32 (fused_dual_tf32x3_kernel): f32-class on the tensor cores. Each
// operand a is split into big = cvt.rna.tf32.f32(a) (round to nearest, ties
// away from zero) and small = cvt.rna.tf32.f32(a - big), a - big being
// exact; big*big + big*small + small*big (mma.sync.m16n8k8 TF32, f32
// accumulation) leaves out only small*small, ~2^-22 of |D| @ |x|, where one
// TF32 pass would lose ~2^-11 (ops/fused_dual.py::dual_reference_tf32x3 is
// the same arithmetic in plain PyTorch). D is split as its fragments are
// read; x once per block and each xh tile once, into big and small halves
// in shared memory, since every warp re-splitting them cost more than all
// the mma (chip_smoke.py times builds without the split and with one pass).
// 64-row slabs (128 when H <= 48), 32-column K tiles through a two-stage
// cp.async ring, two blocks of 8 warps a SM, <= 128 registers. The D tile
// is XOR-swizzled so that both its fragment reads ([g][t] for D @ xh, [t][g]
// for D^T @ x) are free of bank conflicts. [K, H] hot partials are summed
// in shared memory and added as float4 atomics over the tile's contiguous
// rows of hot; [H, K] ones straight from the fragment (eight neighbours in
// K a warp atomic).
//
// What bounds it on an H100 at the main path's shape (N = 77,923,
// K = 4096; chip_smoke.py prints the figures from its run). The bytes: the
// D pair (kSplit) or the f32 D is 1,277 MB; with x, xh, out and hot at
// H = 100 that is 1,342 MB, 0.40 ms at 3.35 TB/s. The operations: kSplit
// runs 3 x 2 x 2*N*K*H = 383 GFLOP at H = 100 (165 at H = 43), 0.39 ms at
// 989 TFLOP/s dense bf16; kF32 the same count in TF32 at 495 TFLOP/s,
// 0.77 ms at H = 100 (by operations) and 0.33 ms at H = 43 (bytes bound it,
// 0.39 ms). mma.sync does not reach those peaks (wgmma does); what limits
// each variant is in PERF.md.
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

// Timing builds only (chip_smoke.py phase 9 compiles them beside the real
// one): FD_TF32_PASSES=1 runs the big*big pass alone, FD_TF32_NO_SPLIT feeds
// raw f32 bits to every pass. Neither is f32-class; both show what the
// three passes and the split cost.
#ifndef FD_TF32_PASSES
#define FD_TF32_PASSES 3
#endif

// a rounded to TF32 (10 stored significand bits, the low 13 bits zero),
// to nearest with ties away from zero (ops/fused_dual.py::split_tf32). The
// mma must only ever see such values: it truncates the low 13 bits of a raw
// f32 itself, which would break the big/small pairing.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = big + small + O(2^-22 |a|): a - big is exact in f32.
__device__ __forceinline__ void split_tf32(float a, uint32_t& big, uint32_t& small) {
#ifdef FD_TF32_NO_SPLIT
  big = small = __float_as_uint(a);
#else
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
#endif
}

__device__ __forceinline__ void split_frag(uint32_t (&big)[4], uint32_t (&small)[4], float a0,
                                           float a1, float a2, float a3) {
  split_tf32(a0, big[0], small[0]);
  split_tf32(a1, big[1], small[1]);
  split_tf32(a2, big[2], small[2]);
  split_tf32(a3, big[3], small[3]);
}

// c += a (16x8, row) @ b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += A @ B[j] for NB column tiles, in three TF32 passes: big*small
// and small*big, then big*big (small*small, ~2^-22 of |A| @ |B|, is
// dropped). Each pass runs over all NB tiles before the next, so NB
// independent mma sit between two that share an accumulator.
template <int NB>
__device__ __forceinline__ void mma3_tf32(float (&c)[NB][4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const uint32_t (&bb)[NB][2],
                                          const uint32_t (&bs)[NB][2]) {
  if constexpr (FD_TF32_PASSES == 3) {
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32(c[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32(c[j], as, bb[j][0], bb[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_tf32(c[j], ab, bb[j][0], bb[j][1]);
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

// ---------------------------------------------------------------- kF32
// Three TF32 passes on the tensor cores (mma.sync.m16n8k8). A block owns a
// slab of 128 rows of D and walks K in kBK32-column tiles through a
// two-stage ring of cp.async copies.

constexpr int kBK32 = 32;    // columns of D per K step
constexpr int kStages = 2;   // cp.async ring depth

// The tiling for NT column tiles of 8 (templates are instantiated at NT = 6
// and 13): blocks of W warps own 128 rows of D. out: MO m-tiles of 16 rows
// times OH column groups, NO tiles each; hot: two m-tiles of 16 K rows
// times HQ column groups times RH row parts, NH tiles each. A warp computes
// every tile it owns, with no branch that would keep the compiler from
// interleaving their mma: a tile past NT repeats tile NT - 1 and is not
// stored. (Skipping such a tile by a branch of its own gained nothing: the
// block's slowest warp sets its pace.)
// NT = 6 (H <= 48) runs 8 warps, two blocks a SM (111 KB of shared memory
// each); NT = 13 runs 16 warps, one block a SM (180 KB), which timed 3%
// faster than two blocks of 8 warps on 64-row slabs (PERF.md).
template <int NT>
struct Tile32 {
  static constexpr int W = NT <= 6 ? 8 : 16, BN = 128, kThreads = 32 * W;
  static constexpr int kBlocksPerSM = 16 / W;
  static constexpr int MO = BN / 16, OH = W / MO, NO = (NT + OH - 1) / OH;
  static constexpr int HQ = NT <= 6 ? 2 : 4, RH = W / 2 / HQ, NH = (NT + HQ - 1) / HQ;
  static_assert(RH == 2, "the hot partial's two row parts fill the two free buffers");
  // row stride (floats) of x and xh in shared memory: 8 * NT rounded up to
  // an odd multiple of 8, so a fragment read (lane g, t at [t][g]) hits 32 banks
  static constexpr int LDX = 8 * (NT | 1);
  // the ring (D and xh tiles), xh's small halves, x's big and small halves
  static constexpr size_t kSmem =
      sizeof(float) * (kStages * BN * kBK32 + (kStages + 1) * kBK32 * LDX + 2 * BN * LDX);
};

// D tile [BN][kBK32] with the 16-byte chunks of row r XOR-ed by
// ((r & 3) << 1) | ((r >> 2) & 1). Both fragment reads of D are then free
// of bank conflicts: [g][t] (A of D @ xh: eight rows, one chunk) and [t][g]
// (A of D^T @ x: four rows, two chunks).
__device__ __forceinline__ int dswz(int r, int c) {
  return r * kBK32 + (((c >> 2) ^ (((r & 3) << 1) | ((r >> 2) & 1))) << 2) + (c & 3);
}

// 16- and 4-byte global -> shared copies; src_bytes < size zero-fills the rest
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int NT, bool HOT_T>
__global__ void __launch_bounds__(Tile32<NT>::kThreads, Tile32<NT>::kBlocksPerSM)
fused_dual_tf32x3_kernel(const float* __restrict__ d, const float* __restrict__ x,
                         const float* __restrict__ xh, int n, int k, int h, int vec_ok,
                         float* __restrict__ out, float* __restrict__ hot) {
  using T = Tile32<NT>;
  constexpr int BN = T::BN, LDX = T::LDX, NO = T::NO, NH = T::NH, OH = T::OH, HQ = T::HQ;
  constexpr int CW = 8 * NT;      // columns of x/xh/out a block covers
  constexpr int DT = BN * kBK32;  // floats of a D tile
  constexpr int XT = kBK32 * LDX; // floats of an xh tile
  constexpr int kT32 = T::kThreads;
  static_assert(kBK32 == 32 && T::MO * OH == T::W && 2 * HQ * T::RH == T::W,
                "warp tiling below");

  extern __shared__ __align__(16) float smem[];
  float* const d_ring = smem;                       // kStages D tiles
  float* const xh_ring = d_ring + kStages * DT;     // kStages xh tiles [kBK32][LDX]
  float* const xh_lo = xh_ring + kStages * XT;      // small halves of the current one
  float* const x_hi = xh_lo + XT;                   // [BN][LDX], big halves
  float* const x_lo = x_hi + BN * LDX;              // small halves

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * CW;
  const int ncols = min(CW, h - c0);  // live columns of the block
  const int nkt = (k + kBK32 - 1) / kBK32;
  // xh rows in 16-byte chunks (CW and c0 are multiples of 4)
  const bool xh_vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(xh) % 16 == 0;

  // one K tile of D and xh into ring slot `slot`, zero-filled past n, k, h
  auto copy_tile = [&](int kt, int slot) {
    const int k0 = kt * kBK32;
    float* const ds = d_ring + slot * DT;
    if (vec_ok) {
#pragma unroll
      for (int i = 0; i < DT / 4 / kT32; ++i) {
        const int ch = tid + i * kT32;
        const int r = ch / (kBK32 / 4), c = (ch % (kBK32 / 4)) * 4;
        const int row = r0 + r, col = k0 + c;
        const int bytes = row < n ? 4 * max(0, min(4, k - col)) : 0;
        cp_async16(ds + dswz(r, c), bytes ? d + (size_t)row * k + col : d, bytes);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < DT / kT32; ++i) {
        const int e = tid + i * kT32;
        const int r = e / kBK32, c = e % kBK32;
        const int row = r0 + r, col = k0 + c;
        const bool ok = row < n && col < k;
        cp_async4(ds + dswz(r, c), ok ? d + (size_t)row * k + col : d, ok ? 4 : 0);
      }
    }
    float* const xs = xh_ring + slot * XT;
    if (xh_vec) {
#pragma unroll 4
      for (int e = tid; e < kBK32 * CW / 4; e += kT32) {
        const int r = e / (CW / 4), c = (e % (CW / 4)) * 4;
        const int bytes = k0 + r < k ? 4 * max(0, min(4, ncols - c)) : 0;
        cp_async16(xs + r * LDX + c, bytes ? xh + (size_t)(k0 + r) * h + c0 + c : xh, bytes);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < kBK32 * CW; e += kT32) {
        const int r = e / CW, c = e % CW;
        const bool ok = k0 + r < k && c < ncols;
        cp_async4(xs + r * LDX + c, ok ? xh + (size_t)(k0 + r) * h + c0 + c : xh, ok ? 4 : 0);
      }
    }
  };

  if (nkt > 0) copy_tile(0, 0);
  cp_async_commit();
  // the block's slab of x, split once: x is an operand of every K tile
  for (int e = tid; e < BN * CW; e += kT32) {
    const int r = e / CW, c = e % CW;
    uint32_t big, small;
    split_tf32(r0 + r < n && c < ncols ? __ldg(x + (size_t)(r0 + r) * h + c0 + c) : 0.f, big,
               small);
    x_hi[r * LDX + c] = __uint_as_float(big);
    x_lo[r * LDX + c] = __uint_as_float(small);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  // out: rows 16 mo.. of the slab, column tiles oh, oh + OH, ...
  const int mo = warp % T::MO, oh = warp / T::MO;
  // hot: tile rows 16 mk.., column tiles hq, hq + HQ, ..., slab rows of part rh
  const int mk = warp & 1, hq = (warp >> 1) % HQ, rh = (warp >> 1) / HQ;
  float acc1[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc1[j][q] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<0>();  // this thread's copies of tile kt have landed
    __syncthreads();     // everyone's have, and tile kt - 1 is done with
    if (kt + 1 < nkt) copy_tile(kt + 1, (kt + 1) % kStages);
    cp_async_commit();
    const float* const ds = d_ring + (kt % kStages) * DT;
    float* const xs = xh_ring + (kt % kStages) * XT;
    // split the xh tile once for the warps that read each element: big
    // halves in place, small halves beside them
    for (int e = tid; e < kBK32 * CW; e += kT32) {
      const int i = (e / CW) * LDX + e % CW;
      uint32_t big, small;
      split_tf32(xs[i], big, small);
      xs[i] = __uint_as_float(big);
      xh_lo[i] = __uint_as_float(small);
    }
    __syncthreads();

    // out[16 mo.., :] += D[16 mo.., tile] @ xh[tile, :]
#pragma unroll
    for (int ks = 0; ks < kBK32 / 8; ++ks) {
      const int ra = 16 * mo + g, ca = 8 * ks + t;
      uint32_t ab[4], as[4];
      split_frag(ab, as, ds[dswz(ra, ca)], ds[dswz(ra + 8, ca)], ds[dswz(ra, ca + 4)],
                 ds[dswz(ra + 8, ca + 4)]);
      uint32_t bb[NO][2], bs[NO][2];
#pragma unroll
      for (int jj = 0; jj < NO; ++jj) {
        const int i = ca * LDX + 8 * min(oh + OH * jj, NT - 1) + g;
        bb[jj][0] = __float_as_uint(xs[i]);
        bb[jj][1] = __float_as_uint(xs[i + 4 * LDX]);
        bs[jj][0] = __float_as_uint(xh_lo[i]);
        bs[jj][1] = __float_as_uint(xh_lo[i + 4 * LDX]);
      }
      mma3_tf32(acc1, ab, as, bb, bs);
    }

    // hot[tile rows 16 mk.., :] = D^T @ x over the slab
    float acc2[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc2[j][q] = 0.f;
#pragma unroll
    for (int rs = 0; rs < BN / 8 / T::RH; ++rs) {
      const int ra = (BN / T::RH) * rh + 8 * rs + t, ca = 16 * mk + g;
      uint32_t ab[4], as[4];
      split_frag(ab, as, ds[dswz(ra, ca)], ds[dswz(ra, ca + 8)], ds[dswz(ra + 4, ca)],
                 ds[dswz(ra + 4, ca + 8)]);
      uint32_t bb[NH][2], bs[NH][2];
#pragma unroll
      for (int jj = 0; jj < NH; ++jj) {
        const int i = ra * LDX + 8 * min(hq + HQ * jj, NT - 1) + g;
        bb[jj][0] = __float_as_uint(x_hi[i]);
        bb[jj][1] = __float_as_uint(x_hi[i + 4 * LDX]);
        bs[jj][0] = __float_as_uint(x_lo[i]);
        bs[jj][1] = __float_as_uint(x_lo[i + 4 * LDX]);
      }
      mma3_tf32(acc2, ab, as, bb, bs);
    }
    if (HOT_T && hot != nullptr) {
      // [H, K]: the fragment's eight rows g are eight neighbours in K, so a
      // warp's atomic covers four 32-byte sectors
#pragma unroll
      for (int jj = 0; jj < NH; ++jj) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = kt * kBK32 + 16 * mk + g + (q >> 1) * 8;
          const int c = 8 * (hq + HQ * jj) + 2 * t + (q & 1);
          if (kk < k && c < ncols) atomicAdd(hot + (size_t)(c0 + c) * k + kk, acc2[jj][q]);
        }
      }
    } else if (hot != nullptr) {
      // [K, H]: the tile's partial, its two row parts summed, through xh's
      // slot and small halves (free once every warp is past out) as
      // [kBK32][ncols], then added to hot with coalesced atomics
      float* const part0 = xs;
      float* const part1 = xh_lo;
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < NH; ++jj) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kl = 16 * mk + g + (q >> 1) * 8, c = 8 * (hq + HQ * jj) + 2 * t + (q & 1);
          if (c < ncols) (rh ? part1 : part0)[kl * ncols + c] = acc2[jj][q];
        }
      }
      __syncthreads();
      const int k0 = kt * kBK32, span = min(kBK32, k - k0) * ncols;
      if (ncols == h) {  // the tile's rows of hot are one span, 16-byte aligned
        float* const dst = hot + (size_t)k0 * h;
        for (int i = 4 * tid; i + 3 < span; i += 4 * kT32) {
          const float4 u = *reinterpret_cast<const float4*>(part0 + i);
          const float4 v = *reinterpret_cast<const float4*>(part1 + i);
          atomicAdd(reinterpret_cast<float4*>(dst + i),
                    make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w));
        }
        for (int i = (span & ~3) + tid; i < span; i += kT32)
          atomicAdd(dst + i, part0[i] + part1[i]);
      } else {  // H cut into column blocks
        for (int i = tid; i < span; i += kT32)
          atomicAdd(hot + (size_t)(k0 + i / ncols) * h + c0 + i % ncols, part0[i] + part1[i]);
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < NO; ++jj) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + 16 * mo + g + (q >> 1) * 8;
      const int c = 8 * (oh + OH * jj) + 2 * t + (q & 1);
      if (row < n && c < ncols) out[(size_t)row * h + c0 + c] = acc1[jj][q];
    }
  }
}

template <int NT, bool HOT_T>
cudaError_t launch_tf32x3(const float* d, const float* x, const float* xh, int n, int k, int h,
                          int vec_ok, float* out, float* hot, cudaStream_t s) {
  constexpr size_t smem = Tile32<NT>::kSmem;
  auto kern = fused_dual_tf32x3_kernel<NT, HOT_T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  constexpr int BN = Tile32<NT>::BN;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((h + 8 * NT - 1) / (8 * NT)));
  kern<<<grid, Tile32<NT>::kThreads, smem, s>>>(d, x, xh, n, k, h, vec_ok, out, hot);
  return cudaGetLastError();
}

// NT: 6 column tiles up to H = 48 (the 43 classes), else 13 (hidden 100)
// with a column block per 104 columns
cudaError_t dispatch_tf32x3(int hot_t, const float* d, const float* x, const float* xh, int n,
                            int k, int h, int vec_ok, float* out, float* hot, cudaStream_t s) {
#define FD_LAUNCH(NT, HT) launch_tf32x3<NT, HT>(d, x, xh, n, k, h, vec_ok, out, hot, s)
  if (h <= 48) return hot_t ? FD_LAUNCH(6, true) : FD_LAUNCH(6, false);
  return hot_t ? FD_LAUNCH(13, true) : FD_LAUNCH(13, false);
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
    return (int)dispatch_tf32x3(hot_t, static_cast<const float*>(d_hi),
                                static_cast<const float*>(x), static_cast<const float*>(xh),
                                n, k, h, vec_ok, out, hot, s);
  return (int)cudaErrorInvalidValue;
}
