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
//     50 MB L2) with atomics. The order of those additions differs from
//     run to run, so hot varies in its last bits between runs; checks scale
//     their tolerance by |D|^T @ |x| instead of asking for equal bits.
//   * N, K and H are masked in the kernel (zero-filled copies, masked stores
//     and atomics), so any shape runs: no padding of D, no tiny-K fallback.
//     Wide H takes more column blocks (blockIdx.y), each reading D again.
//
// kSplit and kBf16 (fused_dual_bf16_kernel): bf16 mma.sync.m16n8k16 with f32
// accumulation, fed by ldmatrix (.trans for D^T and for the row-major x and
// xh). x and xh reach the kernel as bf16 planes made once per launch by
// fused_dual_prologue (split into hi and lo for kSplit, as
// ops/fused_dual.py::split_bf16 and the JAX _call_split do it outside the
// Pallas kernel; copied for kBf16), each row padded with zeros to a multiple
// of 8 elements so that every row starts on 16 bytes. One block of 16 warps
// a SM owns 128 rows; 32-column K tiles of D and xh through a three-stage
// cp.async ring, the x slab copied once. The D tile is XOR-swizzled so that
// both of its ldmatrix reads ([row][k] for D @ xh, .trans for D^T @ x) are
// free of bank conflicts. Eight warps compute out, eight the hot side: each
// hot warp sums its fragments of the K tile's [32, H] partial over all 128
// rows (x's fragments stay in its registers for kBf16), so each element of
// the partial is written to shared memory once, and the partial is added to
// hot by one asynchronous bulk reduction (cp.reduce.async.bulk). Summing
// four row parts of the partial in shared memory instead cost more than
// all the mma (PERF.md).
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
// D pair (kSplit) or the f32 D is 1,277 MB, the bf16 D of kBf16 638 MB;
// with x, xh, out and hot at H = 100 that is 1,342 MB (0.40 ms at
// 3.35 TB/s) and 674 MB (0.20 ms). The operations: kSplit runs
// 3 x 2 x 2*N*K*H = 383 GFLOP at H = 100 (165 at H = 43), 0.39 ms at
// 989 TFLOP/s dense bf16, kBf16 a third of that; kF32 the same count as
// kSplit in TF32 at 495 TFLOP/s, 0.77 ms at H = 100 (by operations) and
// 0.33 ms at H = 43 (bytes bound it, 0.39 ms). mma.sync does not reach
// those peaks (wgmma does); what limits each variant is in PERF.md.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant { kSplit = 0, kBf16 = 1, kF32 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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
  asm(
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
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
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

// ------------------------------------------------------- kSplit and kBf16
// One bf16 mma.sync.m16n8k16 pass (kBf16) or three (kSplit: D_hi * B_lo,
// D_lo * B_hi, then D_hi * B_hi; lo * lo, ~2^-18 of |D| @ |x|, is dropped).
// A block owns a slab of BN rows of D and walks K in kBK16-column tiles
// through a kStages16-stage ring of cp.async copies.

// Timing builds only (chip_smoke.py phase 9 compiles them beside the real
// one): FD_SPLIT_PASSES=1 runs kSplit's hi * hi pass alone. It is not
// split2-class; it shows what kSplit's two extra passes cost.
// FD_HOT_ATOMICS adds the [K, H] hot partial as float4 atomics instead of
// the bulk reduction (same result); it shows what the bulk reduction saves.
#ifndef FD_SPLIT_PASSES
#define FD_SPLIT_PASSES 3
#endif

constexpr int kBK16 = 32;     // columns of D per K step: two mma k-steps
constexpr int kStages16 = 3;  // cp.async ring depth (4 to 6 timed no faster)
constexpr int kHotBufs = 2;   // hot partial buffers, used in turn (3 or 4: no faster)

// The tiling for NT column tiles of 8 (instantiated at NT = 6 and 14): P
// bf16 planes of each operand (hi and lo for kSplit); one block of 16 warps
// a SM owns BN = 128 rows of D. Warps 0-7 compute out, each a 32 x 8 NW
// warp tile (two m-tiles of 16 rows by NW = NT / 2 column tiles) summed
// over all of K, so every A fragment serves NW mma and every B fragment
// two. Warps 8-15 compute the K tile's hot partial, each an m-tile of 16 K
// rows by NH column tiles (HQ column groups) summed over all BN rows of the
// slab, so that each element of the partial is written once. LDX, the row
// stride of the x and xh tiles, is 8 * NT rounded up to an odd multiple of
// 8, so the eight 16-byte rows an ldmatrix reads hit eight bank groups.
template <int V, int NT>
struct Tile16 {
  static constexpr int P = V == kSplit ? 2 : 1;
  static constexpr int BN = 128, kThreads = 512, NW = NT / 2, HQ = 4, NH = (NT + HQ - 1) / HQ;
  static constexpr int LDX = 8 * (NT | 1);
  static constexpr int DT = BN * kBK16;   // elements of a D tile plane
  static constexpr int XT = kBK16 * LDX;  // of an xh tile plane
  static_assert(kBK16 == 32 && NT % 2 == 0 && NH <= NW, "warp tiling below");
  // the ring (D and xh tiles) and the x slab in bf16, the hot partials in f32
  static constexpr size_t kSmem = 2 * (size_t)(kStages16 * P * (DT + XT) + P * BN * LDX) +
                                  4 * (size_t)kHotBufs * kBK16 * 8 * NT;
};

// D tile [BN][kBK16] bf16 with the four 16-byte chunks of row r XOR-ed by
// (r >> 1) & 3. Both reads of D (ldmatrix for D @ xh, ldmatrix.trans for
// D^T @ x) take one chunk of eight consecutive rows, which then lie in
// eight different bank groups.
__device__ __forceinline__ int dswz16(int r, int c) {
  return r * kBK16 + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

// Asynchronous bulk reduction (the TMA unit): global[dst..] += shared[src..]
// element by element in f32, `bytes` a multiple of 16, both 16-byte aligned.
// Shared-memory writes must be made visible to it by fence_proxy_async().
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N bulk groups still read shared memory / are pending
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier for the `threads` threads of warps that call it with this id
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int V, int NT, bool HOT_T>
__global__ void __launch_bounds__(Tile16<V, NT>::kThreads, 1)
fused_dual_bf16_kernel(const __nv_bfloat16* __restrict__ d_hi,
                       const __nv_bfloat16* __restrict__ d_lo,
                       const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ xh,
                       int n, int k, int h, int vec_ok, float* __restrict__ out,
                       float* __restrict__ hot) {
  using T = Tile16<V, NT>;
  using bf16 = __nv_bfloat16;
  constexpr int P = T::P, BN = T::BN, LDX = T::LDX, NW = T::NW, HQ = T::HQ, NH = T::NH;
  constexpr int DT = T::DT, XT = T::XT, kT = T::kThreads;
  constexpr int CW = 8 * NT;                // columns of x/xh/out a block covers
  constexpr int kHot = kT / 2;              // threads of the hot warps
  constexpr int PART = kBK16 * CW;          // floats of a tile's hot partial

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const d_ring = reinterpret_cast<bf16*>(smem_raw);  // [kStages16][P][DT]
  bf16* const xh_ring = d_ring + kStages16 * P * DT;       // [kStages16][P][kBK16][LDX]
  bf16* const x_s = xh_ring + kStages16 * P * XT;          // [P][BN][LDX]
  // the hot partial: kHotBufs buffers, one a tile in turn
  float* const part = reinterpret_cast<float*>(x_s + P * BN * LDX);  // [kHotBufs][PART]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * CW;
  const int hp = (h + 7) & ~7;        // row stride of the x and xh planes
  const int ncols = min(CW, h - c0);  // live columns of the block
  const int nkt = (k + kBK16 - 1) / kBK16;
  // blocks start at different K tiles, so the blocks in flight read
  // different tiles of xh and add to different rows of hot (timed a few %
  // faster than all blocks in lockstep)
  const int kt0 = nkt > 0 ? blockIdx.x % nkt : 0;
  auto tile_at = [&](int i) { return kt0 + i < nkt ? kt0 + i : kt0 + i - nkt; };
  const bf16* const d_pl[2] = {d_hi, P == 2 ? d_lo : d_hi};

  // one K tile of D and xh, every plane, into ring slot `slot`; zero-filled
  // past n, k and the planes' padded width
  auto copy_tile = [&](int kt, int slot) {
    const int k0 = kt * kBK16;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      bf16* const ds = d_ring + (slot * P + p) * DT;
      const bf16* const dg = d_pl[p];
      if (vec_ok) {  // k is a multiple of 8, so a chunk is all in or all out
#pragma unroll
        for (int i = 0; i < DT / 8 / kT; ++i) {
          const int ch = tid + i * kT;
          const int r = ch / (kBK16 / 8), c = (ch % (kBK16 / 8)) * 8;
          const bool ok = r0 + r < n && k0 + c < k;
          cp_async16(ds + dswz16(r, c), ok ? dg + (size_t)(r0 + r) * k + k0 + c : dg,
                     ok ? 16 : 0);
        }
      } else {  // rows of D off 16-byte boundaries: element by element
        const unsigned short* const dg16 = reinterpret_cast<const unsigned short*>(dg);
        unsigned short* const ds16 = reinterpret_cast<unsigned short*>(ds);
#pragma unroll 4
        for (int i = 0; i < DT / kT; ++i) {
          const int e = tid + i * kT;
          const int r = e / kBK16, c = e % kBK16;
          const bool ok = r0 + r < n && k0 + c < k;
          ds16[dswz16(r, c)] =
              ok ? __ldg(dg16 + (size_t)(r0 + r) * k + k0 + c) : (unsigned short)0;
        }
      }
      bf16* const xs = xh_ring + (slot * P + p) * XT;
      const bf16* const xg = xh + (size_t)p * k * hp;
      for (int e = tid; e < kBK16 * (CW / 8); e += kT) {
        const int r = e / (CW / 8), c = (e % (CW / 8)) * 8;
        const bool ok = k0 + r < k && c0 + c < hp;
        cp_async16(xs + r * LDX + c, ok ? xg + (size_t)(k0 + r) * hp + c0 + c : xg,
                   ok ? 16 : 0);
      }
    }
  };

  // the block's slab of x, every plane, once: x is an operand of every K tile
  for (int e = tid; e < P * BN * (CW / 8); e += kT) {
    const int p = e / (BN * (CW / 8)), r = e / (CW / 8) % BN, c = e % (CW / 8) * 8;
    const bool ok = r0 + r < n && c0 + c < hp;
    const bf16* const xg = x + (size_t)p * n * hp;
    cp_async16(x_s + (p * BN + r) * LDX + c, ok ? xg + (size_t)(r0 + r) * hp + c0 + c : xg,
               ok ? 16 : 0);
  }
#pragma unroll
  for (int s = 0; s < kStages16 - 1; ++s) {
    if (s < nkt) copy_tile(tile_at(s), s);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const bool is_hot = warp >= 8;
  // out warps: slab rows 32 rg.., column tiles NW cg.. (two m-tiles by NW)
  const int rg = warp & 3, cg = (warp & 7) >> 2;
  // hot warps: the K tile's rows 16 mk.., column tiles hq, hq + HQ, ... (a
  // tile past NT repeats tile NT - 1 and is not stored), over all BN rows
  const int mk = warp & 1, hq = (warp & 7) >> 1;
  // the row and column in a 16 x 16 block that this lane gives ldmatrix.x4:
  // an A fragment of D @ xh (matrices: rows 0-7 | 8-15, then k 0-7 | 8-15)
  // and, .trans, of D^T @ x (matrices: D columns 0-7 | 8-15, then D rows)
  const int la_r = (lane & 7) + ((lane >> 3) & 1) * 8, la_c = (lane >> 4) * 8;
  const int lt_r = (lane & 7) + ((lane >> 4) & 1) * 8, lt_c = ((lane >> 3) & 1) * 8;

  // the K loop of either role: wait for tile i, refill the ring, run body on
  // it. Both roles pass the same __syncthreads, one a tile.
  auto k_loop = [&](auto&& body) {
    for (int i = 0; i < nkt; ++i) {
      cp_async_wait<kStages16 - 2>();  // this thread's copies of tile i have landed
      __syncthreads();                 // everyone's have, and tile i - 1 is done with
      if (i + kStages16 - 1 < nkt)
        copy_tile(tile_at(i + kStages16 - 1), (i + kStages16 - 1) % kStages16);
      cp_async_commit();
      body(i, d_ring + (i % kStages16) * P * DT, xh_ring + (i % kStages16) * P * XT);
    }
    cp_async_wait<0>();
  };

  if (!is_hot) {
    // out[32 rg + 16 m.., tiles NW cg + j], summed over all of K
    float acc[2][NW][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
    k_loop([&](int, const bf16* ds, const bf16* xs) {
      xs += (lane & 15) * LDX;
#pragma unroll
      for (int ks = 0; ks < kBK16 / 16; ++ks) {
        uint32_t a[2][P][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int p = 0; p < P; ++p)
            ldsm_x4(a[m][p], ds + p * DT + dswz16(32 * rg + 16 * m + la_r, 16 * ks + la_c));
        // every tile's B fragment first, then the mma pass by pass: 2 NW
        // independent mma between two on one accumulator
        uint32_t b[NW][P][2];
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int p = 0; p < P; ++p)
            ldsm_x2_t(b[j][p], xs + p * XT + 16 * ks * LDX + 8 * (NW * cg + j));
        if constexpr (P == 2 && FD_SPLIT_PASSES == 3) {
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int m = 0; m < 2; ++m) mma(acc[m][j], a[m][0], b[j][1][0], b[j][1][1]);
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int m = 0; m < 2; ++m) mma(acc[m][j], a[m][1], b[j][0][0], b[j][0][1]);
        }
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma(acc[m][j], a[m][0], b[j][0][0], b[j][0][1]);
      }
    });
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = r0 + 32 * rg + 16 * m + g + (q >> 1) * 8;
          const int c = 8 * (NW * cg + j) + 2 * t + (q & 1);
          if (row < n && c < ncols) out[(size_t)row * h + c0 + c] = acc[m][j][q];
        }
    return;
  }

  // hot warps: each K tile's hot[16 mk.., tiles hq + HQ jj] = D^T @ x over
  // the slab. With one plane (kBf16) the x fragments are the same for every
  // tile and stay in registers (NH * BN / 16 * 2 of them).
  constexpr bool kXRegs = P == 1;
  constexpr int XR = kXRegs ? NH : 1, XK = kXRegs ? BN / 16 : 1;
  uint32_t xr[XR][XK][2];
  const int ht = tid - kHot;
  k_loop([&](int i, const bf16* ds, const bf16*) {
    if constexpr (kXRegs) {
      if (i == 0) {
#pragma unroll
        for (int jj = 0; jj < NH; ++jj)
#pragma unroll
          for (int ks = 0; ks < BN / 16; ++ks)
            ldsm_x2_t(xr[jj][ks], x_s + (16 * ks + (lane & 15)) * LDX +
                                      8 * min(hq + HQ * jj, NT - 1));
      }
    }
    // two accumulators a tile, by the parity of the k-step, for more
    // independent mma
    float acc[2][NH][4];
#pragma unroll
    for (int par = 0; par < 2; ++par)
#pragma unroll
      for (int jj = 0; jj < NH; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[par][jj][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      uint32_t a[P][4], b[NH][P][2];
#pragma unroll
      for (int p = 0; p < P; ++p)
        ldsm_x4_t(a[p], ds + p * DT + dswz16(16 * ks + lt_r, 16 * mk + lt_c));
#pragma unroll
      for (int jj = 0; jj < NH; ++jj) {
        if constexpr (kXRegs) {
          b[jj][0][0] = xr[jj][ks][0];
          b[jj][0][1] = xr[jj][ks][1];
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p)
            ldsm_x2_t(b[jj][p], x_s + (p * BN + 16 * ks + (lane & 15)) * LDX +
                                    8 * min(hq + HQ * jj, NT - 1));
        }
      }
      float (&c)[NH][4] = acc[ks & 1];
      if constexpr (P == 2 && FD_SPLIT_PASSES == 3) {
#pragma unroll
        for (int jj = 0; jj < NH; ++jj) mma(c[jj], a[0], b[jj][1][0], b[jj][1][1]);
#pragma unroll
        for (int jj = 0; jj < NH; ++jj) mma(c[jj], a[1], b[jj][0][0], b[jj][0][1]);
      }
#pragma unroll
      for (int jj = 0; jj < NH; ++jj) mma(c[jj], a[0], b[jj][0][0], b[jj][0][1]);
    }
    if (hot == nullptr) return;
    // the tile's partial as [kBK16][ncols], each element written once, into
    // the buffer of the tile's parity
    const int kt = tile_at(i);
    float* const sum_buf = part + (i % kHotBufs) * PART;
#pragma unroll
    for (int jj = 0; jj < NH; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kl = 16 * mk + g + (q >> 1) * 8, c = 8 * (hq + HQ * jj) + 2 * t + (q & 1);
        if (c < ncols) sum_buf[kl * ncols + c] = acc[0][jj][q] + acc[1][jj][q];
      }
    fence_proxy_async();  // the bulk reduction reads through the async proxy
    bar_sync(1, kHot);    // the hot warps' own barrier: the out warps go on
    const int k0 = kt * kBK16, rows = min(kBK16, k - k0), span = rows * ncols;
    if (!HOT_T && ncols == h) {
      // [K, H] with one column block: the tile's rows of hot are one span,
      // 16-byte aligned, added by one asynchronous bulk reduction issued by
      // one thread (the L2 takes it faster than the span's float4 atomics:
      // PERF.md); a tail of < 4 floats by atomics
      const int whole = span & ~3;
#ifdef FD_HOT_ATOMICS
      float* const dst = hot + (size_t)k0 * h;
      for (int e = 4 * ht; e < whole; e += 4 * kHot)
        atomicAdd(reinterpret_cast<float4*>(dst + e),
                  *reinterpret_cast<const float4*>(sum_buf + e));
#else
      if (ht == 0) {
        if (whole > 0) {
          bulk_reduce_add(hot + (size_t)k0 * h, sum_buf, 4 * whole);
          bulk_commit();
          bulk_wait_read<kHotBufs - 1>();  // the next tile's buffer is free again
        } else {
          bulk_wait_read<0>();
        }
      }
#endif
      if (ht < span - whole) atomicAdd(hot + (size_t)k0 * h + whole + ht, sum_buf[whole + ht]);
    } else if (HOT_T) {  // [H, K]: neighbours in K on neighbouring threads
      for (int e = ht; e < span; e += kHot) {
        const int c = e / rows, kl = e % rows;
        atomicAdd(hot + (size_t)(c0 + c) * k + k0 + kl, sum_buf[kl * ncols + c]);
      }
    } else {  // H cut into column blocks
      for (int e = ht; e < span; e += kHot)
        atomicAdd(hot + (size_t)(k0 + e / ncols) * h + c0 + e % ncols, sum_buf[e]);
    }
  });
  if (ht == 0) bulk_wait<0>();  // the bulk reductions are done with shared memory
}

template <int V, int NT, bool HOT_T>
cudaError_t launch_bf16(const void* d_hi, const void* d_lo, const void* x, const void* xh, int n,
                        int k, int h, int vec_ok, float* out, float* hot, cudaStream_t s) {
  using T = Tile16<V, NT>;
  using bf16 = __nv_bfloat16;
  auto kern = fused_dual_bf16_kernel<V, NT, HOT_T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + T::BN - 1) / T::BN), (unsigned)((h + 8 * NT - 1) / (8 * NT)));
  kern<<<grid, T::kThreads, T::kSmem, s>>>(
      static_cast<const bf16*>(d_hi), static_cast<const bf16*>(d_lo),
      static_cast<const bf16*>(x), static_cast<const bf16*>(xh), n, k, h, vec_ok, out, hot);
  return cudaGetLastError();
}

// NT: 6 column tiles up to H = 48 (the 43 classes), else 14 (hidden 100)
// with a column block per 112 columns
template <int V>
cudaError_t dispatch_bf16(int hot_t, const void* d_hi, const void* d_lo, const void* x,
                          const void* xh, int n, int k, int h, int vec_ok, float* out,
                          float* hot, cudaStream_t s) {
#define FD_LAUNCH(NT, HT) launch_bf16<V, NT, HT>(d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot, s)
  if (h <= 48) return hot_t ? FD_LAUNCH(6, true) : FD_LAUNCH(6, false);
  return hot_t ? FD_LAUNCH(14, true) : FD_LAUNCH(14, false);
#undef FD_LAUNCH
}

// The prologue of kSplit and kBf16: x or xh [rows, h] into P bf16 planes
// [P][rows][hp], hp = h rounded up to a multiple of 8, zeros past h. kSplit
// (f32 source): hi = bf16(v) and lo = bf16(v - hi), each rounded to nearest
// even (ops/fused_dual.py::split_bf16; v - hi is exact in f32). kBf16 (bf16
// source): a copy. A thread makes one 16-byte chunk of each plane.
template <int V>
__global__ void __launch_bounds__(256)
fused_dual_prologue_kernel(const void* __restrict__ src, int rows, int h, int hp,
                           __nv_bfloat16* __restrict__ dst) {
  const int cpr = hp / 8;  // chunks a row
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * cpr) return;
  const int r = (int)(i / cpr), c = (int)(i % cpr) * 8;
  alignas(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool ok = c + e < h;
    const size_t at = (size_t)r * h + c + e;
    if constexpr (V == kSplit) {
      const float v = ok ? __ldg(static_cast<const float*>(src) + at) : 0.f;
      hi[e] = __float2bfloat16_rn(v);
      lo[e] = __float2bfloat16_rn(v - __bfloat162float(hi[e]));
    } else {
      hi[e] = __ushort_as_bfloat16(
          ok ? __ldg(static_cast<const unsigned short*>(src) + at) : (unsigned short)0);
    }
  }
  const size_t off = (size_t)r * hp + c;
  *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(hi);
  if constexpr (V == kSplit)
    *reinterpret_cast<uint4*>(dst + (size_t)rows * hp + off) = *reinterpret_cast<const uint4*>(lo);
}

}  // namespace

// The prologue of variants 0 (split: src f32) and 1 (bf16: src bf16): src
// [rows, h] contiguous into dst, P = 2 (split) or 1 bf16 planes [rows, hp]
// one after the other, hp = h rounded up to a multiple of 8 (see
// fused_dual_prologue_kernel). dst is written whole. Returns a cudaError_t.
extern "C" int fused_dual_prologue(int variant, const void* src, int rows, int h, void* dst,
                                   void* stream) {
  if (rows <= 0 || h <= 0) return (int)cudaSuccess;
  const int hp = (h + 7) & ~7;
  const unsigned blocks = (unsigned)(((long long)rows * (hp / 8) + 255) / 256);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* const d = static_cast<__nv_bfloat16*>(dst);
  if (variant == kSplit)
    fused_dual_prologue_kernel<kSplit><<<blocks, 256, 0, s>>>(src, rows, h, hp, d);
  else if (variant == kBf16)
    fused_dual_prologue_kernel<kBf16><<<blocks, 256, 0, s>>>(src, rows, h, hp, d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// variant: 0 = split (d_hi, d_lo bf16; x and xh the prologue's hi and lo
// planes), 1 = bf16 (d_hi bf16; x and xh the prologue's one plane), 2 = f32
// (d_hi, x, xh f32, contiguous). D is [n, k], x [n, h], xh [k, h]; out
// [n, h] f32 is written whole; hot is f32, [k, h] (hot_t 0) or [h, k]
// (hot_t 1), and must be zeroed by the caller. A null hot skips the hot
// side's atomics (its product is still computed): chip_smoke.py times the
// kernel so to see what the atomics cost. vec_ok: k and the D pointers
// allow 16-byte copies of D rows. Returns a cudaError_t as int.
extern "C" int fused_dual_launch(int variant, int hot_t, const void* d_hi, const void* d_lo,
                                 const void* x, const void* xh, int n, int k, int h,
                                 int vec_ok, float* out, float* hot, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kSplit)
    return (int)dispatch_bf16<kSplit>(hot_t, d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot, s);
  if (variant == kBf16)
    return (int)dispatch_bf16<kBf16>(hot_t, d_hi, d_lo, x, xh, n, k, h, vec_ok, out, hot, s);
  if (variant == kF32)
    return (int)dispatch_tf32x3(hot_t, static_cast<const float*>(d_hi),
                                static_cast<const float*>(x), static_cast<const float*>(xh),
                                n, k, h, vec_ok, out, hot, s);
  return (int)cudaErrorInvalidValue;
}
