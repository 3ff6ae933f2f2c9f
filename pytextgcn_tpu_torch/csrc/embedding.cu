// EGCN's embedding activation, dropout(selu(W + b)), as one pass each way for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the embedding's activation
// (pytextgcn_tpu/models/gcn.py::EGCN) to XLA, which fuses it. In the port,
// with identity features the embedding is W + b over [N, E] (N = 77,923, E =
// 2000 on the Amazon graph: 623 MB a pass), and torch runs bias, SELU and
// dropout eagerly as ten passes an epoch: the add, SELU, the compare, the
// multiply by 1 / keep and torch.where in the train step, the where, the
// multiply and SELU's backward in its backward, the add and SELU again in the
// evaluation, plus a fill and a copy under the slice of W.
//
// What bounds it on an H100: bytes. The forward reads W and the dropout's
// uniforms u once and writes h and a keep mask of one bit an element; the
// backward reads dh, W and the mask and writes dW; the evaluation reads W and
// writes selu(W + b). 12 + 12 + 8 bytes an element and 1/8 for each touch of
// the mask: 5.0 GB an epoch at EGCN's shape, 1.5 ms at 3.35 TB/s. What the
// design does about it:
//
//   * 16-byte vectors, neighbouring threads on neighbouring vectors over the
//     flat [N * E] array, kUnroll vectors of each stream in flight a thread,
//     and a block for every kThreads * kUnroll vectors. That grid measured
//     6-7% faster than as many blocks as stay resident grid-striding, and
//     on it kUnroll 2 faster than 3 or 4 (0.656 / 0.639 / 0.425 ms against
//     0.707 / 0.681 / 0.459 for the three launches at EGCN's shape, H100).
//   * The streams read once (W, u, dh) are loaded evict-first (ld.global.cs).
//   * The bias (E floats, 8 KB) stays in L1: one float4 a vector when E is a
//     multiple of 4, else four scalar loads whose columns wrap at E. A
//     thread's column advances by a fixed step each pass, with no division.
//   * The mask is packed by warp ballots: the 32 vectors (128 elements) a warp
//     covers in one pass give 4 words, word k holding element k of each lane's
//     vector, stored as one uint4 by lane 0 and read back the same way. The
//     last n % 4 elements (a width not a multiple of 4) take a scalar tail,
//     their bits in one word after the vectors' (ops/embedding.py::pack).
//   * The wrapper hands over contiguous tensors aligned to 16 bytes.
//
// Arithmetic: the eager composition's, op for op in float32, each rounding
// pinned by an intrinsic so nothing is contracted:
//
//   x  = w + b                                  add
//   s  = x > 0 ? x * scale : expm1(x) * (alpha * scale)
//                                               ATen's elu_kernel (SELU)
//   h  = u < keep ? s * (1 / keep) : 0          the compare, x / keep as ATen
//                                               runs it (a multiply by the
//                                               float reciprocal), where
//   g  = m ? dh : 0; g = g * (1 / keep)         where's and div's backward
//   dx = x <= 0 ? g * 1 * (alpha * scale) * exp(x) : g * scale
//                                               ATen's elu_backward_kernel
//
// with scale and alpha torch's SELU constants rounded to float and their
// product formed in float, as ATen forms them. dW is dx; the bias's gradient
// is torch's column sum of it (the wrapper). The uniforms come from torch's
// generator, so the kernels draw nothing.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() after their launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors of each stream a thread has in flight

// ATen/native/Activation.cpp's SELU_ALPHA and SELU_SCALE (doubles), rounded
// to float as elu_kernel's Scalar::to<float> rounds them
constexpr float kScale = static_cast<float>(1.0507009873554804934193349852946);
constexpr float kAlpha = static_cast<float>(1.6732632423543772848170429916717);

struct Consts {
  float scale;    // SELU's scale
  float negcoef;  // alpha * scale, in float
  float keep;     // 1 - rate, rounded to float: the compare's threshold
  float inv_keep; // 1 / keep in float: x / keep as ATen runs it
};

__device__ __forceinline__ float selu(float x, const Consts& c) {
  return x > 0.0f ? __fmul_rn(x, c.scale) : __fmul_rn(expm1f(x), c.negcoef);
}

__device__ __forceinline__ float selu_grad(float g, float x, const Consts& c) {
  return x <= 0.0f ? __fmul_rn(__fmul_rn(g, c.negcoef), expf(x)) : __fmul_rn(g, c.scale);
}

// The bias of the 4 elements from column col on, wrapping at e.
template <bool kVec>
__device__ __forceinline__ float4 bias4(const float* __restrict__ b, int col, int e) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(b + col));
  float4 r;
  r.x = __ldg(b + col);
  col = col + 1 == e ? 0 : col + 1;
  r.y = __ldg(b + col);
  col = col + 1 == e ? 0 : col + 1;
  r.z = __ldg(b + col);
  col = col + 1 == e ? 0 : col + 1;
  r.w = __ldg(b + col);
  return r;
}

// The column of element 4 * j of each of a thread's slots, and the step it
// advances by each pass, on a grid of `stride` threads starting at `first`.
struct Cols {
  int col[kUnroll];
  int step;
  __device__ Cols(long long first, long long stride, int e) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) col[k] = static_cast<int>((4 * (first + k * stride)) % e);
    step = static_cast<int>((4 * stride * kUnroll) % e);
  }
  __device__ __forceinline__ void advance(int k, int e) {
    col[k] += step;
    if (col[k] >= e) col[k] -= e;
  }
};

// kTrain: h = dropout(selu(w + b)) and its keep mask from u; else selu(w + b).
// The loop's test is the warp's first vector, so a warp's lanes run every pass
// together and can ballot.
template <bool kTrain, bool kVec>
__global__ void __launch_bounds__(kThreads)
    embedding_forward_kernel(const float* __restrict__ w, const float* __restrict__ b,
                             const float* __restrict__ u, float* __restrict__ h,
                             uint32_t* __restrict__ mask, long long n, int e, Consts c) {
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n4 = n / 4;
  Cols cols(first, stride, e);
  for (long long i = first; i - lane < n4; i += stride * kUnroll) {
    float4 W[kUnroll] = {}, U[kUnroll] = {};
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + k * stride;
      if (j < n4) {
        W[k] = __ldcs(reinterpret_cast<const float4*>(w) + j);
        if (kTrain) U[k] = __ldcs(reinterpret_cast<const float4*>(u) + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + k * stride;
      const bool valid = j < n4;
      const float4 B = bias4<kVec>(b, cols.col[k], e);
      cols.advance(k, e);
      float4 H = make_float4(selu(__fadd_rn(W[k].x, B.x), c), selu(__fadd_rn(W[k].y, B.y), c),
                             selu(__fadd_rn(W[k].z, B.z), c), selu(__fadd_rn(W[k].w, B.w), c));
      if (kTrain) {
        const bool k0 = U[k].x < c.keep, k1 = U[k].y < c.keep, k2 = U[k].z < c.keep,
                   k3 = U[k].w < c.keep;
        H.x = k0 ? __fmul_rn(H.x, c.inv_keep) : 0.0f;
        H.y = k1 ? __fmul_rn(H.y, c.inv_keep) : 0.0f;
        H.z = k2 ? __fmul_rn(H.z, c.inv_keep) : 0.0f;
        H.w = k3 ? __fmul_rn(H.w, c.inv_keep) : 0.0f;
        const uint4 bits = make_uint4(__ballot_sync(0xffffffffu, valid && k0),
                                      __ballot_sync(0xffffffffu, valid && k1),
                                      __ballot_sync(0xffffffffu, valid && k2),
                                      __ballot_sync(0xffffffffu, valid && k3));
        if (lane == 0 && j < n4) reinterpret_cast<uint4*>(mask)[j >> 5] = bits;
      }
      if (valid) reinterpret_cast<float4*>(h)[j] = H;
    }
  }
  // the scalar tail: at most 3 elements, their mask bits in one word, which
  // is written (0 without a tail) so that every word of the mask is defined
  if (first == 0 && (kTrain || 4 * n4 < n)) {
    uint32_t bits = 0;
    for (long long t = 4 * n4; t < n; ++t) {
      float s = selu(__fadd_rn(w[t], b[t % e]), c);
      if (kTrain) {
        const bool kt = u[t] < c.keep;
        s = kt ? __fmul_rn(s, c.inv_keep) : 0.0f;
        bits |= static_cast<uint32_t>(kt) << (t - 4 * n4);
      }
      h[t] = s;
    }
    if (kTrain) mask[4 * ((n4 + 31) / 32)] = bits;
  }
}

// kMask: dw = selu'(w + b) * dropout's backward of dh under the mask; else
// selu'(w + b) * dh.
template <bool kMask, bool kVec>
__global__ void __launch_bounds__(kThreads)
    embedding_backward_kernel(const float* __restrict__ dh, const float* __restrict__ w,
                              const float* __restrict__ b, const uint32_t* __restrict__ mask,
                              float* __restrict__ dw, long long n, int e, Consts c) {
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n4 = n / 4;
  Cols cols(first, stride, e);
  for (long long i = first; i - lane < n4; i += stride * kUnroll) {
    float4 G[kUnroll] = {}, W[kUnroll] = {};
    uint4 M[kUnroll] = {};
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + k * stride;
      if (j < n4) {
        G[k] = __ldcs(reinterpret_cast<const float4*>(dh) + j);
        W[k] = __ldcs(reinterpret_cast<const float4*>(w) + j);
        if (kMask) M[k] = __ldg(reinterpret_cast<const uint4*>(mask) + (j >> 5));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + k * stride;
      const float4 B = bias4<kVec>(b, cols.col[k], e);
      cols.advance(k, e);
      if (j >= n4) continue;
      float4 g = G[k];
      if (kMask) {
        g.x = __fmul_rn((M[k].x >> lane) & 1 ? g.x : 0.0f, c.inv_keep);
        g.y = __fmul_rn((M[k].y >> lane) & 1 ? g.y : 0.0f, c.inv_keep);
        g.z = __fmul_rn((M[k].z >> lane) & 1 ? g.z : 0.0f, c.inv_keep);
        g.w = __fmul_rn((M[k].w >> lane) & 1 ? g.w : 0.0f, c.inv_keep);
      }
      reinterpret_cast<float4*>(dw)[j] = make_float4(
          selu_grad(g.x, __fadd_rn(W[k].x, B.x), c), selu_grad(g.y, __fadd_rn(W[k].y, B.y), c),
          selu_grad(g.z, __fadd_rn(W[k].z, B.z), c), selu_grad(g.w, __fadd_rn(W[k].w, B.w), c));
    }
  }
  if (first == 0 && 4 * n4 < n) {
    const uint32_t bits = kMask ? mask[4 * ((n4 + 31) / 32)] : 0;
    for (long long t = 4 * n4; t < n; ++t) {
      float g = dh[t];
      if (kMask) g = __fmul_rn((bits >> (t - 4 * n4)) & 1 ? g : 0.0f, c.inv_keep);
      dw[t] = selu_grad(g, __fadd_rn(w[t], b[t % e]), c);
    }
  }
}

// Blocks for n elements: one pass of kUnroll vectors a thread (the loops
// stride over what a grid of 2^31 - 1 blocks leaves).
int grid(long long n) {
  const long long per_block = 4LL * kThreads * kUnroll;
  const long long want = (n + per_block - 1) / per_block;
  return static_cast<int>(want < 1 ? 1 : (want < 0x7fffffffLL ? want : 0x7fffffffLL));
}

Consts consts(float keep, float inv_keep) {
  return Consts{kScale, kAlpha * kScale, keep, inv_keep};
}

}  // namespace

// h = selu(w + b) over the flat [n] (rows of width e, b [e]); with u
// (non-null), h = u < keep ? h * inv_keep : 0 and the keep mask into mask
// (4 * ceil(n / 4 / 32) + 1 words). Every pointer is 16-byte aligned.
extern "C" int embedding_forward(const float* w, const float* b, const float* u, float* h,
                                 uint32_t* mask, long long n, int e, float keep, float inv_keep,
                                 void* stream) {
  if (n < 0 || e < 1) return cudaErrorInvalidValue;
  const bool vec = e % 4 == 0;
  void (*kernel)(const float*, const float*, const float*, float*, uint32_t*, long long, int,
                 Consts) =
      u ? (vec ? embedding_forward_kernel<true, true> : embedding_forward_kernel<true, false>)
        : (vec ? embedding_forward_kernel<false, true> : embedding_forward_kernel<false, false>);
  kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(w, b, u, h, mask, n, e,
                                                                       consts(keep, inv_keep));
  return cudaGetLastError();
}

// dw = the gradient of embedding_forward's h with respect to w, given dh and
// (non-null under dropout) its keep mask.
extern "C" int embedding_backward(const float* dh, const float* w, const float* b,
                                  const uint32_t* mask, float* dw, long long n, int e,
                                  float inv_keep, void* stream) {
  if (n < 0 || e < 1) return cudaErrorInvalidValue;
  const bool vec = e % 4 == 0;
  void (*kernel)(const float*, const float*, const float*, const uint32_t*, float*, long long,
                 int, Consts) =
      mask ? (vec ? embedding_backward_kernel<true, true> : embedding_backward_kernel<true, false>)
           : (vec ? embedding_backward_kernel<false, true>
                  : embedding_backward_kernel<false, false>);
  kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(dh, w, b, mask, dw, n, e,
                                                                       consts(1.0f, inv_keep));
  return cudaGetLastError();
}
