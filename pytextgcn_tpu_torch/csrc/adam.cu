// Adam and AMSGrad as one fused pass for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its optimizer update
// (pytextgcn_tpu/train/optim.py) to XLA, which fuses it. In the port,
// torch.optim.Adam's foreach step (torch/optim/adam.py::_multi_tensor_adam)
// runs the update as eight multi_tensor_apply passes over every parameter
// (lerp_, mul_, addcmul_, maximum_, sqrt, div_, add_, addcdiv_), some 84
// bytes a parameter: 4.7 ms a step for EGCN's 156M parameters.
//
// What bounds it on an H100: bytes. One pass reads p, g, m, v (and v_max)
// once and writes p, m, v (and v_max) once: 36 bytes a parameter for
// AMSGrad, 28 for Adam; EGCN's 156.05M parameters move 5.62 GB, 1.68 ms at
// 3.35 TB/s. What the design does about it:
//
//   * One launch a step over a table of the step's tensors (at most
//     kMaxTensors, passed by value as the kernel's parameter). Every block
//     walks every tensor grid-stride, so a 43-element bias costs the card a
//     few idle loop tests and a 156M-element weight spreads over all of it.
//   * 16-byte vectors, neighbouring threads on neighbouring vectors, kUnroll
//     vectors of each stream in flight a thread, and as many blocks as stay
//     resident on the card (occupancy times SMs), so loads cover HBM's
//     latency without a tail of late blocks.
//   * The gradient, read once, is loaded evict-first (ld.global.cs).
//   * A tensor whose element count is not a multiple of 4 ends in a scalar
//     tail; one with any pointer off 16 bytes runs scalar throughout.
//
// Arithmetic: torch's foreach step, op for op in its order, in float32. ATen
// compiles its foreach functors with nvcc's default FMA contraction, so
// lerp_, addcmul_ and addcdiv_ each end in one fused multiply-add; the
// intrinsics below pin every rounding, so nothing else is contracted:
//
//   m     = fma(w1, g - m, m)                     lerp_, weight w1 = 1 - b1 < 0.5
//         = fma(-(g - m), 1 - w1, g)              lerp_, w1 >= 0.5 (ATen's other branch)
//   v     = fma(1 - b2, g * g, v * b2)            mul_, then addcmul_
//   v_max = isnan(v_max) || v_max > v ? v_max : v maximum_ (ATen's NaN rule)
//   d     = sqrt(v_max) / sqrt(1 - b2^t) + eps    sqrt, div_, add_ (v for Adam)
//   p     = fma(-lr / (1 - b1^t), m / d, p)       addcdiv_
//
// with each scalar formed on the host as _multi_tensor_adam forms it (in
// double) and rounded to float, as ATen rounds a Scalar.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

// One tensor of the step (train/optim.py::_Row, field for field).
struct AdamTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  float* v_max;  // null without AMSGrad
  long long n;
  float step_size;  // -lr / (1 - b1^t)
  float bc2_sqrt;   // sqrt(1 - b2^t)
  float w1;         // 1 - b1, lerp_'s weight
  float b2;
  float w2;  // 1 - b2, addcmul_'s value
  float eps;
};

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;       // vectors of each stream a thread has in flight
constexpr int kMaxTensors = 48;  // a table's tensors: 48 * 72 + 4 bytes of parameter

struct Table {
  AdamTensor t[kMaxTensors];
  int n;
};

struct Scalars {
  float step_size, bc2_sqrt, w1, b2, w2, eps;
};

template <bool kAmsgrad>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float& v_max,
                                       const Scalars& s) {
  const float diff = __fsub_rn(g, m);
  m = s.w1 < 0.5f ? __fmaf_rn(s.w1, diff, m) : __fmaf_rn(-diff, __fsub_rn(1.0f, s.w1), g);
  v = __fmaf_rn(s.w2, __fmul_rn(g, g), __fmul_rn(v, s.b2));
  float d = v;
  if (kAmsgrad) {
    v_max = (isnan(v_max) || v_max > v) ? v_max : v;
    d = v_max;
  }
  d = __fadd_rn(__fdiv_rn(__fsqrt_rn(d), s.bc2_sqrt), s.eps);
  p = __fmaf_rn(s.step_size, __fdiv_rn(m, d), p);
}

template <bool kAmsgrad>
__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v,
                                        float4& v_max, const Scalars& s) {
  update<kAmsgrad>(p.x, g.x, m.x, v.x, v_max.x, s);
  update<kAmsgrad>(p.y, g.y, m.y, v.y, v_max.y, s);
  update<kAmsgrad>(p.z, g.z, m.z, v.z, v_max.z, s);
  update<kAmsgrad>(p.w, g.w, m.w, v.w, v_max.w, s);
}

template <bool kAmsgrad>
__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Table tab) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int t = 0; t < tab.n; ++t) {
    const AdamTensor& e = tab.t[t];
    const Scalars s{e.step_size, e.bc2_sqrt, e.w1, e.b2, e.w2, e.eps};
    float* __restrict__ p = e.p;
    const float* __restrict__ g = e.g;
    float* __restrict__ m = e.m;
    float* __restrict__ v = e.v;
    float* __restrict__ x = e.v_max;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
                           (kAmsgrad ? reinterpret_cast<uintptr_t>(x) : 0);
    const long long n4 = (bits & 15) == 0 ? e.n / 4 : 0;
    for (long long i = first; i < n4; i += stride * kUnroll) {
      float4 P[kUnroll], G[kUnroll], M[kUnroll], V[kUnroll], X[kUnroll] = {};
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long j = i + k * stride;
        if (j < n4) {
          G[k] = __ldcs(reinterpret_cast<const float4*>(g) + j);
          P[k] = reinterpret_cast<const float4*>(p)[j];
          M[k] = reinterpret_cast<const float4*>(m)[j];
          V[k] = reinterpret_cast<const float4*>(v)[j];
          if (kAmsgrad) X[k] = reinterpret_cast<const float4*>(x)[j];
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long j = i + k * stride;
        if (j < n4) {
          update4<kAmsgrad>(P[k], G[k], M[k], V[k], X[k], s);
          reinterpret_cast<float4*>(p)[j] = P[k];
          reinterpret_cast<float4*>(m)[j] = M[k];
          reinterpret_cast<float4*>(v)[j] = V[k];
          if (kAmsgrad) reinterpret_cast<float4*>(x)[j] = X[k];
        }
      }
    }
    for (long long j = 4 * n4 + first; j < e.n; j += stride) {
      float pj = p[j], mj = m[j], vj = v[j], xj = kAmsgrad ? x[j] : 0.0f;
      update<kAmsgrad>(pj, __ldcs(g + j), mj, vj, xj, s);
      p[j] = pj;
      m[j] = mj;
      v[j] = vj;
      if (kAmsgrad) x[j] = xj;
    }
  }
}

}  // namespace

// One launch over tensors[0..n_tensors) (1 to kMaxTensors), AMSGrad when
// amsgrad is nonzero, on the current device and the given stream.
extern "C" int adam_launch(const AdamTensor* tensors, int n_tensors, int amsgrad,
                           void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) return cudaErrorInvalidValue;
  Table tab;
  tab.n = n_tensors;
  long long most = 0;
  for (int i = 0; i < n_tensors; ++i) {
    tab.t[i] = tensors[i];
    if (tensors[i].n > most) most = tensors[i].n;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  void (*kernel)(Table) = amsgrad ? adam_kernel<true> : adam_kernel<false>;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long per_block = 4LL * kThreads * kUnroll;
  const long long want = (most + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < resident ? want : resident));
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(tab);
  return cudaGetLastError();
}
