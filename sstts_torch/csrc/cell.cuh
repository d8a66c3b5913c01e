// Device helpers shared by the recurrent decoder kernels (decoder.cu, kernel
// B4, and teacher.cu, kernel B6): split-K matrix-vector products on bf16x2
// or float2 column pairs, one fused-gate GRU step and a block reduction.
// Each block runs one utterance; the state these functions read and write
// lives in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <typename WT>
struct Load;
template <>
struct Load<float> {
  static __device__ __forceinline__ float w(const float* p, size_t i) {
    return p[i];
  }
  static __device__ __forceinline__ float x(float v) { return v; }
};
template <>
struct Load<__nv_bfloat16> {
  static __device__ __forceinline__ float w(const __nv_bfloat16* p,
                                            size_t i) {
    return __bfloat162float(p[i]);
  }
  // The activation is rounded to the matmul dtype too, as JAX's
  // dot(x.astype(dt), w.astype(dt)) does.
  static __device__ __forceinline__ float x(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// Two adjacent weights as floats (a 4-byte bf16x2 or 8-byte float2 load).
__device__ __forceinline__ float2 load2(const __nv_bfloat16* W, size_t i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(W + i));
}
__device__ __forceinline__ float2 load2(const float* W, size_t i) {
  return *reinterpret_cast<const float2*>(W + i);
}

constexpr int kColThreads = 128;  // threads per K group; 2 columns each
constexpr int kMaxN = 1024;       // widest product (3 * 256 at the default)

// out[n] = sum_k x[k] * W[k, n] (+ bias[n]) for n in [0, N).  K is split
// over blockDim / 128 groups of threads; in a group, thread c owns the
// column pair (2c, 2c+1) of each 256-column strip, so a warp reads 128
// contiguous bytes of a weight row.  The groups' partial sums meet in
// shared memory (`part`, kMaxN * groups floats).  On return thread
// n % blockDim owns out[n], and the block has passed a barrier.
template <typename WT>
__device__ void matvec(const float* x, int K, const void* Wv, int N,
                       const float* bias, float* out, float* part) {
  const WT* W = static_cast<const WT*>(Wv);
  const int groups = blockDim.x / kColThreads;
  const int g = threadIdx.x / kColThreads, c = threadIdx.x % kColThreads;
  const int k_per = (K + groups - 1) / groups;
  const int k0 = g * k_per, k1 = min(K, k0 + k_per);
  if ((N & 1) == 0) {
    for (int n = 2 * c; n < N; n += 2 * kColThreads) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float xv = Load<WT>::x(x[k]);
        const float2 w = load2(W, (size_t)k * N + n);
        a0 = fmaf(xv, w.x, a0);
        a1 = fmaf(xv, w.y, a1);
      }
      part[g * kMaxN + n] = a0;
      part[g * kMaxN + n + 1] = a1;
    }
  } else {
    for (int n = c; n < N; n += kColThreads) {
      float a0 = 0.f;
      for (int k = k0; k < k1; ++k)
        a0 = fmaf(Load<WT>::x(x[k]), Load<WT>::w(W, (size_t)k * N + n), a0);
      part[g * kMaxN + n] = a0;
    }
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = part[n];
    for (int gg = 1; gg < groups; ++gg) acc += part[gg * kMaxN + n];
    out[n] = bias ? acc + bias[n] : acc;
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// One GRU step: gx = x @ wx + b, gh = h @ wh; writes h_new.  `post` (may be
// NULL) receives post[i] += h_new[i] (the residual connection).
template <typename WT>
__device__ void gru_step(const float* x, int K, const float* h, int H,
                         const void* wx, const void* wh, const float* b,
                         float* gx, float* gh, float* h_new, float* post,
                         float* part) {
  matvec<WT>(x, K, wx, 3 * H, b, gx, part);
  matvec<WT>(h, H, wh, 3 * H, nullptr, gh, part);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float r = sigmoidf_(gx[i] + gh[i]);
    const float z = sigmoidf_(gx[H + i] + gh[H + i]);
    const float n = tanhf(gx[2 * H + i] + r * gh[2 * H + i]);
    const float hn = z * h[i] + (1.f - z) * n;
    h_new[i] = hn;
    if (post) post[i] += hn;
  }
  __syncthreads();
}

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : (is_max ? -CUDART_INF_F : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

}  // namespace
