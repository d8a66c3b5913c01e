// Banded frames-domain reprojection for Hopper (sm_90a): kernel B1.
//
// Replaces sstts/dsp/reproject.py:reproject_frames_pallas, the Pallas TPU
// kernel between the two DFT GEMMs of the "split" Griffin-Lim iteration:
//   out[t, j] = cast( wss2d[t, j] * sum_{d=-D..D} F[t-d, j+d*hop] ),
// summed in f32 in the Pallas kernel's order (d = 0 first, then d = -D..D
// without 0).  A term is zero where its source lane leaves [0, w_len) or its
// source row leaves [0, T); output lanes [w_len, wp) are zero.  bf16 or f32
// in, the same type out.  The few reflect-pad mirror runs follow in torch
// (sstts_torch/dsp/reproject.py), as the JAX package applies them in XLA.
//
// Bound on the H100: bytes.  At the split iteration's shapes (32 x 800
// frames, w_len = 1101 of wp = 1152 lanes, bf16) it needs to read 56 MB of
// frames and the 3.5 MB f32 envelope (lanes below w_len) and to write 59 MB
// (every lane): 0.0355 ms at 3.35 TB/s, against 8 adds and a multiply per
// element (0.25 GFLOP, 0.004 ms at 67 TFLOP/s f32).
//
// Design (simple first): grid (row block of BT = 16 frames, utterance),
// 256 threads.  A block stages its BT rows plus D halo rows on each side in
// shared memory once, in the input type, with 16-byte loads (rows outside
// [0, T) staged as zeros; T = 800 needs no padding because every row is
// bound-checked), so each input row leaves device memory about once: the
// halo rows a neighbouring block also reads mostly hit L2.  Each thread then
// sums the shifted terms of its lanes from shared memory.  24 staged rows of
// 1152 lanes take 55 KB in bf16 (four blocks an SM) and 110 KB in f32.

// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

extern "C" {

// Field order is mirrored by sstts_torch/dsp/reproject.py:_ReprojectArgs.
struct ReprojectArgs {
  const void* frames;  // (Bt, T, wp), bf16 or f32
  const float* wss2d;  // (T, wp), zero beyond w_len and outside the signal
  void* out;           // (Bt, T, wp), the frames' type
  int Bt, T, wp, w_len, hop, d_max;
};

}  // extern "C"

namespace {

constexpr int BT = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) reproject_kernel(const ReprojectArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // (BT + 2D, wp): rows t0-D ..
  const int t0 = blockIdx.x * BT;
  const int bi = blockIdx.y;
  const int D = p.d_max;
  const int rows = BT + 2 * D;
  const T* F = reinterpret_cast<const T*>(p.frames) + (size_t)bi * p.T * p.wp;
  T* O = reinterpret_cast<T*>(p.out) + (size_t)bi * p.T * p.wp;

  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  const int vpr = p.wp / V;          // wp % 8 == 0 (checked by the wrapper)
  for (int c = threadIdx.x; c < rows * vpr; c += kThreads) {
    const int r = c / vpr, v = c - r * vpr;
    const int t = t0 - D + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < p.T)
      val = *reinterpret_cast<const uint4*>(F + (size_t)t * p.wp + v * V);
    *reinterpret_cast<uint4*>(S + r * p.wp + v * V) = val;
  }
  __syncthreads();

  for (int r = 0; r < BT; ++r) {
    const int t = t0 + r;
    if (t >= p.T) break;
    const T* row = S + (r + D) * p.wp;
    const float* wss = p.wss2d + (size_t)t * p.wp;
    T* orow = O + (size_t)t * p.wp;
    for (int j = threadIdx.x; j < p.wp; j += kThreads) {
      float v = 0.f;
      if (j < p.w_len) {
        float acc = to_f32(row[j]);
        for (int di = 1; di <= 2 * D; ++di) {
          const int d = di <= D ? di - 1 - D : di - D;  // -D..-1, then 1..D
          const int js = j + d * p.hop;
          if (js >= 0 && js < p.w_len) acc += to_f32(S[(r + D - d) * p.wp + js]);
        }
        v = acc * wss[j];
      }
      store(orow + j, v);
    }
  }
}

template <typename T>
int launch(const ReprojectArgs* a, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      reproject_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a->T + BT - 1) / BT, a->Bt);
  reproject_kernel<T><<<grid, kThreads, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sstts_reproject_smem_bytes(int wp, int d_max, int elem_bytes) {
  return (BT + 2 * d_max) * wp * elem_bytes;
}

// Requires wp % 8 == 0 and sstts_reproject_smem_bytes(...) <= 232448.
int sstts_reproject(const ReprojectArgs* a, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_reproject_smem_bytes(a->wp, a->d_max, is_bf16 ? 2 : 4);
  return is_bf16 ? launch<bf16>(a, smem, st) : launch<float>(a, smem, st);
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
