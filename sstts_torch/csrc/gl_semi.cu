// Semi-fused Griffin-Lim iteration tail for Hopper (sm_90a): kernel B2.
//
// Replaces sstts/dsp/gl_fused.py:fused_reproject_analyze, the Pallas TPU
// kernel that fuses, for one Griffin-Lim iteration, everything after the
// synthesis GEMM:
//   1. the banded shift-add in the frames domain (the reprojection)
//        A[t, j] = bf16( wss2d[t, j] * sum_{d=-D..D} F[t-d, j+d*hop] ),
//      with the source lane j+d*hop kept inside the window support,
//   2. the analysis GEMM  S = A @ w_fwd  (bf16 operands, f32 accumulation),
//   3. the phase renorm   q' = s * rsqrt(re^2 + im^2 + 1e-24) * mag,
//      where bin j's real part sits in lane j and its imaginary part in lane
//      j + hp; with momentum, s is first extrapolated to s + m*(s - prev)
//      and the raw s is returned as well.
// The few reflect-pad edge rows are repaired afterwards in plain torch by
// the wrapper (sstts_torch/dsp/gl_fused.py), as the JAX package repairs them
// in XLA.
//
// Bound on the H100: operations.  At the main path's shapes (32 x 800 rows,
// K = w_len = 1101 of wp = 1152 lanes, N = 2048) the GEMM needs
// 2*25600*1101*2048 = 115.4 GFLOP, 0.1167 ms at 989 TFLOP/s bf16, against
// ~0.08 ms for its ~274 MB of traffic at 3.35 TB/s; it runs 60 times per
// batch at GL-60.
//
// Design (simple first; wgmma, TMA and clusters are later work): grid (row
// block of BM = 64 frames, utterance), 256 threads, 8 warps.  The block
// builds its whole A panel from the bf16 frames in shared memory once (JAX
// rounds at fr.astype(dtype)), so the shift-add costs one pass however many
// output tiles follow; it then walks the bins in tiles of 64, each a GEMM of
// the panel with both halves of w_fwd and the renorm (and the momentum
// extrapolation) in the epilogue.  The three phases are gl_tail.cuh's,
// shared with kernel B5 (gl_fused.cu).  PERF.md has the time of each phase
// (sstts_torch/tools/ablate_gl_semi.py builds this file with SSTTS_ABLATE
// set to drop phases).

// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include "gl_tail.cuh"

extern "C" {

// Field order is mirrored by sstts_torch/dsp/gl_fused.py:_GlArgs.
struct GlArgs {
  const bf16* frames;  // (Bt, T, wp)
  const bf16* mag2;    // (Bt, T, 2 hp)
  const bf16* w_fwd;   // (wp, 2 hp)
  const float* wss2d;  // (T, wp), zero beyond w_len and outside the signal
  const bf16* prev;    // (Bt, T, 2 hp) or NULL (classic iteration)
  bf16* q_out;         // (Bt, T, 2 hp)
  bf16* s_out;         // (Bt, T, 2 hp) or NULL
  int Bt, T, wp, hp, w_len, hop, d_max;
  float momentum;
};

}  // extern "C"

namespace {

// One instance for the classic iteration (prev NULL) and one with momentum.
template <bool kMomentum>
__global__ void __launch_bounds__(kThreads) gl_semi_kernel(const GlArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  gl_tail<kMomentum>(p, smem_raw, p.frames + (size_t)blockIdx.y * p.T * p.wp, 0);
}

}  // namespace

extern "C" {

int sstts_gl_semi_smem_bytes(int wp) { return tail_smem_bytes(wp); }

// Requires wp % 64 == 0 and hp % 64 == 0 (the loop pads both to 128-lane
// multiples) and sstts_gl_semi_smem_bytes(wp) <= 232448.
int sstts_gl_semi(const GlArgs* a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_gl_semi_smem_bytes(a->wp);
  void (*kernel)(const GlArgs) =
      a->prev ? gl_semi_kernel<true> : gl_semi_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a->T + BM - 1) / BM, a->Bt);
  kernel<<<grid, kThreads, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
