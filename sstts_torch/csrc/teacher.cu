// Teacher-forced Tacotron decoder scan for Hopper (sm_90a): kernel B6.
//
// Replaces sstts/ops/pallas_decoder.py:fused_teacher_scan, the Pallas TPU
// kernel that runs all S teacher-forced steps in one pallas_call with the
// step chain's weights resident in VMEM.  Training hoists the prenet (its
// inputs, the teacher frames, are known up front) and the frame/stop
// projections out of the scan, so each step, per utterance, is
// _teacher_step_math (pallas_decoder.py:419-444):
//   1. attention GRU over [prenet output of this step, previous context],
//   2. Bahdanau scores v . tanh(keys + W_q h + b), masked softmax in f32,
//      context = alignment @ memory,
//   3. decoder projection of [h, context] and two residual GRUs,
// and it writes the step's feature d (which the caller projects to frames
// and stop logits) and the alignment.  The carries (attention h, two decoder
// h, context) start at zero and never leave shared memory; nothing freezes.
// Products take both operands rounded to the matmul dtype (bf16 or f32)
// with f32 accumulation; gates and softmax are f32, as in the Pallas kernel.
//
// Bound on the H100: latency.  At the training shape (B=32, S=103, T=128)
// a step is ~1.54 M multiply-adds per utterance, 1.0e10 operations in all
// (~0.010 ms at the bf16 peak) over ~14 MB of inputs and outputs
// (~0.004 ms); the chain of S dependent steps sets the time.  The step's
// 1.5 M weights (2.9 MB in bf16) exceed one SM's shared memory, so, as in
// the autoregressive decode (decoder.cu, kernel B4), they stay in device
// memory, L2-resident across the steps, and each step re-reads them from L2.
//
// Design: B4's without the prenet, the projections and the stop logic.  One
// block of 1024 threads per utterance, the loop over S inside the block, the
// state in shared memory; products split K over 8 groups of 128 threads on
// column pairs (cell.cuh).  Any B, any T the shared memory holds, product
// widths up to kMaxN = 1024.
//
// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cell.cuh"

extern "C" {

// Field order is mirrored by sstts_torch/ops/teacher.py:_TeacherArgs.
struct TeacherArgs {
  const void* attn_wx;  // (P1 + Dm, 3 Ha)
  const void* attn_wh;  // (Ha, 3 Ha)
  const float* attn_b;
  const void* query_w;  // (Ha, A)
  const float* score_v;
  const float* score_b;
  const void* dec_w;  // (Ha + Dm, Hd)
  const float* dec_b;
  const void* gru0_wx;  // (Hd, 3 Hd)
  const void* gru0_wh;
  const float* gru0_b;
  const void* gru1_wx;
  const void* gru1_wh;
  const float* gru1_b;
  const float* pre;    // (B, S, P1) f32 prenet outputs
  const void* memory;  // (B, T, Dm) matmul dtype
  const void* keys;    // (B, T, A) matmul dtype
  const float* mask;   // (B, T) {0, 1}
  float* xs;           // (B, S, Hd)
  float* align;        // (B, S, T)
  int B, T, S, P1, Dm, A, Ha, Hd;
};

}  // extern "C"

namespace {

constexpr int kThreads = 1024;

// Bahdanau attention for one utterance: scores v . tanh(keys[t] + q), where
// q already holds the query projection plus the score bias; a masked
// softmax in f32 over T (one warp per position for the scores, block
// reductions for max and sum); the alignment goes to `sc` and `align_out`,
// and the context alignment @ memory to `ctx`.  Ends after a barrier.
// The same arithmetic as B4's inline attention (decoder.cu); B4 keeps its
// copy inline because nvcc compiles B4 about 10% slower through this
// function, while B6 runs slightly faster with it.
template <typename WT>
__device__ void attend(const float* q, const WT* keys, const WT* mem,
                       const float* mask, const float* score_v, int T, int A,
                       int Dm, float* sc, float* red, float* align_out,
                       float* ctx) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int tt = warp; tt < T; tt += n_warps) {
    float score = 0.f;
    for (int a = lane; a < A; a += 32)
      score += tanhf(Load<WT>::w(keys, (size_t)tt * A + a) + q[a]) * score_v[a];
    for (int o = 16; o > 0; o >>= 1)
      score += __shfl_xor_sync(0xffffffffu, score, o);
    if (lane == 0) sc[tt] = mask[tt] > 0.f ? score : -1e9f;
  }
  __syncthreads();
  float local = -CUDART_INF_F;
  for (int tt = tid; tt < T; tt += blockDim.x) local = fmaxf(local, sc[tt]);
  const float mx = block_reduce(local, red, true);
  local = 0.f;
  for (int tt = tid; tt < T; tt += blockDim.x) {
    const float e = expf(sc[tt] - mx);
    sc[tt] = e;
    local += e;
  }
  const float sum = block_reduce(local, red, false);
  for (int tt = tid; tt < T; tt += blockDim.x) {
    const float a = sc[tt] / sum;
    sc[tt] = a;
    align_out[tt] = a;
  }
  __syncthreads();
  for (int j = tid; j < Dm; j += blockDim.x) {
    float acc = 0.f;
    for (int tt = 0; tt < T; ++tt)
      acc = fmaf(sc[tt], Load<WT>::w(mem, (size_t)tt * Dm + j), acc);
    ctx[j] = acc;
  }
  __syncthreads();
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
teacher_scan_kernel(const TeacherArgs p) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Hm = p.Ha > p.Hd ? p.Ha : p.Hd;

  // Shared-memory layout (floats).
  float* attn_h = sm;                 // Ha   attention-GRU carry
  float* h0 = attn_h + p.Ha;          // Hd   decoder-GRU carries
  float* h1 = h0 + p.Hd;              // Hd
  float* xin = h1 + p.Hd;             // P1 + Dm: [prenet, context carry]
  float* ctx = xin + p.P1;            //   context carry lives inside xin
  float* gx = xin + p.P1 + p.Dm;      // 3 Hm
  float* gh = gx + 3 * Hm;            // 3 Hm
  float* dproj = gh + 3 * Hm;         // Ha + Dm: [h_a new, context new]
  float* ha_new = dproj;
  float* ctx_new = dproj + p.Ha;
  float* q = dproj + p.Ha + p.Dm;     // A
  float* d = q + p.A;                 // Hd
  float* h0n = d + p.Hd;              // Hd
  float* h1n = h0n + p.Hd;            // Hd
  float* sc = h1n + p.Hd;             // T  scores, then alignment
  float* red = sc + p.T;              // 33 reduction scratch
  float* part = red + 33;             // kMaxN * groups: split-K partials

  for (int i = tid; i < p.Ha; i += blockDim.x) attn_h[i] = 0.f;
  for (int i = tid; i < p.Hd; i += blockDim.x) h0[i] = h1[i] = 0.f;
  for (int i = tid; i < p.Dm; i += blockDim.x) ctx[i] = 0.f;

  const WT* mem = static_cast<const WT*>(p.memory) + (size_t)b * p.T * p.Dm;
  const WT* keys = static_cast<const WT*>(p.keys) + (size_t)b * p.T * p.A;
  const float* mask = p.mask + (size_t)b * p.T;

  for (int t = 0; t < p.S; ++t) {
    const size_t row = (size_t)b * p.S + t;
    for (int n = tid; n < p.P1; n += blockDim.x) xin[n] = p.pre[row * p.P1 + n];
    __syncthreads();

    // 1. Attention GRU over [prenet, context].
    gru_step<WT>(xin, p.P1 + p.Dm, attn_h, p.Ha, p.attn_wx, p.attn_wh,
                 p.attn_b, gx, gh, ha_new, nullptr, part);

    // 2. Bahdanau attention.
    matvec<WT>(ha_new, p.Ha, p.query_w, p.A, p.score_b, q, part);
    attend<WT>(q, keys, mem, mask, p.score_v, p.T, p.A, p.Dm, sc, red,
               p.align + row * p.T, ctx_new);

    // 3. Decoder projection and two residual GRUs.
    matvec<WT>(dproj, p.Ha + p.Dm, p.dec_w, p.Hd, p.dec_b, d, part);
    gru_step<WT>(d, p.Hd, h0, p.Hd, p.gru0_wx, p.gru0_wh, p.gru0_b, gx, gh,
                 h0n, d, part);
    gru_step<WT>(d, p.Hd, h1, p.Hd, p.gru1_wx, p.gru1_wh, p.gru1_b, gx, gh,
                 h1n, d, part);

    // 4. Output feature and carries.
    float* xs_out = p.xs + row * p.Hd;
    for (int i = tid; i < p.Ha; i += blockDim.x) attn_h[i] = ha_new[i];
    for (int i = tid; i < p.Hd; i += blockDim.x) {
      h0[i] = h0n[i];
      h1[i] = h1n[i];
      xs_out[i] = d[i];
    }
    for (int i = tid; i < p.Dm; i += blockDim.x) ctx[i] = ctx_new[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int sstts_teacher_smem_bytes(const TeacherArgs* a) {
  const int Hm = a->Ha > a->Hd ? a->Ha : a->Hd;
  const int floats = a->Ha + 2 * a->Hd + a->P1 + a->Dm + 6 * Hm + a->Ha +
                     a->Dm + a->A + 3 * a->Hd + a->T + 33 +
                     kMaxN * (kThreads / kColThreads);
  return floats * 4;
}

// weights_bf16: 1 when every matrix, memory and keys are bf16, 0 for f32.
int sstts_fused_teacher_scan(const TeacherArgs* a, int weights_bf16,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_teacher_smem_bytes(a);
  cudaError_t err;
  if (weights_bf16) {
    err = cudaFuncSetAttribute(teacher_scan_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    teacher_scan_kernel<__nv_bfloat16><<<a->B, kThreads, smem, st>>>(*a);
  } else {
    err = cudaFuncSetAttribute(teacher_scan_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    teacher_scan_kernel<float><<<a->B, kThreads, smem, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
