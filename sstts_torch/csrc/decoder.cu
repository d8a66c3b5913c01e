// Whole autoregressive Tacotron decode for Hopper (sm_90a): kernel B4.
//
// Replaces sstts/ops/pallas_decoder.py:fused_decode, the Pallas TPU kernel
// that runs all S decoder steps in one pallas_call with the whole decoder
// cell resident in VMEM.  Each step, per utterance:
//   1. prenet: two FC-ReLU layers with inverted dropout (keep masks drawn
//      by the caller, so the kernel and its plain version see the same noise),
//   2. attention GRU over [prenet, previous context],
//   3. Bahdanau scores v . tanh(keys + W_q h + b), masked softmax in f32,
//      context = alignment @ memory,
//   4. decoder projection and two residual GRUs,
//   5. frame (r*M) and stop (r) projections,
//   6. stop-mask accumulation with min_steps gating; once an utterance has
//      finished, every carry freezes and its mel frames are zeroed.
// Products are taken in the matmul dtype (bf16 or f32: both operands are
// rounded to it) with f32 accumulation; gate math and softmax are f32, as in
// the Pallas kernel.
//
// Bound on the H100: latency.  160 dependent steps of ~2 * 32 * 1.7 M =
// 0.11 GFLOP each, i.e. nothing for the card's arithmetic.  The cell's
// 1.7 M parameters (3.4 MB in bf16) exceed one SM's shared memory, so the
// TPU's "all weights resident" design does not carry over: here the weights
// stay in device memory, where they remain L2-resident (50 MB L2) across the
// steps, and each step re-reads them from L2.  That re-read is the next cost.
//
// Design: one block per utterance (each row's decode is independent), the
// loop over S inside the block, the recurrent state in shared memory.
// Matrix-vector products split K over 8 groups of 128 threads (1024 in
// all); in a group each thread owns a pair of adjacent output columns, so
// a warp reads 128 contiguous bytes of a weight row and each thread's
// dependent chain is an eighth of K; the groups' partial sums meet in
// shared memory.  Attention scores use one warp per encoder position; the
// softmax is a block reduction in f32.  The key projection
// memory @ memory_proj is hoisted out of the kernel, as in JAX.  Any B (one
// block each) and any T the shared memory holds (T floats; T = 256 needs
// 1 KB); output widths up to kMaxN = 1024.

// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cell.cuh"

extern "C" {

// Field order is mirrored by sstts_torch/ops/decoder.py:_DecodeArgs.
struct DecodeArgs {
  const void* prenet_w0;  // (M, P0)
  const float* prenet_b0;
  const void* prenet_w1;  // (P0, P1)
  const float* prenet_b1;
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
  const void* frame_w;  // (Hd, r M)
  const float* frame_b;
  const void* stop_w;  // (Hd, r)
  const float* stop_b;
  const void* memory;  // (B, T, Dm) matmul dtype
  const void* keys;    // (B, T, A) matmul dtype
  const float* mask;   // (B, T) {0, 1}
  const float* keep0;  // (S, B, P0) {0, 1} or NULL (no dropout)
  const float* keep1;  // (S, B, P1)
  float* mel;          // (B, S, r M)
  float* stop;         // (B, S, r)
  float* align;        // (B, S, T)
  float* fin;          // (B, S): 1 = finished before this step
  int B, T, S, M, P0, P1, Dm, A, Ha, Hd, r;
  int min_steps;
  float stop_threshold;
  float dropout_scale;
};

}  // extern "C"

namespace {

constexpr int kThreads = 1024;

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const DecodeArgs p) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int Hm = p.Ha > p.Hd ? p.Ha : p.Hd;
  const int rM = p.r * p.M;

  // Shared-memory layout (floats).
  float* attn_h = sm;                 // Ha   attention-GRU carry
  float* h0 = attn_h + p.Ha;          // Hd   decoder-GRU carries
  float* h1 = h0 + p.Hd;              // Hd
  float* prev = h1 + p.Hd;            // M    previous frame
  float* x0 = prev + p.M;             // P0   prenet layer 0
  float* xin = x0 + p.P0;             // P1 + Dm: [prenet, context carry]
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
  float* melv = h1n + p.Hd;           // r M
  float* stopv = melv + rM;           // r
  float* sc = stopv + p.r;            // T  scores, then alignment
  float* red = sc + p.T;              // 33 reduction scratch
  float* fin_s = red + 33;            // 1
  float* part = fin_s + 1;            // kMaxN * groups: split-K partials

  for (int i = tid; i < p.Ha; i += blockDim.x) attn_h[i] = 0.f;
  for (int i = tid; i < p.Hd; i += blockDim.x) h0[i] = h1[i] = 0.f;
  for (int i = tid; i < p.M; i += blockDim.x) prev[i] = 0.f;
  for (int i = tid; i < p.Dm; i += blockDim.x) ctx[i] = 0.f;
  if (tid == 0) fin_s[0] = 0.f;
  __syncthreads();

  const WT* mem = static_cast<const WT*>(p.memory) + (size_t)b * p.T * p.Dm;
  const WT* keys = static_cast<const WT*>(p.keys) + (size_t)b * p.T * p.A;
  const float* mask = p.mask + (size_t)b * p.T;

  for (int t = 0; t < p.S; ++t) {
    const float fin_old = fin_s[0];

    // 1. Prenet (dropout active at inference per Tacotron-1).
    matvec<WT>(prev, p.M, p.prenet_w0, p.P0, p.prenet_b0, x0, part);
    for (int n = tid; n < p.P0; n += blockDim.x) {
      float v = fmaxf(x0[n], 0.f);
      if (p.keep0)
        v = p.keep0[((size_t)t * p.B + b) * p.P0 + n] > 0.f
                ? v * p.dropout_scale
                : 0.f;
      x0[n] = v;
    }
    __syncthreads();
    matvec<WT>(x0, p.P0, p.prenet_w1, p.P1, p.prenet_b1, xin, part);
    for (int n = tid; n < p.P1; n += blockDim.x) {
      float v = fmaxf(xin[n], 0.f);
      if (p.keep1)
        v = p.keep1[((size_t)t * p.B + b) * p.P1 + n] > 0.f
                ? v * p.dropout_scale
                : 0.f;
      xin[n] = v;
    }
    __syncthreads();

    // 2. Attention GRU over [prenet, context].
    gru_step<WT>(xin, p.P1 + p.Dm, attn_h, p.Ha, p.attn_wx, p.attn_wh,
                 p.attn_b, gx, gh, ha_new, nullptr, part);

    // 3. Bahdanau attention.
    matvec<WT>(ha_new, p.Ha, p.query_w, p.A, p.score_b, q, part);
    __syncthreads();
    for (int tt = warp; tt < p.T; tt += n_warps) {
      float score = 0.f;
      for (int a = lane; a < p.A; a += 32)
        score += tanhf(Load<WT>::w(keys, (size_t)tt * p.A + a) + q[a]) *
                 p.score_v[a];
      for (int o = 16; o > 0; o >>= 1)
        score += __shfl_xor_sync(0xffffffffu, score, o);
      if (lane == 0) sc[tt] = mask[tt] > 0.f ? score : -1e9f;
    }
    __syncthreads();
    float local = -CUDART_INF_F;
    for (int tt = tid; tt < p.T; tt += blockDim.x) local = fmaxf(local, sc[tt]);
    const float mx = block_reduce(local, red, true);
    local = 0.f;
    for (int tt = tid; tt < p.T; tt += blockDim.x) {
      const float e = expf(sc[tt] - mx);
      sc[tt] = e;
      local += e;
    }
    const float sum = block_reduce(local, red, false);
    float* align_out = p.align + ((size_t)b * p.S + t) * p.T;
    for (int tt = tid; tt < p.T; tt += blockDim.x) {
      const float a = sc[tt] / sum;
      sc[tt] = a;
      align_out[tt] = a;
    }
    __syncthreads();
    for (int j = tid; j < p.Dm; j += blockDim.x) {
      float acc = 0.f;
      for (int tt = 0; tt < p.T; ++tt)
        acc = fmaf(sc[tt], Load<WT>::w(mem, (size_t)tt * p.Dm + j), acc);
      ctx_new[j] = acc;
    }
    __syncthreads();

    // 4. Decoder projection and two residual GRUs.
    matvec<WT>(dproj, p.Ha + p.Dm, p.dec_w, p.Hd, p.dec_b, d, part);
    __syncthreads();
    gru_step<WT>(d, p.Hd, h0, p.Hd, p.gru0_wx, p.gru0_wh, p.gru0_b, gx, gh,
                 h0n, d, part);
    gru_step<WT>(d, p.Hd, h1, p.Hd, p.gru1_wx, p.gru1_wh, p.gru1_b, gx, gh,
                 h1n, d, part);

    // 5. Frame and stop projections.
    matvec<WT>(d, p.Hd, p.frame_w, rM, p.frame_b, melv, part);
    matvec<WT>(d, p.Hd, p.stop_w, p.r, p.stop_b, stopv, part);
    __syncthreads();

    // 6. Outputs, stop-mask accumulation, carry freeze.
    float* mel_out = p.mel + ((size_t)b * p.S + t) * rM;
    for (int i = tid; i < rM; i += blockDim.x)
      mel_out[i] = fin_old > 0.f ? 0.f : melv[i];
    for (int i = tid; i < p.r; i += blockDim.x)
      p.stop[((size_t)b * p.S + t) * p.r + i] = stopv[i];
    if (fin_old <= 0.f) {
      for (int i = tid; i < p.Ha; i += blockDim.x) attn_h[i] = ha_new[i];
      for (int i = tid; i < p.Hd; i += blockDim.x) {
        h0[i] = h0n[i];
        h1[i] = h1n[i];
      }
      for (int i = tid; i < p.Dm; i += blockDim.x) ctx[i] = ctx_new[i];
      for (int i = tid; i < p.M; i += blockDim.x)
        prev[i] = melv[(p.r - 1) * p.M + i];
    }
    if (tid == 0) {
      p.fin[(size_t)b * p.S + t] = fin_old;
      float smax = stopv[0];
      for (int i = 1; i < p.r; ++i) smax = fmaxf(smax, stopv[i]);
      float hit = sigmoidf_(smax) > p.stop_threshold ? 1.f : 0.f;
      if (p.min_steps > 0 && t < p.min_steps - 1) hit = 0.f;
      fin_s[0] = fmaxf(fin_old, hit);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int sstts_decode_smem_bytes(const DecodeArgs* a) {
  const int Hm = a->Ha > a->Hd ? a->Ha : a->Hd;
  const int floats = a->Ha + 2 * a->Hd + a->M + a->P0 + a->P1 + a->Dm +
                     6 * Hm + a->Ha + a->Dm + a->A + 3 * a->Hd +
                     a->r * a->M + a->r + a->T + 33 + 1 +
                     kMaxN * (kThreads / kColThreads);
  return floats * 4;
}

// weights_bf16: 1 when every matrix, memory and keys are bf16, 0 for f32.
int sstts_fused_decode(const DecodeArgs* a, int weights_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_decode_smem_bytes(a);
  cudaError_t err;
  if (weights_bf16) {
    err = cudaFuncSetAttribute(fused_decode_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    fused_decode_kernel<__nv_bfloat16><<<a->B, kThreads, smem, st>>>(*a);
  } else {
    err = cudaFuncSetAttribute(fused_decode_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    fused_decode_kernel<float><<<a->B, kThreads, smem, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
