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
// Bound on the H100: not arithmetic (a step is ~1.6 M multiply-adds an
// utterance) but moving the cell to the SM.  The cell's 1.6 M parameters
// (3.3 MB in bf16) exceed one SM's shared memory, so the TPU's "all weights
// resident" design does not carry over: every step reads the whole cell and
// the utterance's keys and memory (3.36 MB at the default config) from L2,
// where they stay resident.  Loads issued by the threads themselves keep
// too few bytes in flight for L2's latency (the first port's kernel: 93 us
// a step on an H100).
//
// Design: one block per utterance, the loop over S inside the block, the
// recurrent state in shared memory.  The host packs the twelve matrices into
// one buffer in the order a step reads them and cuts it, with this
// utterance's keys and memory, into a schedule of chunks of whole rows
// (sstts_torch/ops/decoder.py:pack_weights, chunk_schedule).  One producer
// lane walks that schedule S times, copying each chunk with cp.async.bulk
// into a ring of shared-memory stages (stream.cuh), as far ahead as the ring
// allows, across product and step boundaries: the order never depends on
// the data.  The consumer warps take each product from the stages (K split
// over groups, a thread a 16-byte column segment), the scores from the rows
// of keys (a warp a row), the context from the rows of memory, and do the
// gates, the softmax and the freeze between them; steps 2-4 are the chain
// B6 runs too (chain.cuh).  The key projection
// memory @ memory_proj is hoisted out of the kernel, as in JAX.  Limits: any
// B (one block each); any product width (wider than kMaxCols = 1024 in
// column panels, one pass of the consumers each: stream::matvec); T up to
// what shared memory holds beside the ring (T floats of scores).
//
// The ring is 2 stages of 64 KB, read by 16 consumer warps beside one
// producer warp (chain.cuh, B6's too; PERF.md §6 gives the settings tried
// and their times).
// SSTTS_ABLATE, at compile time, gives stage times: 1 the stream alone
// (consumers only wait for and release each chunk); else a mask, 2 without
// the stream (no copies, no waiting), 4 without the products' multiply-adds
// (6: the consumers' attention, gates, reductions and barriers alone).
// Ablated builds compute garbage.

// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chain.cuh"
#include "stream.cuh"

#ifndef SSTTS_ABLATE
#define SSTTS_ABLATE 0
#endif

extern "C" {

// Field order is mirrored by sstts_torch/ops/decoder.py:_DecodeArgs.
struct DecodeArgs {
  const void* packed;    // the twelve matrices, rows padded to 16 bytes
  const void* schedule;  // (n_chunks, 8) int32, stream::Chunk
  const float* prenet_b0;
  const float* prenet_b1;
  const float* attn_b;
  const float* score_v;
  const float* score_b;
  const float* dec_b;
  const float* gru0_b;
  const float* gru1_b;
  const float* frame_b;
  const float* stop_b;
  const void* memory;  // (B, T, Dm) matmul dtype, rows padded to 16 bytes,
                       // in column panels past kMaxCols (decoder.memory_panels)
  const void* keys;    // (B, T, A) matmul dtype, rows padded to 16 bytes
  const float* mask;   // (B, T) {0, 1}
  const float* keep0;  // (S, B, P0) {0, 1} or NULL (no dropout)
  const float* keep1;  // (S, B, P1)
  float* mel;          // (B, S, r M)
  float* stop;         // (B, S, r)
  float* align;        // (B, S, T)
  float* fin;          // (B, S): 1 = finished before this step
  int B, T, S, M, P0, P1, Dm, A, Ha, Hd, r;
  int min_steps;
  int n_chunks;
  float stop_threshold;
  float dropout_scale;
};

}  // extern "C"

namespace {

// The ring's settings are chain.cuh's, one for B4 and B6.
using chain::kConsumers;
using chain::kPartFloats;
using chain::kThreads;
constexpr int kAblate = SSTTS_ABLATE;
constexpr bool kStream = (kAblate & 2) == 0;
constexpr bool kMath = (kAblate & 4) == 0;
using Ring = chain::Ring<kStream>;

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const DecodeArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring(smem);
  const int b = blockIdx.x, tid = threadIdx.x;
  const stream::Chunk* sched = static_cast<const stream::Chunk*>(p.schedule);
  const int n = p.n_chunks;

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid >= kConsumers) {  // the producer warp: one lane streams
    if (tid == kConsumers && kStream)
      ring.produce(sched, n, p.S, static_cast<const unsigned char*>(p.packed),
                   static_cast<const unsigned char*>(p.keys),
                   static_cast<const unsigned char*>(p.memory), (size_t)b * p.T);
    return;
  }
  stream::Cursor cur{0, 0u, 0};
  if (kAblate == 1) {  // the stream alone
    for (int i = 0; i < n * p.S; ++i) {
      ring.acquire(cur);
      ring.release(cur, n);
    }
    return;
  }

  const int Hm = p.Ha > p.Hd ? p.Ha : p.Hd;
  const int rM = p.r * p.M;
  // Shared-memory layout (floats) after the ring; every buffer starts
  // 16-byte aligned (the partials are stored as float4).
  float* next = reinterpret_cast<float*>(smem + Ring::kBytes);
  auto take = [&](int floats) {
    float* at = next;
    next += (floats + 3) & ~3;
    return at;
  };
  float* part = take(kPartFloats);  // split-K partials
  float* attn_h = take(p.Ha);       // attention-GRU carry
  float* h0 = take(p.Hd);           // decoder-GRU carries
  float* h1 = take(p.Hd);
  float* prev = take(p.M);          // previous frame
  float* x0 = take(p.P0);           // prenet layer 0
  float* xin = take(p.P1 + p.Dm);   // [prenet, context carry]
  float* ctx = xin + p.P1;          //   the context carry lives inside xin
  float* gx = take(3 * Hm);
  float* gh = take(3 * Hm);
  float* dproj = take(p.Ha + p.Dm);  // [h_a new, context new]
  float* ha_new = dproj;
  float* ctx_new = dproj + p.Ha;
  float* q = take(p.A);
  float* d = take(p.Hd);
  float* h0n = take(p.Hd);
  float* h1n = take(p.Hd);
  float* melv = take(rM);
  float* stopv = take(p.r);
  float* sc = take(p.T);  // scores, then alignment
  float* red = take(33);  // reduction scratch
  float* fin_s = take(1);
  float* kp0 = take(p.P0);  // this step's prenet keep masks
  float* kp1 = take(p.P1);
  // The keep masks of step t, or 1 (no dropout), from global memory once a
  // step, off the prenet's critical path.
  auto stage_keep = [&](int t) {
    for (int i = tid; i < p.P0; i += kConsumers)
      kp0[i] = p.keep0 ? p.keep0[((size_t)t * p.B + b) * p.P0 + i] : 1.f;
    for (int i = tid; i < p.P1; i += kConsumers)
      kp1[i] = p.keep1 ? p.keep1[((size_t)t * p.B + b) * p.P1 + i] : 1.f;
  };

  for (int i = tid; i < p.Ha; i += kConsumers) attn_h[i] = 0.f;
  for (int i = tid; i < p.Hd; i += kConsumers) h0[i] = h1[i] = 0.f;
  for (int i = tid; i < p.M; i += kConsumers) prev[i] = 0.f;
  for (int i = tid; i < p.Dm; i += kConsumers) ctx[i] = 0.f;
  if (tid == 0) fin_s[0] = 0.f;
  stage_keep(0);
  stream::consumer_sync<kConsumers>();

  const float* mask = p.mask + (size_t)b * p.T;
  // Steps 2-4, the chain B6 runs too (chain.cuh).
  const chain::Chain<WT, kMath, Ring> ch{ring, cur, sched, n};
  const chain::Buffers bufs{part, attn_h, h0, h1, xin, gx, gh, dproj,
                            q, d, h0n, h1n, sc, red};
  const chain::Vectors vecs{p.attn_b, p.score_v, p.score_b, p.dec_b, p.gru0_b, p.gru1_b};

  for (int t = 0; t < p.S; ++t) {
    const float fin_old = fin_s[0];

    // 1. Prenet (dropout active at inference per Tacotron-1), ReLU and the
    // keep mask applied as each column's sum is made.
    stream::matvec<WT, true, kMath>(ring, cur, sched, n, prev, p.P0, part, [&](int j, float s) {
      const float v = fmaxf(s + p.prenet_b0[j], 0.f);
      x0[j] = !p.keep0 ? v : kp0[j] > 0.f ? v * p.dropout_scale : 0.f;
    });
    stream::matvec<WT, true, kMath>(ring, cur, sched, n, x0, p.P1, part, [&](int j, float s) {
      const float v = fmaxf(s + p.prenet_b1[j], 0.f);
      xin[j] = !p.keep1 ? v : kp1[j] > 0.f ? v * p.dropout_scale : 0.f;
    });

    // 2-4. Attention GRU, Bahdanau attention, decoder projection and two
    // residual GRUs.
    ch.step(bufs, vecs, p.T, p.Dm, p.A, p.Ha, p.Hd, mask,
            p.align + ((size_t)b * p.S + t) * p.T);

    // 5. Frame and stop projections.
    ch.product(d, rM, p.frame_b, melv, part);
    ch.product(d, p.r, p.stop_b, stopv, part);

    // 6. Outputs, stop-mask accumulation, carry freeze.
    float* mel_out = p.mel + ((size_t)b * p.S + t) * rM;
    for (int i = tid; i < rM; i += kConsumers) mel_out[i] = fin_old > 0.f ? 0.f : melv[i];
    for (int i = tid; i < p.r; i += kConsumers)
      p.stop[((size_t)b * p.S + t) * p.r + i] = stopv[i];
    if (fin_old <= 0.f) {
      for (int i = tid; i < p.Ha; i += kConsumers) attn_h[i] = ha_new[i];
      for (int i = tid; i < p.Hd; i += kConsumers) {
        h0[i] = h0n[i];
        h1[i] = h1n[i];
      }
      for (int i = tid; i < p.Dm; i += kConsumers) ctx[i] = ctx_new[i];
      for (int i = tid; i < p.M; i += kConsumers) prev[i] = melv[(p.r - 1) * p.M + i];
    }
    if (t + 1 < p.S) stage_keep(t + 1);
    if (tid == 0) {
      p.fin[(size_t)b * p.S + t] = fin_old;
      float smax = stopv[0];
      for (int i = 1; i < p.r; ++i) smax = fmaxf(smax, stopv[i]);
      float hit = chain::sigmoidf_(smax) > p.stop_threshold ? 1.f : 0.f;
      if (p.min_steps > 0 && t < p.min_steps - 1) hit = 0.f;
      fin_s[0] = fmaxf(fin_old, hit);
    }
    stream::consumer_sync<kConsumers>();
  }
}

}  // namespace

extern "C" {

// Shared memory one block takes: the ring, then the buffers of the kernel's
// layout (the only count of it; the wrapper refuses a shape from it).
int sstts_decode_smem_bytes(const DecodeArgs* a) {
  const int Hm = a->Ha > a->Hd ? a->Ha : a->Hd;
  const int sizes[] = {kPartFloats, a->Ha, a->Hd, a->Hd, a->M, a->P0, a->P1 + a->Dm,
                       3 * Hm, 3 * Hm, a->Ha + a->Dm, a->A, a->Hd, a->Hd, a->Hd,
                       a->r * a->M, a->r, a->T, 33, 1, a->P0, a->P1};
  int floats = 0;
  for (int n : sizes) floats += (n + 3) & ~3;
  return Ring::kBytes + floats * 4;
}

// weights_bf16: 1 when every matrix, memory and keys are bf16, 0 for f32.
int sstts_fused_decode(const DecodeArgs* a, int weights_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_decode_smem_bytes(a);
  cudaError_t err;
  if (weights_bf16) {
    err = cudaFuncSetAttribute(fused_decode_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_decode_kernel<__nv_bfloat16><<<a->B, kThreads, smem, st>>>(*a);
  } else {
    err = cudaFuncSetAttribute(fused_decode_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_decode_kernel<float><<<a->B, kThreads, smem, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
