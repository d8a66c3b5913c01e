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
// Bound on the H100: not arithmetic (a step is ~1.5 M multiply-adds an
// utterance) but moving the step's weights to the SM.  The eight matrices
// (2.9 MB in bf16) exceed one SM's shared memory, so every step reads them,
// and the utterance's keys and memory, from L2, where they stay resident.
//
// Design: B4's (decoder.cu) without the prenet, the projections and the stop
// logic, from the same parts.  The host packs the eight matrices in the
// order a step reads them, rows padded to 16 bytes (one device copy a
// forward: the weights change every train step), and cuts them with the
// utterance's keys and memory into a schedule of chunks of whole rows
// (sstts_torch/ops/decoder.py: pack_weights, step_products, chunk_schedule;
// the schedule depends on the shapes only and is made once for each).  One
// block per utterance: one producer lane walks the schedule S times with
// cp.async.bulk into a ring of shared-memory stages (stream.cuh); 16
// consumer warps run the chain (chain.cuh, B4's steps 2-4) on the stages and
// the state in shared memory.  The next step's prenet row is loaded with the
// carries.  Limits: any B (one block each); any product width (in column
// panels of at most kMaxCols = 1024, as B4); T up to what shared memory
// holds beside the ring (T floats of scores), by the library's own count
// (sstts_teacher_smem_bytes).
//
// SSTTS_ABLATE, at compile time, gives stage times as in decoder.cu: 1 the
// stream alone, else a mask: 2 without the stream, 4 without the products'
// multiply-adds.  Ablated builds compute garbage.

// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "stream.cuh"

#ifndef SSTTS_ABLATE
#define SSTTS_ABLATE 0
#endif

extern "C" {

// Field order is mirrored by sstts_torch/ops/teacher.py:_TeacherArgs.
struct TeacherArgs {
  const void* packed;    // the eight matrices, rows padded to 16 bytes
  const void* schedule;  // (n_chunks, 8) int32, stream::Chunk
  const float* attn_b;
  const float* score_v;
  const float* score_b;
  const float* dec_b;
  const float* gru0_b;
  const float* gru1_b;
  const float* pre;    // (B, S, P1) f32 prenet outputs
  const void* memory;  // (B, T, Dm) matmul dtype, rows padded to 16 bytes,
                       // in column panels past kMaxCols (decoder.memory_panels)
  const void* keys;    // (B, T, A) matmul dtype, rows padded to 16 bytes
  const float* mask;   // (B, T) {0, 1}
  float* xs;           // (B, S, Hd)
  float* align;        // (B, S, T)
  int B, T, S, P1, Dm, A, Ha, Hd;
  int n_chunks;
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
teacher_scan_kernel(const TeacherArgs p) {
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
  // Shared-memory layout (floats) after the ring; every buffer starts
  // 16-byte aligned (the partials are stored as float4).
  float* next = reinterpret_cast<float*>(smem + Ring::kBytes);
  auto take = [&](int floats) {
    float* at = next;
    next += (floats + 3) & ~3;
    return at;
  };
  chain::Buffers s;
  s.part = take(kPartFloats);
  s.attn_h = take(p.Ha);
  s.h0 = take(p.Hd);
  s.h1 = take(p.Hd);
  s.xin = take(p.P1 + p.Dm);  // [prenet, context carry]
  s.gx = take(3 * Hm);
  s.gh = take(3 * Hm);
  s.dproj = take(p.Ha + p.Dm);  // [h_a new, context new]
  s.q = take(p.A);
  s.d = take(p.Hd);
  s.h0n = take(p.Hd);
  s.h1n = take(p.Hd);
  s.sc = take(p.T);
  s.red = take(33);
  float* ctx = s.xin + p.P1;  // the context carry lives inside xin
  const float* ha_new = s.dproj;
  const float* ctx_new = s.dproj + p.Ha;
  const float* pre = p.pre + (size_t)b * p.S * p.P1;

  for (int i = tid; i < p.Ha; i += kConsumers) s.attn_h[i] = 0.f;
  for (int i = tid; i < p.Hd; i += kConsumers) s.h0[i] = s.h1[i] = 0.f;
  for (int i = tid; i < p.Dm; i += kConsumers) ctx[i] = 0.f;
  for (int i = tid; i < p.P1; i += kConsumers) s.xin[i] = pre[i];
  stream::consumer_sync<kConsumers>();

  const float* mask = p.mask + (size_t)b * p.T;
  const chain::Chain<WT, kMath, Ring> ch{ring, cur, sched, n};
  const chain::Vectors vecs{p.attn_b, p.score_v, p.score_b, p.dec_b, p.gru0_b, p.gru1_b};

  for (int t = 0; t < p.S; ++t) {
    const size_t row = (size_t)b * p.S + t;
    ch.step(s, vecs, p.T, p.Dm, p.A, p.Ha, p.Hd, mask, p.align + row * p.T);

    // The step's feature, the carries, and the next step's prenet row.
    float* xs_out = p.xs + row * p.Hd;
    for (int i = tid; i < p.Ha; i += kConsumers) s.attn_h[i] = ha_new[i];
    for (int i = tid; i < p.Hd; i += kConsumers) {
      s.h0[i] = s.h0n[i];
      s.h1[i] = s.h1n[i];
      xs_out[i] = s.d[i];
    }
    for (int i = tid; i < p.Dm; i += kConsumers) ctx[i] = ctx_new[i];
    if (t + 1 < p.S)
      for (int i = tid; i < p.P1; i += kConsumers) s.xin[i] = pre[(size_t)(t + 1) * p.P1 + i];
    stream::consumer_sync<kConsumers>();
  }
}

}  // namespace

extern "C" {

// Shared memory one block takes: the ring, then the buffers of the kernel's
// layout (the only count of it; the wrapper refuses a shape from it).
int sstts_teacher_smem_bytes(const TeacherArgs* a) {
  const int Hm = a->Ha > a->Hd ? a->Ha : a->Hd;
  const int sizes[] = {kPartFloats, a->Ha, a->Hd, a->Hd, a->P1 + a->Dm, 3 * Hm, 3 * Hm,
                       a->Ha + a->Dm, a->A, a->Hd, a->Hd, a->Hd, a->T, 33};
  int floats = 0;
  for (int n : sizes) floats += (n + 3) & ~3;
  return Ring::kBytes + floats * 4;
}

// weights_bf16: 1 when every matrix, memory and keys are bf16, 0 for f32.
int sstts_fused_teacher_scan(const TeacherArgs* a, int weights_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_teacher_smem_bytes(a);
  cudaError_t err;
  if (weights_bf16) {
    err = cudaFuncSetAttribute(teacher_scan_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    teacher_scan_kernel<__nv_bfloat16><<<a->B, kThreads, smem, st>>>(*a);
  } else {
    err = cudaFuncSetAttribute(teacher_scan_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    teacher_scan_kernel<float><<<a->B, kThreads, smem, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
