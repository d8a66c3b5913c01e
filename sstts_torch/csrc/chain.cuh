// The decoder cell's step chain, shared by kernel B4 (decoder.cu, the
// autoregressive decode: its steps 2-4) and kernel B6 (teacher.cu, the
// teacher-forced scan: its whole step): the attention GRU over [prenet,
// context], Bahdanau attention (the query, the scores from the rows of keys,
// a masked softmax in f32, the context from the rows of memory), the decoder
// projection of [h, context] and two residual GRUs.  Every operand comes
// through the ring of stream.cuh in the order of the host's schedule
// (sstts_torch/ops/decoder.py:step_products): attn_wx, attn_wh, query_w,
// keys, memory, dec_w, gru0_wx, gru0_wh, gru1_wx, gru1_wh.  Products take
// both operands rounded to the matmul dtype WT with f32 accumulation; gates
// and softmax are f32, as in the Pallas kernels.  Only the consumer warps
// call these functions; each ends after a consumer barrier.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "stream.cuh"

namespace chain {

// The ring both kernels stream through: kStages stages of kStageBytes (the
// host's schedule cuts its chunks to that size: ops/decoder.py:STAGE_BYTES),
// kConsumerWarps consumer warps and one producer warp; a product wider than
// kMaxCols columns comes in column panels of at most kMaxCols
// (ops/decoder.py:panels, stream::matvec).
constexpr int kStages = 2;
constexpr int kStageBytes = 64 * 1024;
constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxCols = 1024;
static_assert(kStageBytes >= 4 * kMaxCols, "a stage holds a panel's row of f32");
static_assert(kConsumers >= kMaxCols / 4, "a consumer a 16-byte segment of a panel's row");
// Split-K partials: G groups x the padded width, at most 8 floats a consumer.
constexpr int kPartFloats = 8 * kConsumers;

// The ring; Stream false gives a build without copies (SSTTS_ABLATE).
template <bool Stream>
using Ring = stream::Ring<kStages, kStageBytes, kConsumerWarps, Stream>;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// The chain's state and scratch in shared memory (floats), one utterance.
struct Buffers {
  float* part;    // split-K partials
  float* attn_h;  // Ha, attention-GRU carry
  float* h0;      // Hd, decoder-GRU carries
  float* h1;
  float* xin;     // P1 + Dm: [prenet, context carry]
  float* gx;      // 3 max(Ha, Hd)
  float* gh;
  float* dproj;   // Ha + Dm: [h_a new, context new]
  float* q;       // A
  float* d;       // Hd: the step's feature
  float* h0n;     // Hd
  float* h1n;
  float* sc;      // T: scores, then alignment
  float* red;     // 33: reduction scratch
};

// The f32 vectors the chain adds (biases) and the score vector v.
struct Vectors {
  const float* attn_b;
  const float* score_v;
  const float* score_b;
  const float* dec_b;
  const float* gru0_b;
  const float* gru1_b;
};

template <typename WT, bool kMath, class R>
struct Chain {
  static constexpr int C = R::kConsumers;
  const R& ring;
  stream::Cursor& cur;
  const stream::Chunk* __restrict__ sched;
  int n;  // chunks in the schedule

  // One product of the stream into `out` (+ bias), its input x.
  __device__ __forceinline__ void product(const float* x, int N, const float* bias, float* out,
                                          float* part) const {
    stream::matvec<WT, true, kMath>(ring, cur, sched, n, x, N, part,
                                    [&](int j, float s) { out[j] = bias ? s + bias[j] : s; });
  }

  // One GRU step: gx = x @ wx + b, gh = h @ wh, then the gates; `post` (may
  // be NULL) receives post[i] += h_new[i] (the residual connection).
  __device__ __forceinline__ void gru(const Buffers& s, const float* x, const float* h, int H,
                                      const float* bias, float* h_new, float* post) const {
    product(x, 3 * H, bias, s.gx, s.part);
    product(h, 3 * H, nullptr, s.gh, s.part);
    const float* gx = s.gx;
    const float* gh = s.gh;
    for (int i = threadIdx.x; i < H; i += C) {
      const float r = sigmoidf_(gx[i] + gh[i]);
      const float z = sigmoidf_(gx[H + i] + gh[H + i]);
      const float nn = tanhf(gx[2 * H + i] + r * gh[2 * H + i]);
      const float hn = z * h[i] + (1.f - z) * nn;
      h_new[i] = hn;
      if (post) post[i] += hn;
    }
    stream::consumer_sync<C>();
  }

  // The chain of one step on s.xin = [prenet, context carry] and the
  // carries: writes h_a and the context into s.dproj, the alignment into
  // s.sc and align_out (T floats), the new decoder carries into s.h0n and
  // s.h1n and the step's feature into s.d.  The carries are left as they
  // were: the caller moves them.
  __device__ __forceinline__ void step(const Buffers& s, const Vectors& v, int T, int Dm, int A,
                                       int Ha, int Hd, const float* mask,
                                       float* align_out) const {
    const int tid = threadIdx.x;
    float* ha_new = s.dproj;
    float* ctx_new = s.dproj + Ha;
    float* sc = s.sc;

    // Attention GRU over [prenet, context].
    gru(s, s.xin, s.attn_h, Ha, v.attn_b, ha_new, nullptr);

    // Bahdanau attention: the query, the scores from the rows of keys, the
    // softmax, the context from the rows of memory.
    product(ha_new, A, v.score_b, s.q, s.part);
    stream::scores<WT>(ring, cur, sched, n, s.q, v.score_v, A, mask, sc);
    float local = -CUDART_INF_F;
    for (int tt = tid; tt < T; tt += C) local = fmaxf(local, sc[tt]);
    const float mx = stream::consumer_reduce<C>(local, s.red, true);
    local = 0.f;
    for (int tt = tid; tt < T; tt += C) {
      const float e = expf(sc[tt] - mx);
      sc[tt] = e;
      local += e;
    }
    const float sum = stream::consumer_reduce<C>(local, s.red, false);
    for (int tt = tid; tt < T; tt += C) {
      const float a = sc[tt] / sum;
      sc[tt] = a;
      align_out[tt] = a;
    }
    stream::consumer_sync<C>();
    stream::matvec<WT, false, kMath>(ring, cur, sched, n, sc, Dm, s.part,
                                     [&](int j, float x) { ctx_new[j] = x; });

    // Decoder projection and two residual GRUs.
    product(s.dproj, Hd, v.dec_b, s.d, s.part);
    gru(s, s.d, s.h0, Hd, v.gru0_b, s.h0n, s.d);
    gru(s, s.d, s.h1, Hd, v.gru1_b, s.h1n, s.d);
  }
};

}  // namespace chain
