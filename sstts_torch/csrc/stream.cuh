// The weight stream of kernel B4 (decoder.cu): a ring of shared-memory
// stages that one producer lane fills with cp.async.bulk copies, walking a
// schedule of chunks made on the host (sstts_torch/ops/decoder.py:
// chunk_schedule), and the consumer warps' side of it: the split-K
// matrix-vector product whose weights come from the stages, the Bahdanau
// scores over the rows of `keys`, and a reduction over the consumers.
//
// Why: a decoder step reads the whole cell (3.3 MB in bf16) and one
// utterance's keys and memory.  Per-thread loads from L2 keep ~16 KB in
// flight on an SM and are bound by L2's latency; the order of the bytes a
// step reads never depends on the data, so one producer can run a whole
// ring ahead, across product and step boundaries, with no thread spending
// registers or instructions on the copies.
//
// Protocol: stage s has a "full" barrier (one arrival, the producer's
// expect_tx, plus the copy's bytes) and an "empty" barrier (one arrival per
// consumer warp).  Every consumer thread waits on "full", reads, and its
// warp arrives on "empty" once; the producer waits on "empty" before it
// reuses a stage.  Consumers synchronise among themselves with named
// barrier 1; the producer warp takes part in no barrier after the start.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

namespace stream {

// One row of the schedule (ops/decoder.py:CHUNK_FIELDS): `bytes` bytes at
// `offset` of source `src` (0 the packed weights, 1 this utterance's keys,
// 2 its memory), rows [k0, k1) of product `product`, `row_bytes` apart, of
// the column panel that starts at the product's column `col0` (0 for a
// product of one panel).
struct alignas(16) Chunk {
  int src, product, offset, bytes, k0, k1, row_bytes, col0;
};

// Where a consumer stands: the stage and its phase parity, and the index of
// the chunk that stage holds.
struct Cursor {
  int stage;
  uint32_t phase;
  int chunk;
};

// kWait false (an ablation) makes the consumers neither wait for nor
// release a stage.
template <int Stages, int StageBytes, int ConsumerWarps, bool kWait = true>
struct Ring {
  static constexpr int kConsumers = 32 * ConsumerWarps;
  // Shared memory: the 2 * Stages barriers in 256 bytes, then the stages.
  static constexpr int kBytes = 256 + Stages * StageBytes;
  static_assert(2 * Stages * 8 <= 256, "too many stages");
  static_assert(StageBytes % 16 == 0, "stages are whole 16-byte units");

  uint64_t* full;
  uint64_t* empty;
  unsigned char* buf;

  __device__ explicit Ring(unsigned char* smem)
      : full(reinterpret_cast<uint64_t*>(smem)),
        empty(reinterpret_cast<uint64_t*>(smem) + Stages),
        buf(smem + 256) {}

  // By one thread, before a block-wide barrier.
  __device__ void init() const {
    for (int s = 0; s < Stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, ConsumerWarps);
    }
    sm90::fence_barrier_init();
  }

  // The producer: `steps` walks over the schedule's `n` chunks.  A chunk of
  // keys or memory lies `offset` bytes into its tensor (for memory in column
  // panels, into its panel's block of rows) and `first_row` rows (this
  // utterance's first row) beyond.
  __device__ void produce(const Chunk* __restrict__ sched, int n, int steps,
                          const unsigned char* weights, const unsigned char* keys,
                          const unsigned char* memory, size_t first_row) const {
    int stage = 0;
    uint32_t phase = 0;
    bool reuse = false;
    for (int t = 0; t < steps; ++t) {
      for (int i = 0; i < n; ++i) {
        const Chunk c = sched[i];
        const unsigned char* base =
            c.src == 0 ? weights
                       : (c.src == 1 ? keys : memory) + first_row * c.row_bytes;
        if (reuse) sm90::mbar_wait(empty + stage, phase ^ 1);
        sm90::mbar_expect_tx(full + stage, c.bytes);
        sm90::bulk_load(buf + stage * StageBytes, base + c.offset, c.bytes,
                        full + stage);
        if (++stage == Stages) {
          stage = 0;
          phase ^= 1;
          reuse = true;
        }
      }
    }
  }

  __device__ __forceinline__ const unsigned char* acquire(const Cursor& cur) const {
    if (kWait) sm90::mbar_wait(full + cur.stage, cur.phase);
    return buf + cur.stage * StageBytes;
  }
  // Gives the stage back (one arrival from the warp) and moves the cursor
  // to the next chunk, from the schedule's end to its start.
  __device__ __forceinline__ void release(Cursor& cur, int n) const {
    if (kWait) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(empty + cur.stage);
    }
    if (++cur.stage == Stages) {
      cur.stage = 0;
      cur.phase ^= 1;
    }
    cur.chunk = cur.chunk + 1 == n ? 0 : cur.chunk + 1;
  }
};

template <int Consumers>
__device__ __forceinline__ void consumer_sync() {
  sm90::named_barrier(1, Consumers);
}

// Most K groups a product splits over (a narrow product's partial sums are
// then few to add).
constexpr int kMaxGroups = 32;

// 16 bytes of a row as floats (8 bf16 or 4 f32), and an activation rounded
// to the matmul dtype.
template <typename WT>
struct Seg;
template <>
struct Seg<__nv_bfloat16> {
  static constexpr int kValues = 8;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Seg<float> {
  static constexpr int kValues = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

// Shared-memory loads by 32-bit address (the stages and the state are
// shared; a generic load would spend 64-bit arithmetic on each address).
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ float lds32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// acc[j] += x * w[j] over one 16-byte segment.
template <typename WT>
__device__ __forceinline__ void fma_seg(float (&acc)[Seg<WT>::kValues], float x,
                                        const uint4& v) {
  float f[Seg<WT>::kValues];
  Seg<WT>::unpack(v, f);
#pragma unroll
  for (int j = 0; j < Seg<WT>::kValues; ++j) acc[j] = fmaf(x, f[j], acc[j]);
}

// Runs `epi(n, sum_k xr(x[k]) * W[k, n])` for n in [0, N), W the product
// whose chunks come next in the ring; xr rounds to WT when kRoundX (as
// JAX's dot(x.astype(dt), w.astype(dt)) does), else leaves x as it is.
// A product wider than a panel (kMaxCols in chain.cuh) comes as its column
// panels one after the other, each a run of chunks over all K rows that
// carry the panel's first column (col0): one pass below a panel, its
// columns col0 + n through the epilogue; a panel ends where the next chunk
// starts another column or another product, and is as wide as the next
// panel's col0 says (the last: up to N).
// Thread t of the consumers owns the 16-byte column segment t % nseg of a
// row and the rows g, g + G, ... of every chunk, g = t / nseg: a warp reads
// consecutive 16-byte segments of the stage, free of bank conflicts, and
// has four rows' loads in flight before their multiply-adds.  (Blocks of
// four consecutive rows a thread, their activations in one load, ran 6%
// slower on an H100: fewer groups share a short product, and rows four
// apart collide in the banks where a row is narrower than the warp.)  The
// G groups' partial sums meet in `part` (at most 8 floats a consumer) and
// are added by a tree: tpc threads a column, then shuffles.  kMath false (an
// ablation) skips the multiply-adds and their loads.  Every consumer calls
// it; on return the epilogue's writes are visible.
template <typename WT, bool kRoundX, bool kMath = true, class R, class Epi>
__device__ __forceinline__ void matvec(const R& ring, Cursor& cur,
                                       const Chunk* __restrict__ sched, int n_chunks,
                                       const float* x, int N, float* part, Epi epi) {
  constexpr int EPL = Seg<WT>::kValues;
  constexpr int C = R::kConsumers;
  const int tid = threadIdx.x;
  const int product = sched[cur.chunk].product;
  const uint32_t xa = sm90::smem_u32(x);
  const auto xr = [&](int k) {
    const float v = lds32(xa + 4 * k);
    return kRoundX ? Seg<WT>::round(v) : v;
  };
  for (;;) {  // one column panel a pass
    Chunk c = sched[cur.chunk];
    const int col0 = c.col0;
    const int row_bytes = c.row_bytes;
    const int nseg = row_bytes >> 4;
    const int G = min(C / nseg, kMaxGroups);
    const int g = tid / nseg, seg = tid - g * nseg;
    const bool active = g < G;
    float acc[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[j] = 0.f;
    Chunk nx;
    for (;;) {
      const unsigned char* st = ring.acquire(cur);
      nx = sched[cur.chunk + 1 == n_chunks ? 0 : cur.chunk + 1];
      if (active && kMath) {
        const int step = G * row_bytes;
        uint32_t a = sm90::smem_u32(st) + g * row_bytes + seg * 16;
        int k = c.k0 + g;
        for (; k + 3 * G < c.k1; k += 4 * G, a += 4 * step) {
          const uint4 v0 = lds128(a), v1 = lds128(a + step);
          const uint4 v2 = lds128(a + 2 * step), v3 = lds128(a + 3 * step);
          const float x0 = xr(k), x1 = xr(k + G), x2 = xr(k + 2 * G), x3 = xr(k + 3 * G);
          fma_seg<WT>(acc, x0, v0);
          fma_seg<WT>(acc, x1, v1);
          fma_seg<WT>(acc, x2, v2);
          fma_seg<WT>(acc, x3, v3);
        }
        for (; k < c.k1; k += G, a += step) fma_seg<WT>(acc, xr(k), lds128(a));
      }
      ring.release(cur, n_chunks);
      if (nx.product != product || nx.col0 != col0) break;
      c = nx;
    }
    const bool more = nx.product == product;  // another panel follows
    const int cols = (more ? nx.col0 : N) - col0;
    const int ld = nseg * EPL;
    if (active) {
      float4* pp = reinterpret_cast<float4*>(part + g * ld + seg * EPL);
#pragma unroll
      for (int j = 0; j < EPL / 4; ++j)
        pp[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    consumer_sync<C>();
    // tpc (a power of two, at most 32) consecutive lanes a column, each
    // adding every tpc-th group, then a shuffle tree.
    int tpc = 1;
    while (tpc < 32 && 2 * tpc <= G && 2 * tpc * cols <= C) tpc *= 2;
    for (int base = 0; base < cols * tpc; base += C) {
      const int i = base + tid, n = i / tpc, sub = i % tpc;
      float s = 0.f;
      if (n < cols)
        for (int gg = sub; gg < G; gg += tpc) s += part[gg * ld + n];
      for (int o = tpc / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0 && n < cols) epi(col0 + n, s);
    }
    consumer_sync<C>();
    if (!more) return;
  }
}

// Bahdanau scores from the chunks of `keys` that come next in the ring:
// sc[t] = sum_a tanh(keys[t, a] + q[a]) * v[a], or -1e9 where mask[t] is 0.
// One warp a row of keys, as the first port's kernel had it; f32 throughout.
template <typename WT, class R>
__device__ __forceinline__ void scores(const R& ring, Cursor& cur, const Chunk* __restrict__ sched,
                       int n_chunks, const float* q, const float* v, int A,
                       const float* mask, float* sc) {
  constexpr int EPL = Seg<WT>::kValues;
  constexpr int C = R::kConsumers;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Chunk c = sched[cur.chunk];
  const int product = c.product;
  const int nseg = c.row_bytes >> 4;
  for (;;) {
    const unsigned char* st = ring.acquire(cur);
    const Chunk nx = sched[cur.chunk + 1 == n_chunks ? 0 : cur.chunk + 1];
    for (int r = warp; r < c.k1 - c.k0; r += C / 32) {
      float s = 0.f;
      for (int sg = lane; sg < nseg; sg += 32) {
        float f[EPL];
        Seg<WT>::unpack(lds128(sm90::smem_u32(st) + r * c.row_bytes + sg * 16), f);
#pragma unroll
        for (int j = 0; j < EPL; ++j) {
          const int a = sg * EPL + j;
          if (a < A) s += tanhf(f[j] + q[a]) * v[a];
        }
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        const int t = c.k0 + r;
        sc[t] = mask[t] > 0.f ? s : -1e9f;
      }
    }
    ring.release(cur, n_chunks);
    if (nx.product != product) break;
    c = nx;
  }
  consumer_sync<C>();
}

// Max or sum of one value from every consumer; `red` holds 33 floats.
template <int Consumers>
__device__ float consumer_reduce(float v, float* red, bool is_max) {
  constexpr int kWarps = Consumers / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  consumer_sync<Consumers>();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : (is_max ? -CUDART_INF_F : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[32] = v;
  }
  consumer_sync<Consumers>();
  const float out = red[32];
  consumer_sync<Consumers>();
  return out;
}

}  // namespace stream
