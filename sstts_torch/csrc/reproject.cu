// Banded frames-domain reprojection for Hopper (sm_90a): kernel B1.
//
// Replaces sstts/dsp/reproject.py:reproject_frames_pallas, the Pallas TPU
// kernel between the two DFT GEMMs of the "split" Griffin-Lim iteration:
//   out[t, j] = cast( wss2d[t, j] * sum_{d=-D..D} F[t-d, j+d*hop] ),
// summed in f32 in the Pallas kernel's order (d = 0 first, then d = -D..D
// without 0).  A term is zero where its source lane leaves [0, w_len) or its
// source row leaves [0, T); output lanes [w_len, wp) are zero.  bf16 or f32
// in, the same type out.  Then, in the same launch, the reflect-pad mirror
// runs (sstts_torch/dsp/reproject.py:band_plan), in run order: out[t, a:b] =
// flip(out[t_src, src_lo:src_hi]), where a run may read a row an earlier
// run wrote.  The JAX package applies them in XLA after its kernel.
//
// Bound on the H100: bytes.  At the split iteration's shapes (32 x 800
// frames, w_len = 1101 of wp = 1152 lanes, bf16) it needs to read 56 MB of
// frames and the 3.5 MB f32 envelope (lanes below w_len) and to write 59 MB
// (every lane): 0.0355 ms at 3.35 TB/s, against 8 adds and a multiply per
// element (0.25 GFLOP, 0.004 ms at 67 TFLOP/s f32).
//
// Design: a block walks down T over one strip of rows of one utterance
// (grid: strips x utterances, the host's choice: about one wave of the
// blocks the card holds at once, strips no shorter than the host's minimum,
// and every mirror run inside one strip).  One producer lane copies the
// strip's input rows, with D halo rows a side, in stages of G whole rows
// (one cp.async.bulk a stage) into a ring of NS stages in shared memory
// (sm90.cuh's mbarriers: "full" per stage, "empty" per stage with an arrival
// per consumer warp), ahead of the arithmetic; NS covers the 2 D + kRows
// rows a block of kRows output rows reads, so each input row leaves device
// memory once (its halo rows twice).  A consumer thread owns one 16-byte
// segment of a row (8 bf16 or 4 f32 lanes) in kRows output rows together:
// it loads the segment's envelope with 16-byte loads before it waits for
// its rows, adds the terms in order, and stores each row's segment with one
// 16-byte store.  A term's source segment is all inside the window support,
// all outside, or (at most two segments a term) across its edge: the test,
// the shift and the addresses are worked out once a term for the kRows
// rows, and only the edge segments test lane by lane.  In a block whose
// input rows all lie inside [0, T) (all but the edge blocks) no row is
// tested, and each row's ring address steps back a row a term.  The shift
// d*hop is odd for odd hops, so a source segment is misaligned; it is read
// with two aligned 16-byte loads, each lane's float taken from its word by
// one shift or mask.  After its rows are stored, a block whose strip holds
// edge rows applies their mirror runs in run order from the run table
// (int32, made once a geometry), a consumer barrier between runs.
//
// What holds it on an H100 (PERF.md §6; tools/ablate_reproject.py): the
// consumers' arithmetic, ~0.1 ms alone against ~0.04 ms for the stream
// alone.  None of these made it faster (PERF.md §6 gives the readings):
// other ring settings, more blocks an SM (smaller rings, a register cap),
// scalar loads of a misaligned segment, 1 or 2 rows a thread, consumer warp
// 0 as the producer, terms compiled for a fixed D.

// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "stream.cuh"  // lds128, lds32

extern "C" {

// Field order is mirrored by sstts_torch/dsp/reproject.py:_ReprojectArgs.
struct ReprojectArgs {
  const void* frames;  // (Bt, T, wp), bf16 or f32, 16-byte aligned
  const float* wss2d;  // (T, wp), zero beyond w_len and outside the signal
  const int* runs;     // (n_runs, 6) int32: t, a, b, t_src, src_lo, src_hi
  void* out;           // (Bt, T, wp), the frames' type
  int Bt, T, wp, w_len, hop, d_max;
  int strips;  // strips an utterance (grid.x)
  int group;   // rows a stage (G)
  int stages;  // stages in the ring (NS)
  int n_runs;
};

}  // extern "C"

namespace {

#ifndef SSTTS_ABLATE
#define SSTTS_ABLATE 0
#endif

// Most threads a block: consumers (a multiple of 32, up to kMaxThreads - 32,
// each owning every NT-th segment of a row) and one producer warp.
constexpr int kMaxThreads = 512;
// Output rows a consumer computes together (the host sizes the ring for
// them: sstts_reproject_rows).
constexpr int kRows = 4;
// SSTTS_ABLATE, at compile time, gives stage times (ablated builds compute
// garbage): 1 the stream alone (the consumers only wait for and release
// each stage); else a mask, 2 without the stream (no copies, no waiting),
// 4 without the terms d != 0.
constexpr int kAblate = SSTTS_ABLATE;
constexpr bool kStream = kAblate == 1 || (kAblate & 2) == 0;
constexpr bool kTerms = (kAblate & 4) == 0;

using stream::lds128;
__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}

// One element type: V lanes a 16-byte segment, its conversions, and the
// sum of one misaligned segment from two aligned ones.
template <typename T>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ float load1(uint32_t a) { return lo(lds16(a)); }
  static __device__ __forceinline__ void add(float (&acc)[8], const uint4& v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += lo(w[i]);
      acc[2 * i + 1] += hi(w[i]);
    }
  }
  // acc[m] += lane R + m of the 16 lanes of two aligned segments a:b; each
  // lane's float comes from its word by one shift or one mask.
  template <int R>
  static __device__ __forceinline__ void add_shifted(float (&acc)[8], const uint4& a,
                                                     const uint4& b) {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int m = 0; m < 8; ++m)
      acc[m] += ((R + m) & 1) ? hi(w[(R + m) >> 1]) : lo(w[(R + m) >> 1]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t l = __bfloat16_as_ushort(__float2bfloat16(v[2 * i]));
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1]));
      w[i] = l | (h << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Lanes<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float load1(uint32_t a) { return stream::lds32(a); }
  static __device__ __forceinline__ void add(float (&acc)[4], const uint4& v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  template <int R>
  static __device__ __forceinline__ void add_shifted(float (&acc)[4], const uint4& a,
                                                     const uint4& b) {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m] += __uint_as_float(w[R + m]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

// acc[i] += the segment R lanes past the aligned pair at ring address
// at[i] + off, for every row i whose bit is set in `rows`.
template <class L, int R>
__device__ __forceinline__ void add_rows(float (&acc)[kRows][L::V],
                                         const uint32_t (&at)[kRows], int rows, uint32_t off) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if ((rows >> i) & 1) L::template add_shifted<R>(acc[i], lds128(at[i] + off), lds128(at[i] + off + 16));
}

// One term d != 0 of the segment starting at lane j0, whose source segment
// starts at lane s0, added to the rows whose bit is set in `rows`; at[i] is
// the ring address of row i's input row t + i - d.  The source segment is
// all outside the window support (nothing to add), all inside (whole
// segments: one aligned pair a row), or across its edge (lane by lane).
template <class L>
__device__ __forceinline__ void add_term(float (&acc)[kRows][L::V], const uint32_t (&at)[kRows],
                                         int rows, int s0, int j0, int w_len, bool whole) {
  constexpr int V = L::V, ES = 16 / V;
  if (s0 + V <= 0 || s0 >= w_len) return;
  if (whole && s0 >= 0 && s0 + V <= w_len) {
    const int a = s0 & ~(V - 1);
    const uint32_t off = a * ES;
    switch (s0 - a) {  // the shift: uniform across the block
      case 0: add_rows<L, 0>(acc, at, rows, off); break;
      case 1: add_rows<L, 1>(acc, at, rows, off); break;
      case 2: add_rows<L, 2>(acc, at, rows, off); break;
      case 3: add_rows<L, 3>(acc, at, rows, off); break;
      case 4: if (V > 4) add_rows<L, (V > 4 ? 4 : 0)>(acc, at, rows, off); break;
      case 5: if (V > 4) add_rows<L, (V > 4 ? 5 : 0)>(acc, at, rows, off); break;
      case 6: if (V > 4) add_rows<L, (V > 4 ? 6 : 0)>(acc, at, rows, off); break;
      default: if (V > 4) add_rows<L, (V > 4 ? 7 : 0)>(acc, at, rows, off); break;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (!((rows >> i) & 1)) continue;
#pragma unroll
    for (int m = 0; m < V; ++m) {
      const int js = s0 + m;
      if (j0 + m < w_len && js >= 0 && js < w_len) acc[i][m] += L::load1(at[i] + js * ES);
    }
  }
}

// Rows [t0, t1) of utterance blockIdx.y, strip blockIdx.x; the ring holds
// the input rows [rlo, rhi) = [t0 - D, t1 + D) within [0, T): row r at ring
// row (r - rlo) % (NS G), stage (r - rlo) / G in slot stage % NS.  A
// consumer thread computes kRows output rows of its segment together: each
// term's tests, addresses and shift are worked out once for all of them.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) reproject_kernel(const ReprojectArgs p) {
  using L = Lanes<T>;
  constexpr int V = L::V;
  constexpr int ES = (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int NS = p.stages, G = p.group, D = p.d_max;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  unsigned char* ring = smem + 16 * NS;
  const int row_bytes = p.wp * ES;
  const int ring_rows = NS * G;
  const int NT = blockDim.x - 32;  // consumers
  const int tid = threadIdx.x, b = blockIdx.y, s = blockIdx.x;
  const int t0 = (int)((long long)s * p.T / p.strips);
  const int t1 = (int)((long long)(s + 1) * p.T / p.strips);
  const int rlo = max(0, t0 - D), rhi = min(p.T, t1 + D);
  const int n_rows = rhi - rlo;
  const size_t utt = (size_t)b * p.T * p.wp;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      sm90::mbar_init(full + i, 1);
      sm90::mbar_init(empty + i, NT / 32);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid >= NT) {  // the producer warp: one lane copies every stage,
    // each into its slot once every consumer warp has released the slot's
    // previous stage
    if (kStream && tid == NT) {
      const unsigned char* src = static_cast<const unsigned char*>(p.frames) +
                                 (utt + (size_t)rlo * p.wp) * ES;
      for (int i = 0; i * G < n_rows; ++i) {
        const int slot = i % NS;
        if (i >= NS) sm90::mbar_wait(empty + slot, ((i / NS) - 1) & 1);
        const uint32_t bytes = (uint32_t)min(G, n_rows - i * G) * row_bytes;
        sm90::mbar_expect_tx(full + slot, bytes);
        sm90::bulk_load(ring + (size_t)slot * G * row_bytes, src + (size_t)i * G * row_bytes,
                        bytes, full + slot);
      }
    }
    return;
  }

  const uint32_t ring_a = sm90::smem_u32(ring);
  const int nseg = row_bytes / 16, w_len = p.w_len, hop = p.hop;
  T* O = static_cast<T*>(p.out) + utt;
  // The envelope of a segment in rows t.. (V floats a row), 16 bytes a load.
  float wv[kRows][V];
  const auto load_wss = [&](int t, int nr, int j0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= nr) break;
      const float4* w4 = reinterpret_cast<const float4*>(p.wss2d + (size_t)(t + i) * p.wp + j0);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 x = __ldg(w4 + k);
        wv[i][4 * k] = x.x;
        wv[i][4 * k + 1] = x.y;
        wv[i][4 * k + 2] = x.z;
        wv[i][4 * k + 3] = x.w;
      }
    }
  };
  const uint32_t ring_bytes = (uint32_t)(ring_rows * row_bytes);
  const auto ring_row = [&](int pos) {  // address of ring row pos (one wrap)
    pos += pos < 0 ? ring_rows : (pos >= ring_rows ? -ring_rows : 0);
    return ring_a + (uint32_t)(pos * row_bytes);
  };
  int waited = 0;  // stages waited for
  for (int t = t0; t < t1; t += kRows) {
    const int nr = min(kRows, t1 - t);
    if (kAblate != 1 && tid * V < w_len) load_wss(t, nr, tid * V);  // off the wait's path
    if (kStream) {
      const int need = (min(t + nr - 1 + D, rhi - 1) - rlo) / G;
      for (; waited <= need; ++waited) sm90::mbar_wait(full + waited % NS, (waited / NS) & 1);
    }
    const int pos0 = (t - rlo) % ring_rows;  // ring row of input row t
    // Every row of the block and every input row it reads inside [0, T).
    const bool interior = nr == kRows && t >= D && t + kRows - 1 + D < p.T;
    for (int seg = tid; kAblate != 1 && seg < nseg; seg += NT) {
      const int j0 = seg * V;
      uint4 res[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) res[i] = make_uint4(0u, 0u, 0u, 0u);
      if (j0 < w_len) {
        if (seg != tid) load_wss(t, nr, j0);
        const bool whole = j0 + V <= w_len;  // every output lane inside
        float acc[kRows][V];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const uint32_t row = ring_row(pos0 + i);
#pragma unroll
          for (int m = 0; m < V; ++m) acc[i][m] = 0.f;
          if (i >= nr) continue;
          if (whole) {
            L::add(acc[i], lds128(row + j0 * ES));
          } else {
#pragma unroll
            for (int m = 0; m < V; ++m)
              if (j0 + m < w_len) acc[i][m] = L::load1(row + (j0 + m) * ES);
          }
        }
        if (kTerms && interior) {
          // Every input row t + i - d inside [0, T): no row tests, and the
          // ring address of row i's input row steps back a row a term
          // (two across d = 0).
          constexpr int kAll = (1 << kRows) - 1;
          uint32_t at[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) at[i] = ring_row(pos0 + i + D);  // d = -D
          for (int di = 1; di <= 2 * D; ++di) {
            const int d = di <= D ? di - 1 - D : di - D;  // -D..-1, then 1..D
            add_term<L>(acc, at, kAll, j0 + d * hop, j0, w_len, whole);
            const uint32_t back = d == -1 ? 2 * row_bytes : row_bytes;
#pragma unroll
            for (int i = 0; i < kRows; ++i)  // (unsigned: wrap before stepping)
              at[i] += (at[i] < ring_a + back ? ring_bytes : 0u) - back;
          }
        } else if (kTerms) {
          for (int di = 1; di <= 2 * D; ++di) {
            const int d = di <= D ? di - 1 - D : di - D;  // -D..-1, then 1..D
            int rows = 0;  // rows whose input row t + i - d lies in [0, T)
            uint32_t at[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const int r = t + i - d;
              if (i < nr && r >= 0 && r < p.T) rows |= 1 << i;
              at[i] = ring_row(pos0 + i - d);
            }
            add_term<L>(acc, at, rows, j0 + d * hop, j0, w_len, whole);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int m = 0; m < V; ++m) acc[i][m] = j0 + m < w_len ? acc[i][m] * wv[i][m] : 0.f;
          res[i] = L::pack(acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < nr) *reinterpret_cast<uint4*>(O + (size_t)(t + i) * p.wp + j0) = res[i];
    }
    // Input rows t - D .. t + nr - 1 - D are read for the last time: give a
    // stage back once its last row is done.
    if (kStream) {
      for (int i = 0; i < nr; ++i) {
        const int r = t + i - D - rlo;
        if (r >= 0 && (r + 1) % G == 0) {
          __syncwarp();
          if ((tid & 31) == 0) sm90::mbar_arrive(empty + (r / G) % NS);
        }
      }
    }
  }

  // The mirror runs whose rows lie in this strip (the host checks that a
  // run's source row lies in its target row's strip), in run order.
  bool any = false;
  for (int i = 0; i < p.n_runs; ++i) {
    const int* run = p.runs + 6 * i;
    if (run[0] < t0 || run[0] >= t1) continue;
    if (!any) sm90::named_barrier(1, NT);  // every row of the strip stored
    any = true;
    T* dst = O + (size_t)run[0] * p.wp + run[1];
    const T* src = O + (size_t)run[3] * p.wp + run[5] - 1;
    for (int k = tid; k < run[2] - run[1]; k += NT) dst[k] = src[-k];
    sm90::named_barrier(1, NT);
  }
}

// The direct configuration, for the shapes whose 2 D + kRows input rows no
// ring in shared memory holds (f32 rows of 2048 lanes at D >= 13: a 2048-
// sample window with a hop below 158 samples): the same function, sums and
// grid, with every term read from device memory (L2) and no shared memory.
// A thread takes the block's elements kDirectThreads apart, adds the terms in
// the same order, scales and casts; then the strip's mirror runs as above.
constexpr int kDirectThreads = 256;

using Kernel = void (*)(ReprojectArgs);

template <typename T>
__device__ __forceinline__ float as_f32(T v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(v); else return v;
}
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(v); else return v;
}

template <typename T>
__global__ void __launch_bounds__(kDirectThreads) reproject_direct_kernel(const ReprojectArgs p) {
  const int tid = threadIdx.x, b = blockIdx.y, s = blockIdx.x, D = p.d_max;
  const int t0 = (int)((long long)s * p.T / p.strips);
  const int t1 = (int)((long long)(s + 1) * p.T / p.strips);
  const size_t utt = (size_t)b * p.T * p.wp;
  const T* F = static_cast<const T*>(p.frames) + utt;
  T* O = static_cast<T*>(p.out) + utt;
  for (int e = tid; e < (t1 - t0) * p.wp; e += kDirectThreads) {
    const int t = t0 + e / p.wp, j = e % p.wp;
    float acc = 0.f;
    if (j < p.w_len) {
      for (int di = 0; di <= 2 * D; ++di) {
        const int d = di == 0 ? 0 : (di <= D ? di - 1 - D : di - D);  // 0, -D..-1, 1..D
        const int u = t - d, l = j + d * p.hop;
        if (u >= 0 && u < p.T && l >= 0 && l < p.w_len) acc += as_f32(F[(size_t)u * p.wp + l]);
      }
      acc *= p.wss2d[(size_t)t * p.wp + j];
    }
    O[(size_t)t * p.wp + j] = from_f32<T>(acc);
  }
  for (int i = 0; i < p.n_runs; ++i) {
    const int* run = p.runs + 6 * i;
    if (run[0] < t0 || run[0] >= t1) continue;
    __syncthreads();  // every row of the strip, and the run before, stored
    T* dst = O + (size_t)run[0] * p.wp + run[1];
    const T* src = O + (size_t)run[3] * p.wp + run[5] - 1;
    for (int k = tid; k < run[2] - run[1]; k += kDirectThreads) dst[k] = src[-k];
  }
}

Kernel direct_kernel_for(int is_bf16) {
  return is_bf16 ? reproject_direct_kernel<__nv_bfloat16> : reproject_direct_kernel<float>;
}

int consumer_threads(int wp, int elem_bytes) {
  const int nseg = wp * elem_bytes / 16;
  const int nt = (nseg + 31) / 32 * 32;
  return nt < kMaxThreads - 32 ? nt : kMaxThreads - 32;
}

Kernel kernel_for(int is_bf16) {
  return is_bf16 ? reproject_kernel<__nv_bfloat16> : reproject_kernel<float>;
}

}  // namespace

extern "C" {

// Shared memory one block takes: the barriers, the ring, and 16 bytes that
// the last row's aligned pair of loads may read past its end (the only
// count of it; the wrapper refuses a shape from it).
int sstts_reproject_smem_bytes(int wp, int elem_bytes, int group, int stages) {
  return 16 * stages + stages * group * wp * elem_bytes + 16;
}

// Output rows a consumer thread computes together.
int sstts_reproject_rows() { return kRows; }

// Threads a block: the consumers and the producer warp.
int sstts_reproject_threads(int wp, int elem_bytes) {
  return consumer_threads(wp, elem_bytes) + 32;
}

// Blocks of this shape one SM holds at once (the wrapper sizes the grid to
// about one wave), or -1 on an error.
int sstts_reproject_blocks_per_sm(const ReprojectArgs* a, int is_bf16) {
  const int es = is_bf16 ? 2 : 4;
  const int smem = sstts_reproject_smem_bytes(a->wp, es, a->group, a->stages);
  const Kernel k = kernel_for(is_bf16);
  int n = -1;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, sstts_reproject_threads(a->wp, es),
                                                        smem);
  return err == cudaSuccess ? n : -1;
}

// Requires wp % 8 == 0, 16-byte aligned frames and out, and
// sstts_reproject_smem_bytes(...) <= 232448.
int sstts_reproject(const ReprojectArgs* a, int is_bf16, void* stream) {
  const int es = is_bf16 ? 2 : 4;
  const int smem = sstts_reproject_smem_bytes(a->wp, es, a->group, a->stages);
  const Kernel k = kernel_for(is_bf16);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  k<<<dim3(a->strips, a->Bt), sstts_reproject_threads(a->wp, es), smem, st>>>(*a);
  return (int)cudaGetLastError();
}

// The direct configuration: blocks an SM holds (of kDirectThreads threads,
// no shared memory), or -1.
int sstts_reproject_direct_blocks_per_sm(int is_bf16) {
  int n = -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, direct_kernel_for(is_bf16), kDirectThreads, 0);
  return err == cudaSuccess ? n : -1;
}

// Requires 16-byte aligned frames and out; any wp.
int sstts_reproject_direct(const ReprojectArgs* a, int is_bf16, void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  direct_kernel_for(is_bf16)<<<dim3(a->strips, a->Bt), kDirectThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
