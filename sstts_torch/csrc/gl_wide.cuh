// The wide configuration of the Griffin-Lim kernels B2 (gl_semi.cu) and B5
// (gl_fused.cu): every geometry of a window of up to 2048 samples (n_fft up
// to 2048) with up to 16 overlapping frames a side, in the bf16 loop and in
// the f32 loop, momentum included (B2).  The wrappers take it where the
// whole-panel configuration of gl_tail.cuh does not fit
// (sstts_torch/dsp/gl_tiles.py:config, a pure function of the geometry and
// the loop dtype, chosen before any launch): a support above 1152 lanes (a
// 24 kHz or 44.1 kHz window), more than 8 overlapping frames for B2 or 4 for
// B5 (short hops), and the f32 loop.  It computes what gl_tail.cuh's tail
// computes, with the same sums in the same order:
//   A[t, j] = OT( wss2d[t, j] * sum_{d=-D..D} F[t-d, j+d*hop] )  (d = 0 first),
//   S = A @ w_fwd,  q' = renorm(S [+ momentum]),
// where OT is the loop dtype, and for B5 F = q[rows - D .. rows + D] @ w_inv
// in f32 in front.
//
// Why not the whole-panel core.  That core keeps the 64 x K panel resident in
// shared memory beside a 160 KB ring: 230,656 bytes at the default support,
// 1,792 under the card's limit, so a 24 kHz support (1199 lanes) is already
// over, a 2047-lane bf16 panel alone is 256 KB and an f32 panel at the
// default support 288 KB.  Its F rows pass through four groups of one ring
// (D <= 8 bf16 rows, 4 f32 rows).  Streaming the panel in K pieces instead,
// rebuilt for each of GEMM2's column tiles, re-reads the 64 + 2D rows of F
// 2D + 1 times a tile: with w_fwd's 4.5 MB, 15.9 MB from L2 per block of 64
// frames at the defaults and 60.3 MB at D = 16, against 7.1 and 10.5 MB for
// the design below (bf16; tests/test_torch_gl_tiles.py:l2_bytes_per_block
// reckons both).
// Here the panel is built once per block of 64 frames, as in the
// whole-panel core, but into a slab of device memory that stays in L2 (one
// slab per resident block, 64 x wp values of the loop dtype), and each of
// GEMM2's column tiles streams it back like the weights.  Shared memory is
// then a fixed 76,800 bytes whatever the support.
//
// Design: 256 threads (8 warps: 2 along the rows, 4 along the columns), a
// persistent grid of one block per slab, each walking work items (64 frames
// of one utterance) in turn.  The products are warp-level mma.sync on the
// tensor cores: bf16 m16n8k16 in the bf16 loop; in the f32 loop three tf32
// m16n8k8 products of the hi/lo split (hi*lo' + lo*hi' + hi*hi'), which carry
// a product to about 2^-21 of its size, where one tf32 product gives 2^-11
// (the reference's f32 loop runs Precision.HIGH or HIGHEST).  Both operands
// of a stage come through a 3-deep cp.async ring of 64 bytes of K per row,
// rows padded to 80 bytes so that the fragment loads hit 32 different banks.
// GEMM2's column tile is 128 bins' real and imaginary columns, so a thread
// holds re and im of the same bins and the renorm (and the momentum step)
// happen in registers as in the whole-panel core.  B5's GEMM1 computes the
// 64 + 2D <= 96 rows of F into the f32 part of the block's slab, 128 lanes a
// column tile over K = 2 hp; the panel is built from there.
//
// Bound, as gl_semi.cu and gl_fused.cu state: operations.  This
// configuration is not the fast one: it runs where the whole-panel core
// cannot, and its times stand in PERF.md beside their bounds.

#pragma once

#include "gl_tail.cuh"

namespace wide {

constexpr int kThreads = 256;                  // 8 warps: 2 x 4
constexpr int kRows = 64;                      // frames a work item (GEMM2's rows)
constexpr int kG1Rows = 96;                    // GEMM1's rows: 64 + 2 D, D <= 16
constexpr int kMaxD = 16;
constexpr int kMaxLanes = 2048;                // wp: a window of up to 2048 samples
constexpr int kBins = 128;                     // bins of a GEMM2 column tile (re + im)
constexpr int kLanes = 128;                    // lanes of a GEMM1 column tile
constexpr int kKBytes = 64;                    // bytes of K of an operand row a stage
constexpr int kRowBytes = kKBytes + 16;        // padded against bank conflicts
constexpr int kStageRows = kRows + 2 * kBins;  // GEMM2's 64 + 256; GEMM1's 96 + 128
constexpr int kStages = 3;
constexpr int kStageBytes = kStageRows * kRowBytes;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kKAlign = 32;                    // GEMM2's K: the support rounded up

// Bytes of one block's slab: (B5) GEMM1's f32 frames, kG1Rows x wp, then the
// panel, kRows x wp values of the loop dtype.
inline __host__ __device__ size_t slab_bytes(int wp, int elem_bytes, bool fused) {
  return (fused ? (size_t)kG1Rows * wp * 4 : 0) + (size_t)kRows * wp * elem_bytes;
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float from_f32(float v) { return v; }

// Two neighbouring values of the loop dtype (an even offset) as f32, and back.
__device__ __forceinline__ float2 load2(const bf16* p) {
  return unpack2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc (this warp's MW x NW tiles of 16 x 8) = A (rows, K) @ B (cols, K)^T over
// K (a multiple of a stage's 64 / sizeof(OT) values), both operands K-major
// in device memory: a_row(r) and b_row(c) give the first value of operand row
// r (of 32 MW) and c (of 32 NW), or nullptr for a row of zeros.  Warp w
// takes rows 16 MW (w / 4) .. and columns 8 NW (w % 4) ..; an m16 tile whose
// first row is at or past `rows_live` is not multiplied.  Every thread of the
// block calls it; it returns with the ring free again.
//
// The tensor cores add an mma's products to its accumulator without rounding
// to nearest (the low bits of the smaller addend are cut), and the cut grows
// with the accumulator, so a sum over K chained through one accumulator
// drifts by up to ~K x 2^-24 of its size: at 1101-2047 lanes the three tf32
// products missed the f32 loop's 1e-5 relative L2 that way (PERF.md §6).
// With kFresh (and always in f32) each k step's products go to a zeroed
// accumulator and enter the sum by an f32 add, which rounds to nearest.
template <typename OT, int MW, int NW, bool kFresh, typename ARow, typename BRow>
__device__ __forceinline__ void gemm(float (&acc)[MW][NW][4], unsigned char* smem, int K,
                                     int rows_live, ARow a_row, BRow b_row) {
  constexpr int KE = kKBytes / (int)sizeof(OT);  // values of K a stage
  constexpr int RA = 32 * MW, RB = 32 * NW;
  static_assert(RA + RB <= kStageRows, "a stage holds both operands' rows");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
  const void* any = b_row(0);  // a valid address for the zero-filled copies
  const int n_k = K / KE;
  auto load = [&](int kc) {
    unsigned char* st = smem + (kc % kStages) * kStageBytes;
    for (int c = tid; c < (RA + RB) * (kKBytes / 16); c += kThreads) {
      const int row = c / (kKBytes / 16), seg = c % (kKBytes / 16);
      const OT* src = row < RA ? a_row(row) : b_row(row - RA);
      sm90::cp_async16(st + row * kRowBytes + seg * 16,
                       src ? reinterpret_cast<const unsigned char*>(src) +
                                 (size_t)kc * kKBytes + seg * 16
                           : any,
                       src ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s);
    sm90::cp_async_commit();
  }
  for (int kc = 0; kc < n_k; ++kc) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kc landed for all; stage kc - 1 is free
    if (kc + kStages - 1 < n_k) load(kc + kStages - 1);
    sm90::cp_async_commit();
    const unsigned char* st = smem + (kc % kStages) * kStageBytes;
    const unsigned char* sa = st + (16 * MW * wm + g) * kRowBytes + 4 * t;
    const unsigned char* sb = st + (RA + 8 * NW * wn + g) * kRowBytes + 4 * t;
    // A k step of 32 bytes (16 bf16 or 8 tf32 values): the fragments' second
    // halves of K lie 16 bytes on, their rows g + 8 eight rows on.
#pragma unroll
    for (int ks = 0; ks < kKBytes / 32; ++ks) {
      if constexpr (sizeof(OT) == 2) {
        uint32_t a[MW][4];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          const unsigned char* p = sa + mi * 16 * kRowBytes + 32 * ks;
          a[mi][0] = lds32(p), a[mi][1] = lds32(p + 8 * kRowBytes);
          a[mi][2] = lds32(p + 16), a[mi][3] = lds32(p + 8 * kRowBytes + 16);
        }
#pragma unroll
        for (int nt = 0; nt < NW; ++nt) {
          const unsigned char* q = sb + nt * 8 * kRowBytes + 32 * ks;
          const uint32_t b0 = lds32(q), b1 = lds32(q + 16);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
            if (16 * MW * wm + 16 * mi < rows_live) {
              if constexpr (kFresh) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                sm90::mma_bf16_16816(d, a[mi], b0, b1);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][nt][e] += d[e];
              } else {
                sm90::mma_bf16_16816(acc[mi][nt], a[mi], b0, b1);
              }
            }
        }
      } else {
        uint32_t ah[MW][4], al[MW][4];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          const unsigned char* p = sa + mi * 16 * kRowBytes + 32 * ks;
          const unsigned char* at[4] = {p, p + 8 * kRowBytes, p + 16, p + 8 * kRowBytes + 16};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sm90::split_tf32(*reinterpret_cast<const float*>(at[i]), ah[mi][i], al[mi][i]);
        }
#pragma unroll
        for (int nt = 0; nt < NW; ++nt) {
          const unsigned char* q = sb + nt * 8 * kRowBytes + 32 * ks;
          uint32_t bh0, bl0, bh1, bl1;
          sm90::split_tf32(*reinterpret_cast<const float*>(q), bh0, bl0);
          sm90::split_tf32(*reinterpret_cast<const float*>(q + 16), bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
            if (16 * MW * wm + 16 * mi < rows_live) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              sm90::mma_tf32_1688(d, al[mi], bh0, bh1);
              sm90::mma_tf32_1688(d, ah[mi], bl0, bl1);
              sm90::mma_tf32_1688(d, ah[mi], bh0, bh1);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][nt][e] += d[e];
            }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();
}

// The panel for frames [t0, t0 + 64) into `panel` (64 rows of wp values of
// the loop dtype, lanes [round_up(w_len, 32), wp) untouched): a warp walks a
// row, its lanes consecutive lanes of it; f_row(u) is frame u of F
// (0 <= u < T).  Rows past T and lanes past w_len are zeros.
template <typename OT, typename Args, typename FRow>
__device__ __forceinline__ void build_panel(const Args& p, OT* panel, int t0, FRow f_row) {
  const int kp = round_up(p.w_len, kKAlign);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int t = t0 + r;
    OT* dst = panel + (size_t)r * p.wp;
    for (int k = lane; k < kp; k += 32) {
      float v = 0.f;
      if (t < p.T && k < p.w_len) {
        float acc = 0.f;
        for (int di = 0; di <= 2 * p.d_max; ++di) {
          const int d = shift_of(di, p.d_max);
          const int u = t - d, l = k + d * p.hop;
          if (u >= 0 && u < p.T && l >= 0 && l < p.w_len) acc += to_f32(f_row(u)[l]);
        }
        v = acc * p.wss2d[(size_t)t * p.wp + k];
      }
      dst[k] = from_f32<OT>(v);
    }
  }
  __threadfence();  // the panel's stores before any thread's copies read them
  __syncthreads();
}

// GEMM2 and the renorm for frames [t0, t0 + 64) of utterance bi, every column
// tile in turn: S for bins [j0, j0 + 128) from the panel and w_fwd_t (2 hp, wp),
// then q' (and, with momentum, s) stored.  Warp (wm, wn)'s column tile holds
// the real columns of bins j0 + 32 wn .. + 32 in its n8 tiles 0..3 and their
// imaginary columns in 4..7.
template <bool kMomentum, typename OT, typename Args>
__device__ __forceinline__ void gemm2_renorm(const Args& p, unsigned char* smem,
                                             const OT* panel, const OT* w_fwd_t, int t0,
                                             int bi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int L = 2 * p.hp;
  const OT* mag2 = reinterpret_cast<const OT*>(p.mag2);
  OT* q_out = reinterpret_cast<OT*>(p.q_out);
  for (int j0 = 0; j0 < p.hp; j0 += kBins) {
    float acc[2][8][4];
    gemm<OT, 2, 8, false>(
        acc, smem, round_up(p.w_len, kKAlign), kRows,
        [&](int r) -> const OT* { return panel + (size_t)r * p.wp; },
        [&](int c) -> const OT* {
          const int nt = (c & 63) >> 3;
          const int row = (nt >= 4 ? p.hp : 0) + j0 + 32 * (c >> 6) + 8 * (nt & 3) + (c & 7);
          return w_fwd_t + (size_t)row * p.wp;
        });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = t0 + 32 * wm + 16 * mi + g + 8 * h;
        if (row >= p.T) continue;
        const size_t base = ((size_t)bi * p.T + row) * L;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const size_t o = base + j0 + 32 * wn + 8 * nt + 2 * t;
          float sr0 = acc[mi][nt][2 * h], sr1 = acc[mi][nt][2 * h + 1];
          float si0 = acc[mi][nt + 4][2 * h], si1 = acc[mi][nt + 4][2 * h + 1];
          if constexpr (kMomentum) {
            const OT* prev = reinterpret_cast<const OT*>(p.prev);
            OT* s_out = reinterpret_cast<OT*>(p.s_out);
            store2(s_out + o, sr0, sr1);
            store2(s_out + o + p.hp, si0, si1);
            const float2 a = load2(prev + o), c = load2(prev + o + p.hp);
            sr0 = sr0 + p.momentum * (sr0 - a.x);
            sr1 = sr1 + p.momentum * (sr1 - a.y);
            si0 = si0 + p.momentum * (si0 - c.x);
            si1 = si1 + p.momentum * (si1 - c.y);
          }
          const float2 a = load2(mag2 + o), c = load2(mag2 + o + p.hp);
          const float inv0 = rsqrtf(sr0 * sr0 + si0 * si0 + 1e-24f);
          const float inv1 = rsqrtf(sr1 * sr1 + si1 * si1 + 1e-24f);
          store2(q_out + o, sr0 * inv0 * a.x, sr1 * inv1 * a.y);
          store2(q_out + o + p.hp, si0 * inv0 * c.x, si1 * inv1 * c.y);
        }
      }
  }
}

// B5's GEMM1 for frames [t0 - D, t0 + 64 + D) of utterance bi into `f`
// (kG1Rows x wp f32; row n is frame t0 - D + n, zeros outside [0, T)):
// F = q @ w_inv over K = 2 hp, from the transposed copy w_inv_t (wp, 2 hp),
// lanes [0, wp) in column tiles of 128.  Its sums are rounded to nearest
// (kFresh): in the bf16 loop each frame value is rounded to bf16 after the
// shift-add, and a cut sum flips that rounding often enough to move whole
// output rows (with cut sums, more than the 5% of outputs that may differ
// by a bf16 step at D = 16).
template <typename OT, typename Args>
__device__ __forceinline__ void gemm1(const Args& p, unsigned char* smem, const OT* q,
                                      const OT* w_inv_t, float* f, int t0, int bi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int L = 2 * p.hp, rows = kRows + 2 * p.d_max;
  for (int k0 = 0; k0 < p.w_len; k0 += kLanes) {
    float acc[3][4][4];
    gemm<OT, 3, 4, true>(
        acc, smem, L, rows,
        [&](int n) -> const OT* {
          const int u = t0 - p.d_max + n;
          return n < rows && u >= 0 && u < p.T ? q + ((size_t)bi * p.T + u) * L : nullptr;
        },
        [&](int c) -> const OT* {
          return k0 + c < p.wp ? w_inv_t + (size_t)(k0 + c) * L : nullptr;
        });
#pragma unroll
    for (int mi = 0; mi < 3; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 48 * wm + 16 * mi + g + 8 * h;
        if (n >= rows) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int k = k0 + 32 * wn + 8 * nt + 2 * t;
          if (k < p.wp)
            *reinterpret_cast<float2*>(f + (size_t)n * p.wp + k) =
                make_float2(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
        }
      }
  }
  __threadfence();  // F's stores before the panel's loads
  __syncthreads();
}

// Host side: the wide launch of `kernel` over n_items work items, one block
// per slab (at most n_slabs), kSmemBytes of shared memory.  `ready` keeps the
// kernel's shared-memory attribute set once.
template <typename... KArgs, typename... Args>
inline int launch(void (*kernel)(KArgs...), bool& ready, int n_items, int n_slabs,
                  cudaStream_t st, Args&&... args) {
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  if (n_slabs < 1) return (int)cudaErrorInvalidValue;
  const int grid = n_items < n_slabs ? n_items : n_slabs;
  if (grid < 1) return 0;
  kernel<<<grid, kThreads, kSmemBytes, st>>>(std::forward<Args>(args)...);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` an SM holds at once (its attribute set first).
template <typename... KArgs>
inline int blocks_per_sm(void (*kernel)(KArgs...), bool& ready) {
  if (!ready) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess)
      return -1;
    ready = true;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, kSmemBytes) !=
      cudaSuccess)
    return -1;
  return n;
}

// Shared memory of a wide launch, or -1 beyond its envelope.
inline int smem_bytes(int w_len, int d_max) {
  return d_max <= kMaxD && round_up(w_len, kKAlign) <= kMaxLanes ? kSmemBytes : -1;
}

}  // namespace wide
