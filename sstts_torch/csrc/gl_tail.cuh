// Device code shared by the two Griffin-Lim kernels that end in the analysis
// GEMM and the renorm: gl_semi.cu (kernel B2) and gl_fused.cu (kernel B5).
// It is everything a block does after the synthesis frames F exist, for
// BM = 64 frames of one utterance:
//   1. the reprojected A panel  A[t, j] = bf16( wss2d[t, j] *
//      sum_{d=-D..D} F[t-d, j+d*hop] ), each element the f32 sum of the 2D+1
//      shifted terms in the Pallas kernels' order (d = 0, then -D..D without
//      0), source lanes kept inside [0, w_len) and rows inside [0, T) of the
//      same utterance, rounded to bf16 once.  F is B2's bf16 frames or B5's
//      f32 GEMM1 slab;
//   2. GEMM2  S = A @ w_fwd  over K = w_len rounded up to 16 (the lanes beyond
//      are zero by construction), f32 accumulation;
//   3. the renorm q' = s * rsqrt(re^2 + im^2 + 1e-24) * mag, after the momentum
//      extrapolation s + m*(s - prev) where the kernel takes one (B2), bf16
//      out, bin j's real part in lane j and its imaginary part in lane j + hp.
//
// What bounds it on the H100 is operations (the header of each .cu has the
// count), and what held the first port at 6% of that bound was that nothing
// overlapped, the GEMM ran on 16x16x16 wmma tiles, every block streamed all
// of w_fwd from L2, and the panel was built from two-byte loads at odd
// offsets.  This design:
//   * A block is three warpgroups: two consumers (256 threads) and a producer
//     whose one elected thread issues every TMA load.  setmaxnreg moves the
//     producer's registers to the consumers.  Full/empty mbarriers are the
//     only synchronisation between the roles.
//   * The panel (64 x K bf16, K-major, 128-byte swizzled: one 8 KB chunk per
//     64 lanes of K) stays resident in shared memory, so the shift-add costs
//     one pass however many bin tiles follow.  The rows of F it is built
//     from cross from L2 once: the producer brings whole rows by bulk copies
//     into a ring of four groups of rows (8 bf16 or 4 f32 rows each, in the
//     memory of GEMM2's ring, which is idle until the panel is done), and
//     the shifts happen on the way out of shared memory: a warp reads 32
//     consecutive words of source row t - d at lane offset d * hop, free of
//     bank conflicts, only where that offset stays inside [0, w_len), adds
//     the terms in f32 in registers, scales by wss2d and writes its words of
//     the swizzled panel.  (TMA boxes at (lane k0 + d * hop, row t0 - d) with
//     zero fill would need no mask at all, but the card refuses a box that
//     starts off a 16-byte boundary, and hop = 275 is odd; widened, aligned
//     boxes worked and re-read F nine times from L2: PERF.md.)
//   * GEMM2 runs on wgmma m64n128k16, both operands from shared memory.  The
//     B operand of a bin tile holds w_fwd's 64 real columns j0.. and its 64
//     imaginary columns hp + j0.. (rows of the transposed, K-major copy of
//     w_fwd the wrapper hands over), so the thread that holds re of (row, bin)
//     in d[i] holds its im in d[i + 32]: the momentum step and the renorm
//     happen in registers, mag2 (and prev) are loaded into registers before
//     the K loop starts, and q' (and s) leave straight from the fragments.
//     The two consumer warpgroups take alternate bin tiles, so one multiplies
//     while the other renorms.
//   * w_fwd comes by TMA into a ring of kStages 16 KB stages.  The blocks of a
//     cluster (the same 64 frames of two different utterances) share
//     it: each member loads its share of every stage and multicasts it to
//     all, so the weights cross from L2 once per cluster.  A stage's empty
//     barrier therefore counts one arrival from every member.  A member with
//     no utterance (a batch the cluster size does not divide) computes on
//     zeros, takes part in every barrier and stores nothing.
// The functions take the kernel's argument struct (GlArgs or GlFusedArgs),
// whose common fields have the same names.

#pragma once

#include <utility>

#include "sm90.cuh"

using bf16 = __nv_bfloat16;

// Measurement only (sstts_torch/tools/ablate_gl_semi.py): a bit mask of
// stages whose work is skipped (1 the A panel: its loads and its sums, 2
// GEMM2: the ring's loads and the wgmma, 4 the epilogue: its loads and
// stores).  The stages overlap, so the times do not add up.  0 in every other
// build, and the compiler then removes the tests below.
#ifndef SSTTS_ABLATE
#define SSTTS_ABLATE 0
#endif

// Blocks a cluster: 1, 2 or 4.  Measured alike within a few per cent, 2 the
// best (PERF.md); the other sizes are built by the same tool, for timing.
#ifndef SSTTS_CLUSTER
#define SSTTS_CLUSTER 2
#endif

namespace {

constexpr int BM = 64;      // frames per block
constexpr int BN = 64;      // bins per GEMM2 tile; its B operand has 2 * BN rows
constexpr int BK = 64;      // lanes of K per ring stage and per panel chunk
constexpr int kStages = 5;  // ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = 384;
constexpr int kChunkBytes = BM * BK * 2;      // one panel chunk
constexpr int kStageBytes = 2 * BN * BK * 2;  // one ring stage
constexpr int kBoxRows = 32;                  // w_fwd rows per TMA box
constexpr int kFSlots = 4;                    // groups of F rows in flight
constexpr int kMaxPass = 18;                  // 32-word passes over a panel row
constexpr int kBarrierBytes = 256;
constexpr int kProducerRegs = 40;   // setmaxnreg: 40 * 128 + 232 * 256
constexpr int kConsumerRegs = 232;  // = 168 * 384, what the launch allots

inline __host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }
inline __host__ __device__ int panel_chunks(int w_len) {
  return round_up(round_up(w_len, 16), BK) / BK;
}
// Dynamic shared memory of a kernel that ends in the tail.
inline int tail_smem_bytes(int w_len) {
  return 1024 + panel_chunks(w_len) * kChunkBytes + kStages * kStageBytes +
         kBarrierBytes;
}
// F rows come in groups of 16 / sizeof(FT) (8 bf16 rows, 4 f32 rows), kFSlots
// groups in the ring's memory; a row takes its w_len lanes rounded up to 16
// bytes.  True when they fit, with two rows to spare (a shifted load may
// reach one row's length past the rows), and the shifts reach no further than
// one group.
inline __host__ __device__ bool f_rows_fit(int w_len, int d_max, int elem_bytes) {
  const int group = 16 / elem_bytes;
  return d_max <= group &&
         (kFSlots * group + 2) * round_up(w_len * elem_bytes, 16) <=
             kStages * kStageBytes &&
         round_up(w_len, 16) <= kMaxPass * 64;
}

// Shared memory after the alignment slack: the panel, the ring (the rows of
// F alias it), the barriers.  One pointer and one count, so that a role keeps
// few registers for it: every other address is a sum formed where it is used.
struct TailSmem {
  unsigned char* panel;
  int chunks;
  __device__ __forceinline__ unsigned char* ring() const {
    return panel + chunks * kChunkBytes;
  }
  __device__ __forceinline__ uint64_t* bars() const {
    return reinterpret_cast<uint64_t*>(ring() + kStages * kStageBytes);
  }
  // Ring stage loaded / free in every cluster member: [kStages] each.
  __device__ __forceinline__ uint64_t* full() const { return bars(); }
  __device__ __forceinline__ uint64_t* empty() const { return bars() + kStages; }
  // Group of F rows loaded / free: [kFSlots] each.
  __device__ __forceinline__ uint64_t* ffull() const { return bars() + 2 * kStages; }
  __device__ __forceinline__ uint64_t* fempty() const {
    return bars() + 2 * kStages + kFSlots;
  }
  // [9] for the kernel in front (B5's GEMM1).
  __device__ __forceinline__ uint64_t* extra() const {
    return bars() + 2 * kStages + 2 * kFSlots;
  }
};

__device__ __forceinline__ TailSmem tail_smem(unsigned char* raw, int w_len) {
  TailSmem s;
  const uint32_t a = sm90::smem_u32(raw);
  s.panel = raw + (((a + 1023u) & ~1023u) - a);
  s.chunks = panel_chunks(w_len);
  return s;
}

// By one thread, before the roles split and before a cluster-wide sync.
__device__ __forceinline__ void tail_init_barriers(const TailSmem& s, int cluster) {
  for (int i = 0; i < kStages; ++i) {
    sm90::mbar_init(s.full() + i, 1);
    sm90::mbar_init(s.empty() + i, cluster);
  }
  for (int i = 0; i < kFSlots; ++i) {
    sm90::mbar_init(s.ffull() + i, 1);
    sm90::mbar_init(s.fempty() + i, kConsumers / 32);
  }
}

// Where a block starts in the cycle of bin-tile pairs, the same for the
// members of a cluster.  Blocks that run together then read different parts
// of w_fwd and, above all, load mag2 and store q' at different bins: rows lie
// 4 KB apart, and with every block at the same bins the whole kernel took
// 0.56 ms instead of 0.49 (GEMM2 alone is the same either way).
__device__ __forceinline__ int tile_rotation(uint32_t cl) {
  return blockIdx.x + blockIdx.y / cl;
}

// The shift of term `di` of the sum: d = 0 first, then -D..-1, 1..D.
__device__ __forceinline__ int shift_of(int di, int d_max) {
  return di == 0 ? 0 : (di <= d_max ? di - 1 - d_max : di - d_max);
}

// The producer's part, by one thread.  Row u of F (a frame of the block's
// utterance) lies at f + (u - f_first) * p.wp.  map_w is over the transposed
// w_fwd as (k < K, 2 hp rows) with boxes of BK x kBoxRows.
template <typename FT, typename Args>
__device__ __forceinline__ void tail_producer(const Args& p, const TailSmem& s,
                                              const FT* f, int f_first,
                                              const CUtensorMap* map_w, int t0) {
  constexpr int G = 16 / sizeof(FT);  // rows per group
  const int kd = round_up(p.w_len, 16);
  const uint32_t row_bytes = round_up(p.w_len * (int)sizeof(FT), 16);
  // Group g holds frames [t0 + (g - 1) G, t0 + g G): one group of halo before
  // the block's frames and one after.
  const int n_groups = (SSTTS_ABLATE & 1) ? 0 : BM / G + 2;
  for (int g = 0; g < n_groups; ++g) {
    const int slot = g % kFSlots, use = g / kFSlots;
    const int u0 = t0 + (g - 1) * G;
    // Only frames the sums reach: inside the utterance and the halo.
    const int lo = max(u0, max(0, t0 - p.d_max));
    const int hi = min(u0 + G, min(p.T, t0 + BM + p.d_max));
    sm90::mbar_wait(s.fempty() + slot, (use & 1) ^ 1);
    sm90::mbar_expect_tx(s.ffull() + slot, hi > lo ? (hi - lo) * row_bytes : 0u);
    for (int u = lo; u < hi; ++u)
      sm90::bulk_load(s.ring() + (slot * G + (u - u0)) * row_bytes,
                      f + (size_t)(u - f_first) * p.wp, row_bytes, s.ffull() + slot);
  }
  // The ring.  Stage n carries K chunk kc of bin tile 2 pair + (n & 1): the two
  // consumer warpgroups take alternate stages.  The consumers free every
  // stage once after the panel is built (the rows of F lay there), so use u
  // of a slot waits for the slot's u-th release.
  const uint32_t rank = sm90::cluster_ctarank();
  const uint32_t cl = sm90::cluster_nctarank();
  const uint16_t mask = static_cast<uint16_t>((1u << cl) - 1);
  const int n_kc = (kd + BK - 1) / BK;
  const int n_pairs = (SSTTS_ABLATE & 2) ? 0 : p.hp / (2 * BN);
  int pair = n_pairs ? tile_rotation(cl) % n_pairs : 0;
  int slot = 0;
  uint32_t phase = 0;
  for (int pr = 0; pr < n_pairs; ++pr) {
    for (int kc = 0; kc < n_kc; ++kc) {
      for (int wg = 0; wg < 2; ++wg) {
        const int j0 = (2 * pair + wg) * BN;
        sm90::mbar_wait(s.empty() + slot, phase);
        sm90::mbar_expect_tx(s.full() + slot, kStageBytes);
        unsigned char* dst = s.ring() + slot * kStageBytes;
#pragma unroll
        for (int b = 0; b < 2 * BN / kBoxRows; ++b) {
          if ((b & (cl - 1)) != rank) continue;
          const int row = b < BN / kBoxRows
                              ? j0 + b * kBoxRows
                              : p.hp + j0 + (b - BN / kBoxRows) * kBoxRows;
          unsigned char* d = dst + b * kBoxRows * BK * 2;
          if (cl == 1)
            sm90::tma_load_2d(d, map_w, s.full() + slot, kc * BK, row);
          else
            sm90::tma_load_2d_multicast(d, map_w, s.full() + slot, kc * BK, row, mask);
        }
        if (++slot == kStages) slot = 0, phase ^= 1;
      }
    }
    if (++pair == n_pairs) pair = 0;
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void unpack4(uint32_t (&a)[4], const uint4 v) {
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}
// Among the four lanes of a quad: lane q's a[k] becomes lane k's a[q].
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int lane) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool up = lane & bit;
    const uint32_t s0 = up ? a[0] : a[bit], s1 = up ? a[3 - bit] : a[3];
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, bit);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, bit);
    if (up) a[0] = r0, a[3 - bit] = r1; else a[bit] = r0, a[3] = r1;
  }
}

// Free every ring stage in every cluster member, by one thread.
__device__ __forceinline__ void release_stage(const TailSmem& s, int slot, uint32_t cl) {
  for (uint32_t c = 0; c < cl; ++c) sm90::mbar_arrive_cluster(s.empty() + slot, c);
}

// acc += the row's lanes shifted by sh, for this thread's word of each of
// its passes (pass i starts at output lane ps0 + i * STEP).  Free of
// branches inside a block of six passes, so that the loads of a block are all
// in flight together: every word is loaded (a shift stays within one row's
// length of the row, inside shared memory) and a lane outside [0, w_len)
// counts as +0.  A bf16 pair at an odd shift straddles two words, which a
// funnel shift joins.  A block none of whose lanes has a source is skipped.
template <typename FT>
__device__ __forceinline__ void add_row(float (&acc)[kMaxPass][4 / sizeof(FT)],
                                        const FT* row, int sh, int w_len, int ps0,
                                        int x) {
  constexpr int EPT = 4 / sizeof(FT);
  constexpr int PW = 32 * EPT;
  constexpr int STEP = (8 / (16 / (int)sizeof(FT))) * PW;  // lanes between passes
  constexpr int BLK = 6;
  const int l0 = ps0 + x * EPT + sh;  // source lane of the thread's first lane
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(row) + (l0 >> (EPT - 1));
  const int sft = EPT == 2 && (l0 & 1) ? 16 : 0;
#pragma unroll
  for (int blk = 0; blk < kMaxPass / BLK; ++blk) {
    const int src = ps0 + blk * BLK * STEP + sh;  // first source lane of the block
    if (src + (BLK - 1) * STEP + PW <= 0 || src >= w_len) continue;
#pragma unroll
    for (int j = 0; j < BLK; ++j) {
      const int i = blk * BLK + j;
      const int l = l0 + i * STEP;
      if constexpr (EPT == 2) {
        const uint32_t pair = __funnelshift_r(wb[i * (STEP / EPT)],
                                              wb[i * (STEP / EPT) + 1], sft);
        acc[i][0] += (unsigned)l < (unsigned)w_len ? __uint_as_float(pair << 16) : 0.f;
        acc[i][1] += (unsigned)(l + 1) < (unsigned)w_len
                         ? __uint_as_float(pair & 0xffff0000u) : 0.f;
      } else {
        acc[i][0] += (unsigned)l < (unsigned)w_len
                         ? __uint_as_float(wb[i * (STEP / EPT)]) : 0.f;
      }
    }
  }
}

// The consumers' first part, by threads 0..255 of the block: the panel for
// frames [t0, t0 + BM).  The rows of F pass through shared memory once, in
// groups of G; for output group og the three groups og .. og + 2 hold every
// source row.  A warp takes one output row (and, for f32, every other pass):
// per shift d its 32 lanes read consecutive words of source row t - d at lane
// offset d * hop, only over the passes where that offset stays inside
// [0, w_len), and add them in f32 in the Pallas order; the sums stay in
// registers until the row is scaled by wss2d and written to the panel.  When
// it returns, every consumer is done with F.
template <typename FT, typename Args>
__device__ __forceinline__ void tail_build_panel(const Args& p, const TailSmem& s,
                                                 int t0) {
  constexpr int G = 16 / sizeof(FT);   // rows per group
  constexpr int EPT = 4 / sizeof(FT);  // lanes per thread and pass: one word
  constexpr int PW = 32 * EPT;         // lanes per pass
  constexpr int NSUB = 8 / G;          // warps that share a row
  const int tid = threadIdx.x;
  const int w = tid >> 5, x = tid & 31;
  const int rg = w % G, sub = w / G;
  const int kd = round_up(p.w_len, 16);
  const uint32_t cl = sm90::cluster_nctarank();
  const uint32_t row_bytes = round_up(p.w_len * (int)sizeof(FT), 16);
  const int n_pass = (kd + PW - 1) / PW;
  const int n_og = (SSTTS_ABLATE & 1) ? 0 : BM / G;
  for (int og = 0; og < n_og; ++og) {
    for (int g = og == 0 ? 0 : og + 2; g <= og + 2; ++g)
      sm90::mbar_wait(s.ffull() + g % kFSlots, (g / kFSlots) & 1);
    const int r = og * G + rg;
    const int t = t0 + r;
    float acc[kMaxPass][EPT], env[kMaxPass][EPT];
#pragma unroll
    for (int i = 0; i < kMaxPass; ++i)
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int k = (sub + NSUB * i) * PW + x * EPT + e;
        acc[i][e] = 0.f;
        env[i][e] = t < p.T && k < kd ? p.wss2d[(size_t)t * p.wp + k] : 0.f;
      }
    for (int di = 0; di <= 2 * p.d_max; ++di) {
      const int d = shift_of(di, p.d_max);
      const int u = t - d;
      if (t >= p.T || u < 0 || u >= p.T) continue;
      const int ur = r - d + G;  // the row's place in the stream of groups
      const FT* row = reinterpret_cast<const FT*>(
          s.ring() + ((ur / G) % kFSlots * G + ur % G) * row_bytes);
      add_row<FT>(acc, row, d * p.hop, p.w_len, sub * PW, x);
    }
    __syncwarp();
    if (x == 0) sm90::mbar_arrive(s.fempty() + og % kFSlots);
#pragma unroll
    for (int i = 0; i < kMaxPass; ++i) {
      const int pass = sub + NSUB * i;
      const int k = pass * PW + x * EPT;
      if (pass < n_pass) {
        float v[EPT];
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          v[e] = acc[i][e] * env[i][e];
        unsigned char* dst = s.panel + (k >> 6) * kChunkBytes +
                             sm90::sw128_offset(r, (k & 63) >> 3) + (k & 7) * 2;
        if constexpr (EPT == 2) {
          *reinterpret_cast<uint32_t*>(dst) = pack2(v[0], v[1]);
        } else {
          const float up = __shfl_down_sync(0xffffffffu, v[0], 1);
          if (!(x & 1)) *reinterpret_cast<uint32_t*>(dst) = pack2(v[0], up);
        }
      }
    }
  }
  // The panel is read by wgmma (the async proxy) and the rows' memory is
  // about to take ring stages, also from the other cluster members.
  sm90::fence_proxy_async();
  sm90::named_barrier(1, kConsumers);
  if (tid == 0)
    for (int slot = 0; slot < kStages; ++slot) release_stage(s, slot, cl);
}

// The consumers' second part, by two warpgroups: GEMM2 and the renorm for
// frames [t0, t0 + BM) of utterance bi; bi >= p.Bt has no work and stores
// nothing.  Warpgroup wg takes bin tiles wg, wg + 2, ...  kMomentum: the
// iteration takes p.prev, p.s_out and p.momentum.
template <bool kMomentum, typename Args>
__device__ __forceinline__ void tail_gemm_renorm(const Args& p, const TailSmem& s,
                                                 int t0, int bi) {
  const int tid = threadIdx.x;
  const int kd = round_up(p.w_len, 16);
  const uint32_t cl = sm90::cluster_nctarank();
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r0 = 16 * ((tid & 127) >> 5) + (lane >> 2);  // and r0 + 8
  const int cq = 2 * (lane & 3);                         // column pair in each 8
  const int L = 2 * p.hp;
  const int n_kc = (kd + BK - 1) / BK;
  const bool stores = !(SSTTS_ABLATE & 4) && bi < p.Bt;
  const uint32_t panel_a = sm90::smem_u32(s.panel);
  const uint32_t ring_a = sm90::smem_u32(s.ring());
  float acc[4 * 2 * BN / 8];  // [0, 32) real, [32, 64) imaginary
  const int n_pairs = p.hp / (2 * BN);
  int pair = tile_rotation(cl) % n_pairs;
  int slot = wg;
  uint32_t phase = 0;
  for (int pr = 0; pr < n_pairs; ++pr, pair = pair + 1 == n_pairs ? 0 : pair + 1) {
    const int j0 = (2 * pair + wg) * BN;
    // mag2 (and prev) for this thread's quad, 16 bytes a lane, in flight
    // during the K loop: [h][c][b] is row r0 + 8 h, real or imaginary half,
    // bins j0 + 32 b + 8 (lane & 3) .. + 8.
    uint4 mg[2][2][2], pv[2][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + 8 * h;
      const size_t at = ((size_t)bi * p.T + t) * L + j0 + 4 * cq;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          mg[h][c][b] = pv[h][c][b] = make_uint4(0u, 0u, 0u, 0u);
          if (stores && t < p.T) {
            const size_t o = at + c * p.hp + 32 * b;
            mg[h][c][b] = __ldg(reinterpret_cast<const uint4*>(p.mag2 + o));
            if constexpr (kMomentum)
              pv[h][c][b] = __ldg(reinterpret_cast<const uint4*>(p.prev + o));
          }
        }
    }
    if (SSTTS_ABLATE & 2) {
#pragma unroll
      for (int i = 0; i < 4 * 2 * BN / 8; ++i) acc[i] = 1.f;
    }
    int prev_slot = -1;
    for (int kc = 0; kc < ((SSTTS_ABLATE & 2) ? 0 : n_kc); ++kc) {
      sm90::mbar_wait(s.full() + slot, phase);
      const int k_steps = min(BK, kd - kc * BK) / 16;
      const uint64_t da = sm90::sw128_desc(panel_a + kc * kChunkBytes);
      const uint64_t db = sm90::sw128_desc(ring_a + slot * kStageBytes);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        if (ks < k_steps)
          sm90::wgmma_m64n128k16(acc, da + 2 * ks, db + 2 * ks, (kc | ks) != 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the stage before this one is done with
      if (prev_slot >= 0 && (tid & 127) == 0) release_stage(s, prev_slot, cl);
      prev_slot = slot;
      slot += 2;  // the other warpgroup has the stage between
      if (slot >= kStages) slot -= kStages, phase ^= 1;
    }
    sm90::wgmma_wait<0>();
    if (prev_slot >= 0 && (tid & 127) == 0) release_stage(s, prev_slot, cl);

    // The epilogue, in registers: d[4 j + 2 h + e] is row r0 + 8 h, bin
    // j0 + 8 j + cq + e, real part; + 32 its imaginary part.  A quad of lanes
    // holds 8 consecutive bins of each j; a 4 x 4 transpose inside the quad
    // turns a lane's 16 loaded bytes into its fragment's pairs, and its
    // results back into 16 bytes to store.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + 8 * h;
      const bool live = stores && t < p.T;
      const size_t at = ((size_t)bi * p.T + t) * L + j0 + 4 * cq;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const size_t o = at + 32 * b;
        if constexpr (kMomentum) {  // the raw s first: its words die early
          uint32_t sr_[4], si_[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = 4 * (4 * b + jj) + 2 * h;
            sr_[jj] = pack2(acc[i], acc[i + 1]);
            si_[jj] = pack2(acc[32 + i], acc[32 + i + 1]);
          }
          quad_transpose(sr_, lane), quad_transpose(si_, lane);
          if (live) {
            *reinterpret_cast<uint4*>(p.s_out + o) =
                make_uint4(sr_[0], sr_[1], sr_[2], sr_[3]);
            *reinterpret_cast<uint4*>(p.s_out + o + p.hp) =
                make_uint4(si_[0], si_[1], si_[2], si_[3]);
          }
        }
        uint32_t mr[4], mi[4], qr[4], qi[4];
        unpack4(mr, mg[h][0][b]), unpack4(mi, mg[h][1][b]);
        quad_transpose(mr, lane), quad_transpose(mi, lane);
        [[maybe_unused]] uint32_t pr_[4], pi_[4];
        if constexpr (kMomentum) {
          unpack4(pr_, pv[h][0][b]), unpack4(pi_, pv[h][1][b]);
          quad_transpose(pr_, lane), quad_transpose(pi_, lane);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = 4 * (4 * b + jj) + 2 * h;
          float sr0 = acc[i], sr1 = acc[i + 1];
          float si0 = acc[32 + i], si1 = acc[32 + i + 1];
          if constexpr (kMomentum) {
            const float2 a = unpack2(pr_[jj]), c = unpack2(pi_[jj]);
            sr0 = sr0 + p.momentum * (sr0 - a.x);
            sr1 = sr1 + p.momentum * (sr1 - a.y);
            si0 = si0 + p.momentum * (si0 - c.x);
            si1 = si1 + p.momentum * (si1 - c.y);
          }
          const float2 a = unpack2(mr[jj]), c = unpack2(mi[jj]);
          const float inv0 = rsqrtf(sr0 * sr0 + si0 * si0 + 1e-24f);
          const float inv1 = rsqrtf(sr1 * sr1 + si1 * si1 + 1e-24f);
          qr[jj] = pack2(sr0 * inv0 * a.x, sr1 * inv1 * a.y);
          qi[jj] = pack2(si0 * inv0 * c.x, si1 * inv1 * c.y);
        }
        quad_transpose(qr, lane), quad_transpose(qi, lane);
        if (live) {
          *reinterpret_cast<uint4*>(p.q_out + o) = make_uint4(qr[0], qr[1], qr[2], qr[3]);
          *reinterpret_cast<uint4*>(p.q_out + o + p.hp) =
              make_uint4(qi[0], qi[1], qi[2], qi[3]);
        }
      }
    }
  }
}

// Host side: the tensor map over the transposed w_fwd, (2 hp, wp) row-major,
// cut to the K the GEMM needs.
inline int encode_w_fwd_map(CUtensorMap* map, const bf16* w_fwd_t, int hp, int wp,
                            int w_len) {
  const uint64_t dims[2] = {(uint64_t)round_up(w_len, 16), (uint64_t)(2 * hp)};
  const uint64_t strides[1] = {(uint64_t)wp * 2};
  const uint32_t box[2] = {BK, kBoxRows};
  return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_fwd_t, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A launch of `kernel` on `grid` blocks of kThreads in clusters of `cluster`
// along y.
template <typename... KArgs, typename... Args>
inline cudaError_t launch_clustered(void (*kernel)(KArgs...), dim3 grid, int cluster,
                                    int smem, cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// The cluster size of a launch over `bt` utterances: a single utterance has
// nobody to share the weights with.
inline int cluster_size(int bt) { return bt >= 2 ? SSTTS_CLUSTER : 1; }

inline const char* tail_error_string(int code) {
  if (code == -1) return "cuTensorMapEncodeTiled not found in libcuda";
  if (code == -2) return "fewer scratch slabs than blocks the card can hold at once";
  if (code < -2) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace
