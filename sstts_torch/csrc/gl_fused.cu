// Whole Griffin-Lim iteration for Hopper (sm_90a): kernel B5.
//
// Replaces sstts/dsp/gl_fused.py:fused_gl_iteration, the Pallas TPU kernel
// that runs one Griffin-Lim iteration q -> q' per block of frames:
//   1. GEMM1  F = q[rows - D .. rows + D] @ w_inv  (bf16 operands, f32
//      accumulation), the block's rows plus D halo rows on each side (zero
//      outside [0, T)); F stays f32, unlike the split and semi iterations,
//      which round it to bf16;
//   2. the banded shift-add  A[t, j] = bf16( wss2d[t, j] *
//      sum_{d=-D..D} F[t-d, j+d*hop] ), source lanes kept inside the window
//      support, in the Pallas kernel's order (d = 0 first, then -D..D);
//   3. GEMM2  S = A @ w_fwd  (bf16 operands, f32 accumulation);
//   4. the renorm  q' = s * rsqrt(re^2 + im^2 + 1e-24) * mag,  bf16 out, with
//      bin j's real part in lane j and its imaginary part in lane j + hp.
// The few reflect-pad edge rows are rebuilt afterwards from q in plain torch
// (sstts_torch/dsp/gl_fused.py:_patch_edges), as the JAX package rebuilds
// them in XLA.  Momentum is not supported, as in the JAX package.
//
// Bound on the H100: operations.  At the main path's shapes (32 x 800
// rows, 2 hp = 2048, w_len = 1101 of wp = 1152 lanes) the two GEMMs need
// 2 x 115.4 GFLOP (the lanes from w_len on are zero), 0.2335 ms at
// 989 TFLOP/s bf16, against 0.098 ms for q, mag2 and q' (3 x 105 MB), both
// matrices and the envelope at 3.35 TB/s.  As for B2, the weights' way from
// L2 to 132 SMs is what a design must spare; GEMM1 adds the halo (72 rows
// for 64) and its f32 frames, which fit in no shared memory beside the panel
// (72 x 1104 x 4 = 318 KB).
//
// Design: B2 (csrc/gl_semi.cu) with GEMM1 in front, the same grid, clusters
// and roles.
//   * GEMM1 is computed transposed, F^T = w_inv^T q^T, on wgmma m64n72k16: M
//     is 64 lanes of the wrapper's transposed, K-major copy of w_inv, N the
//     64 + 2 D <= 72 rows of q in their own layout (K-major as they lie), so
//     no row is padded to a multiple of 64.  A stage of its TMA ring holds
//     256 lanes x 64 of K of w_inv (multicast over the cluster, like w_fwd)
//     and the 72 x 64 tile of q (out-of-range rows arrive as zeros); each
//     consumer warpgroup keeps two 64 x 72 accumulators (three spilled), so
//     the whole of K passes once per 256 lanes and q is read five times, not
//     once per 128 lanes.  The ring, four stages deep, uses the memory of the
//     panel and of GEMM2's ring, both idle until GEMM1 is done.
//   * The f32 frames leave from the fragments (a tile through shared memory
//     and one TMA store was no faster: PERF.md) into a slab (72 x wp f32) of a
//     scratch that holds one slab per SM, not per block of the grid: a block
//     takes a free slab (a flag per slab, starting at its SM's number) and
//     gives it back when its panel is built.  The slab is read back at once,
//     through L2, row by row like B2's frames (four f32 rows a group).
//   * The rest is gl_tail.cuh's tail: panel, GEMM2, renorm.
// Measurement only: SSTTS_ABLATE (gl_tail.cuh) has two more bits here, 8 to
// skip GEMM1 (its loads and its wgmma) and 16 to skip the slab's stores.

// The kernel above is the whole-panel configuration: the bf16 loop at a
// window support up to 1137 lanes and D <= 4.  gl_fused_wide_kernel below
// runs gl_wide.cuh's wide configuration everywhere else up to D = 128, at
// any support and bin count, in bf16 or f32
// (sstts_torch/dsp/gl_tiles.py:config chooses).
//
// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError() (or a negative code when a tensor map cannot be
// encoded).

#include "gl_wide.cuh"

extern "C" {

// Field order is mirrored by sstts_torch/dsp/gl_fused.py:_GlFusedArgs.
struct GlFusedArgs {
  const bf16* q;       // (Bt, T, 2 hp)
  const bf16* mag2;    // (Bt, T, 2 hp)
  const bf16* w_inv;   // (2 hp, wp) and
  const bf16* w_fwd;   // (wp, 2 hp); this kernel reads the transposed copies
                       // below, the fields stay so that the first port's build
                       // takes the same struct (tools/compare_gl_builds.py)
  const float* wss2d;  // (T, wp), zero beyond w_len and outside the signal
  float* frames;       // scratch (n_slabs, N1, wp), GEMM1's f32 frames
  bf16* q_out;         // (Bt, T, 2 hp)
  int Bt, T, wp, hp, w_len, hop, d_max;
  int n_slabs;
  const bf16* w_inv_t;  // (wp, 2 hp): w_inv transposed
  const bf16* w_fwd_t;  // (2 hp, wp): w_fwd transposed
  int* slab_free;       // (n_slabs,): 1 where the slab is free
  // The wide configuration (gl_wide.cuh) takes `frames` as n_slabs slabs of
  // wide::slab_bytes(wp, elem, true, d_max) bytes and no slab_free; with f32 set
  // every tensor but wss2d and the slabs' frames is f32.
  int f32;
};

}  // extern "C"

namespace {

constexpr int N1 = 72;                // GEMM1 rows: BM + 2 D <= N1
constexpr int M1_TILES = 2;           // 64-lane accumulators per warpgroup
constexpr int M1_PASS = 2 * M1_TILES * 64;  // lanes per pass over K
constexpr int kG1ABytes = 64 * BK * 2;      // one 64-lane tile of w_inv
constexpr int kG1StageBytes = 2 * M1_TILES * kG1ABytes + N1 * BK * 2;
constexpr int kG1MaxStages = 4;

// Stages of GEMM1's ring in the panel's and GEMM2 ring's memory.
inline __host__ __device__ int g1_stages(int w_len) {
  const int n = (panel_chunks(w_len) * kChunkBytes + kStages * kStageBytes) /
                kG1StageBytes;
  return n < kG1MaxStages ? n : kG1MaxStages;
}

// extra[0..3] full, extra[4..7] empty, extra[8] the slab is written.
__device__ __forceinline__ void g1_producer(const GlFusedArgs& p, const TailSmem& s,
                                            const CUtensorMap* map_q,
                                            const CUtensorMap* map_wi, int t0,
                                            int bi) {
  const uint32_t rank = sm90::cluster_ctarank();
  const uint32_t cl = sm90::cluster_nctarank();
  const uint16_t mask = static_cast<uint16_t>((1u << cl) - 1);
  const int g1s = g1_stages(p.w_len);
  const int n_kc = 2 * p.hp / BK;
  const int n_pass = (SSTTS_ABLATE & 8) ? 0 : (p.w_len + M1_PASS - 1) / M1_PASS;
  int slot = 0;
  uint32_t phase = 1;  // a first use finds the slot free
  for (int pass = 0; pass < n_pass; ++pass) {
    for (int kc = 0; kc < n_kc; ++kc) {
      uint64_t* full = s.extra() + slot;
      sm90::mbar_wait(s.extra() + kG1MaxStages + slot, phase);
      sm90::mbar_expect_tx(full, kG1StageBytes);
      unsigned char* dst = s.panel + slot * kG1StageBytes;
#pragma unroll
      for (int b = 0; b < 2 * M1_TILES; ++b) {
        if ((b & (cl - 1)) != rank) continue;
        const int lane0 = pass * M1_PASS + b * 64;
        if (cl == 1)
          sm90::tma_load_2d(dst + b * kG1ABytes, map_wi, full, kc * BK, lane0);
        else
          sm90::tma_load_2d_multicast(dst + b * kG1ABytes, map_wi, full, kc * BK,
                                      lane0, mask);
      }
      sm90::tma_load_3d(dst + 2 * M1_TILES * kG1ABytes, map_q, full, kc * BK,
                        t0 - p.d_max, bi);
      if (++slot == g1s) slot = 0, phase ^= 1;
    }
  }
}

// By the two consumer warpgroups: F^T for the block's 64 + 2 D rows into
// `slab` (row n of the slab is frame t0 - D + n), straight from the
// fragments: a warp's store covers four rows with 32 bytes each.
__device__ __forceinline__ void g1_consumer(const GlFusedArgs& p, const TailSmem& s,
                                            float* slab) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7, lane = tid & 31;
  const int m0 = 16 * ((tid & 127) >> 5) + (lane >> 2);  // and m0 + 8
  const int nq = 2 * (lane & 3);
  const uint32_t cl = sm90::cluster_nctarank();
  const int g1s = g1_stages(p.w_len);
  const int n_kc = 2 * p.hp / BK;
  const int n_mt = (p.w_len + 63) / 64;
  const int n_pass = (SSTTS_ABLATE & 8) ? 0 : (p.w_len + M1_PASS - 1) / M1_PASS;
  const int rows = (SSTTS_ABLATE & 16) ? 0 : BM + 2 * p.d_max;
  const uint32_t base = sm90::smem_u32(s.panel);
  float acc[M1_TILES][N1 / 2];
  int slot = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < n_pass; ++pass) {
    // Warpgroup wg takes tiles wg, wg + 2, ... of the pass, so that a last,
    // short pass still feeds both.
    const int tile0 = pass * 2 * M1_TILES + wg;
    const int nmt = min(M1_TILES, max(0, (n_mt - tile0 + 1) / 2));
    int prev_slot = -1;
    for (int kc = 0; kc < n_kc; ++kc) {
      sm90::mbar_wait(s.extra() + slot, phase);
      const uint32_t stage = base + slot * kG1StageBytes;
      const uint64_t db = sm90::sw128_desc(stage + 2 * M1_TILES * kG1ABytes);
      sm90::wgmma_fence();
#pragma unroll
      for (int i = 0; i < M1_TILES; ++i) {
        if (i < nmt) {
          const uint64_t da =
              sm90::sw128_desc(stage + (wg + 2 * i) * kG1ABytes);
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
            sm90::wgmma_m64n72k16(acc[i], da + 2 * ks, db + 2 * ks, (kc | ks) != 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (prev_slot >= 0 && (tid & 127) == 0)
        for (uint32_t c = 0; c < cl; ++c)
          sm90::mbar_arrive_cluster(s.extra() + kG1MaxStages + prev_slot, c);
      prev_slot = slot;
      if (++slot == g1s) slot = 0, phase ^= 1;
    }
    sm90::wgmma_wait<0>();
    if ((tid & 127) == 0)
      for (uint32_t c = 0; c < cl; ++c)
        sm90::mbar_arrive_cluster(s.extra() + kG1MaxStages + prev_slot, c);
    // d[4 j + 2 h + e] is lane (M) m0 + 8 h of the tile, row (N) 8 j + nq + e.
#pragma unroll
    for (int i = 0; i < M1_TILES; ++i) {
      if (i < nmt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = (tile0 + 2 * i) * 64 + m0 + 8 * h;
#pragma unroll
          for (int j = 0; j < N1 / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 8 * j + nq + e;
              if (k < p.w_len && n < rows)
                slab[(size_t)n * p.wp + k] = acc[i][4 * j + 2 * h + e];
            }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gl_fused_kernel(const GlFusedArgs p, __grid_constant__ const CUtensorMap map_q,
                __grid_constant__ const CUtensorMap map_wi,
                __grid_constant__ const CUtensorMap map_w) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int slab_index;
  const TailSmem s = tail_smem(smem_raw, p.w_len);
  const uint32_t cl = sm90::cluster_nctarank();
  if (threadIdx.x == 0) {
    tail_init_barriers(s, cl);
    for (int i = 0; i < kG1MaxStages; ++i) {
      sm90::mbar_init(s.extra() + i, 1);
      sm90::mbar_init(s.extra() + kG1MaxStages + i, 2 * cl);
    }
    sm90::mbar_init(s.extra() + 2 * kG1MaxStages, kConsumers);
    sm90::fence_barrier_init();
    // A free slab.  A block waits for one while its cluster partner may hold
    // one and wait for the block, so there must be a slab for every block the
    // card holds at once: the launch function refuses fewer.  The registers
    // (384 threads x 168) keep a SM to one block, so the first look, at the
    // SM's own number, nearly always finds its slab free.
    uint32_t smid;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(smid));
    int i = smid % p.n_slabs;
    for (int tries = 0; atomicExch(p.slab_free + i, 0) != 1; ++tries) {
      i = (i + 1) % p.n_slabs;
      if (tries > (1 << 22)) __trap();
    }
    slab_index = i;
  }
  sm90::cluster_sync();
  const int t0 = blockIdx.x * BM;
  const int bi = blockIdx.y;
  const int slab = slab_index;
  if (threadIdx.x >= kConsumers) {
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      g1_producer(p, s, &map_q, &map_wi, t0, min(bi, p.Bt - 1));
      sm90::mbar_wait(s.extra() + 2 * kG1MaxStages, 0);
      tail_producer<float>(p, s, p.frames + (size_t)slab * N1 * p.wp, t0 - p.d_max,
                           &map_w, t0);
    }
    sm90::cluster_sync();
  } else {
    sm90::reg_alloc<kConsumerRegs>();
    g1_consumer(p, s, p.frames + (size_t)slab * N1 * p.wp);
    // The slab's stores before the bulk copies that read it back.
    sm90::fence_proxy_async();
    sm90::mbar_arrive(s.extra() + 2 * kG1MaxStages);
    tail_build_panel<float>(p, s, t0);
    if (threadIdx.x == 0) atomicExch(p.slab_free + slab, 1);
    tail_gemm_renorm<false>(p, s, t0, bi);
    sm90::cluster_sync();
  }
}

// The wide configuration (gl_wide.cuh): a persistent block walks work items of
// 64 frames of one utterance: GEMM1 for them and D halo frames a side into the
// f32 part of its slab (g1_rows(D) rows), the panel from there into the rest,
// then GEMM2 (its sums in mode kSum, wide::gemm2_sum) and the renorm a column
// tile at a time.
template <typename OT, int kSum>
__global__ void __launch_bounds__(wide::kThreads, 2)
gl_fused_wide_kernel(const GlFusedArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* slab = reinterpret_cast<unsigned char*>(p.frames) +
                        blockIdx.x * wide::slab_bytes(p.wp, sizeof(OT), true, p.d_max);
  float* f = reinterpret_cast<float*>(slab);
  OT* panel = reinterpret_cast<OT*>(slab + (size_t)wide::g1_rows(p.d_max) * p.wp * 4);
  const int n_rb = (p.T + wide::kRows - 1) / wide::kRows;
  for (int item = blockIdx.x; item < n_rb * p.Bt; item += gridDim.x) {
    const int t0 = item % n_rb * wide::kRows, bi = item / n_rb;
    wide::gemm1<OT>(p, smem, reinterpret_cast<const OT*>(p.q),
                    reinterpret_cast<const OT*>(p.w_inv_t), f, t0, bi);
    wide::build_panel<OT>(p, panel, t0, [&](int u) {
      return f + (size_t)(u - t0 + p.d_max) * p.wp;
    });
    wide::gemm2_renorm<false, kSum, OT>(p, smem, panel,
                                        reinterpret_cast<const OT*>(p.w_fwd_t), t0, bi);
  }
}

// The instances (gl_semi.cu's), each with its attribute set once ([sum]).
bool wide_ready[3];

}  // namespace

extern "C" {

// Dynamic shared memory of a launch, or -1 when the halo does not fit the
// GEMM1 tile (BM + 2 d_max > 72) or GEMM1's ring has no two stages.
int sstts_gl_fused_smem_bytes(int w_len, int d_max) {
  if (BM + 2 * d_max > N1 || g1_stages(w_len) < 2 || !f_rows_fit(w_len, d_max, 4))
    return -1;
  return tail_smem_bytes(w_len);
}

// Requires wp % 64 == 0, hp % 128 == 0, 16-byte aligned tensors,
// 0 <= sstts_gl_fused_smem_bytes(w_len, d_max) <= 232448 and slabs that are
// all flagged free; returns -2 for fewer slabs than blocks the card can hold
// at once (one per SM as the kernel is built).
int sstts_gl_fused(const GlFusedArgs* a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = tail_smem_bytes(a->w_len);
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        gl_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  static int resident_smem = -1, resident = 0;  // blocks at once, at `smem`
  if (smem != resident_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gl_fused_kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    resident = per_sm * sms;
    resident_smem = smem;
  }
  if (resident > a->n_slabs) return -2;
  const uint64_t L = 2 * (uint64_t)a->hp;
  CUtensorMap map_q, map_wi, map_w;
  int rc;
  {
    const uint64_t dims[3] = {L, (uint64_t)a->T, (uint64_t)a->Bt};
    const uint64_t strides[2] = {L * 2, (uint64_t)a->T * L * 2};
    const uint32_t box[3] = {BK, N1, 1};
    rc = sm90::encode_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a->q, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc == 0) {
    const uint64_t dims[2] = {L, (uint64_t)a->wp};
    const uint64_t strides[1] = {L * 2};
    const uint32_t box[2] = {BK, 64};
    rc = sm90::encode_map(&map_wi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a->w_inv_t,
                          dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc == 0) rc = encode_w_fwd_map(&map_w, a->w_fwd_t, a->hp, a->wp, a->w_len);
  if (rc != 0) return rc < 0 ? rc : -1000 - rc;
  const int cl = cluster_size(a->Bt);
  dim3 grid((a->T + BM - 1) / BM, round_up(a->Bt, cl));
  cudaError_t err = launch_clustered(gl_fused_kernel, grid, cl, smem, st, *a, map_q,
                                     map_wi, map_w);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The wide configuration: its shared memory, or -1 beyond its envelope
// (d_max > 128).
int sstts_gl_fused_wide_smem_bytes(int w_len, int d_max) {
  return wide::smem_bytes(w_len, d_max);
}

// Blocks of the wide kernel an SM holds, or -1.
int sstts_gl_fused_wide_blocks_per_sm(int f32) {
  using wide::blocks_per_sm;
  if (f32)
    return blocks_per_sm(gl_fused_wide_kernel<float, wide::kRounded>, wide_ready[wide::kRounded]);
  const int a = blocks_per_sm(gl_fused_wide_kernel<bf16, wide::kChained>,
                              wide_ready[wide::kChained]);
  const int b = blocks_per_sm(gl_fused_wide_kernel<bf16, wide::kCompensated>,
                              wide_ready[wide::kCompensated]);
  return a < b ? a : b;
}

// Requires wp % 64 == 0, hp % 128 == 0, 16-byte aligned tensors,
// 0 <= sstts_gl_fused_wide_smem_bytes(w_len, d_max), and a->n_slabs slabs of
// wide::slab_bytes(wp, elem, true, d_max) bytes at a->frames.
int sstts_gl_fused_wide(const GlFusedArgs* a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int items = (a->T + wide::kRows - 1) / wide::kRows * a->Bt;
  const int sum = wide::gemm2_sum(a->f32 != 0, a->w_len);
  if (sum == wide::kRounded)
    return wide::launch(gl_fused_wide_kernel<float, wide::kRounded>, wide_ready[sum], items,
                        a->n_slabs, st, *a);
  if (sum == wide::kCompensated)
    return wide::launch(gl_fused_wide_kernel<bf16, wide::kCompensated>, wide_ready[sum], items,
                        a->n_slabs, st, *a);
  return wide::launch(gl_fused_wide_kernel<bf16, wide::kChained>, wide_ready[sum], items,
                      a->n_slabs, st, *a);
}

const char* sstts_error_string(int code) { return tail_error_string(code); }

}  // extern "C"
