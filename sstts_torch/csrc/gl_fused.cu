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
// matrices and the envelope at 3.35 TB/s.
//
// Design (simple first; wgmma, TMA and clusters are later work): B2
// (csrc/gl_semi.cu) with GEMM1 in front, one block per (64 frames,
// utterance), 256 threads.  The f32 frames of the block and its halo do not
// fit in shared memory beside the 64 x wp bf16 A panel (72 x 1152 x 4 =
// 331 KB), so:
//   * phase 1 computes GEMM1 for an 80-row tile (64 rows + 2D halo rows,
//     rounded up to whole 16-row WMMA tiles; D <= 8) over 128-column
//     slices of wp with tensor-core WMMA (16x16x16 bf16), streaming q and
//     w_inv through a three-stage cp.async ring, and stores each f32 tile
//     into the block's own global scratch slab (80 x wp f32, 369 KB at wp
//     = 1152), which the block reads back at once and so mostly finds in L2;
//   * phases 2 and 3 are B2's, from gl_tail.cuh: the A panel built from that
//     slab (its shared memory reuses phase 1's ring), then per bin tile
//     GEMM2 and the renorm epilogue.
// The halo costs 16 extra GEMM1 rows per 64 (+25% of GEMM1): recomputed
// rather than exchanged, since blocks run in no order.

// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError().

#include "gl_tail.cuh"

extern "C" {

// Field order is mirrored by sstts_torch/dsp/gl_fused.py:_GlFusedArgs.
struct GlFusedArgs {
  const bf16* q;       // (Bt, T, 2 hp)
  const bf16* mag2;    // (Bt, T, 2 hp)
  const bf16* w_inv;   // (2 hp, wp), zero beyond w_len
  const bf16* w_fwd;   // (wp, 2 hp)
  const float* wss2d;  // (T, wp), zero beyond w_len and outside the signal
  float* frames;       // scratch (Bt, n_blocks * M1, wp), GEMM1's f32 frames
  bf16* q_out;         // (Bt, T, 2 hp)
  int Bt, T, wp, hp, w_len, hop, d_max;
};

}  // extern "C"

namespace {

constexpr int M1 = 80;        // GEMM1 rows: BM + 2 D <= M1, whole 16-row tiles
constexpr int BN1 = 128;      // GEMM1 columns per pass (8 warps x 16)
constexpr int BK1 = 32;
constexpr int A1_LD = BK1 + 8;
constexpr int B1_LD = BN1 + 8;

// GEMM1 stage: q rows r_lo + [0, M1) x columns [k0, k0 + BK1) into (M1,
// A1_LD), zeros for rows outside [0, T) and beyond BM + 2D; w_inv rows
// [k0, k0 + BK1) x columns [n0, n0 + BN1) into (BK1, B1_LD).
__device__ __forceinline__ void load_g1_stage(bf16* dst, const GlFusedArgs& p,
                                              const bf16* Q, int r_lo,
                                              int k0, int n0) {
  const int L = 2 * p.hp;
  const int rows = BM + 2 * p.d_max;
  constexpr int a_chunks = BK1 / 8;
  for (int c = threadIdx.x; c < M1 * a_chunks; c += kThreads) {
    const int r = c / a_chunks, col = (c % a_chunks) * 8;
    const int t = r_lo + r;
    bf16* d = dst + r * A1_LD + col;
    if (r < rows && t >= 0 && t < p.T)
      cp_async16(d, Q + (size_t)t * L + k0 + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  bf16* bdst = dst + M1 * A1_LD;
  constexpr int b_chunks = BN1 / 8;
  for (int c = threadIdx.x; c < BK1 * b_chunks; c += kThreads) {
    const int kk = c / b_chunks, col = (c % b_chunks) * 8;
    cp_async16(bdst + kk * B1_LD + col, p.w_inv + (size_t)(k0 + kk) * p.wp + n0 + col);
  }
}

__global__ void __launch_bounds__(kThreads) gl_fused_kernel(const GlFusedArgs p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int t0 = blockIdx.x * BM;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int L = 2 * p.hp;
  const int D = p.d_max;
  const int r_lo = t0 - D;  // the frame of scratch row 0
  const bf16* Q = p.q + (size_t)bi * p.T * L;
  float* Fs = p.frames + ((size_t)bi * gridDim.x + blockIdx.x) * M1 * p.wp;

  // Phase 1: GEMM1 into the f32 scratch slab.  Warp w owns columns
  // [16 w, 16 w + 16) of each 128-column pass and all five row tiles.
  {
    bf16* ring = reinterpret_cast<bf16*>(smem_raw);
    constexpr int stage_elems = M1 * A1_LD + BK1 * B1_LD;
    const int n_k = L / BK1;
    for (int n0 = 0; n0 < p.wp; n0 += BN1) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[M1 / 16];
#pragma unroll
      for (int i = 0; i < M1 / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_k) load_g1_stage(ring + s * stage_elems, p, Q, r_lo, s * BK1, n0);
        cp_async_commit();
      }
      for (int kc = 0; kc < n_k; ++kc) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = kc + STAGES - 1;
        if (nxt < n_k)
          load_g1_stage(ring + (nxt % STAGES) * stage_elems, p, Q, r_lo, nxt * BK1, n0);
        cp_async_commit();
        const bf16* sa = ring + (kc % STAGES) * stage_elems;
        const bf16* sb = sa + M1 * A1_LD;
#pragma unroll
        for (int ks = 0; ks < BK1 / 16; ++ks) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sb + (ks * 16) * B1_LD + warp * 16, B1_LD);
#pragma unroll
          for (int i = 0; i < M1 / 16; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, sa + (i * 16) * A1_LD + ks * 16, A1_LD);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring before it refills
#pragma unroll
      for (int i = 0; i < M1 / 16; ++i)
        wmma::store_matrix_sync(Fs + (size_t)(i * 16) * p.wp + n0 + warp * 16,
                                acc[i], p.wp, wmma::mem_row_major);
    }
  }
  __syncthreads();  // the slab's global writes are visible to the block

  // Phases 2 and 3: B2's, over the f32 slab (row 0 is frame r_lo).
  gl_tail<false>(p, smem_raw, Fs, r_lo);
}

}  // namespace

extern "C" {

int sstts_gl_fused_smem_bytes(int wp) {
  const int ring1 = STAGES * (M1 * A1_LD + BK1 * B1_LD) * 2;
  const int two = tail_smem_bytes(wp);
  return ring1 > two ? ring1 : two;
}

// Rows of the f32 scratch per utterance (n_blocks * M1), or -1 when the
// halo does not fit the GEMM1 tile (BM + 2 d_max > M1).
int sstts_gl_fused_scratch_rows(int T, int d_max) {
  if (BM + 2 * d_max > M1) return -1;
  return (T + BM - 1) / BM * M1;
}

// Requires wp % 128 == 0 (whole GEMM1 column passes), hp % 64 == 0,
// BM + 2 d_max <= 80 and sstts_gl_fused_smem_bytes(wp) <= 232448.
int sstts_gl_fused(const GlFusedArgs* a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_gl_fused_smem_bytes(a->wp);
  cudaError_t err = cudaFuncSetAttribute(
      gl_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a->T + BM - 1) / BM, a->Bt);
  gl_fused_kernel<<<grid, kThreads, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
