// Device code shared by the two Griffin-Lim kernels that end in the analysis
// GEMM and the renorm: gl_semi.cu (kernel B2) and gl_fused.cu (kernel B5).
// `gl_tail` is everything a block of kThreads = 256 threads does after the
// synthesis frames F exist, for BM = 64 frames of one utterance:
//   1. the reprojected A panel (BM x wp bf16, 145 KB at wp = 1152) in shared
//      memory, built once:
//        A[t, j] = bf16( wss2d[t, j] * sum_{d=-D..D} F[t-d, j+d*hop] ),
//      each element the f32 sum of the nine shifted loads with the source
//      lane kept inside [0, w_len), d = 0 first and then -D..D without 0
//      (the Pallas kernels' order), rounded to bf16 once, so the shift-add
//      costs one pass however many output tiles follow.  F is B2's bf16
//      synthesis frames or B5's f32 GEMM1 slab.  A thread accumulates 4
//      rows x 5 lanes at a time, so each shift issues 20 independent loads;
//   2. for each tile of BN = 64 bins, the panel times BOTH halves of w_fwd
//      (real lanes j0.., imaginary lanes hp+j0..) into one 64 x 128 f32 tile
//      with tensor-core WMMA (16x16x16 bf16, a 32x32 tile per warp), w_fwd
//      streamed from L2 through a three-stage cp.async ring with one barrier
//      per K chunk, so the epilogue holds each bin's real and imaginary parts
//      together;
//   3. the renorm q' = s * rsqrt(re^2 + im^2 + 1e-24) * mag, after the
//      momentum extrapolation s + m*(s - prev) where the kernel takes one
//      (B2); bf16 out, two bins per thread (4-byte accesses, every load of
//      the tile issued before any is used).
// It is one function rather than three: split into three inlined functions,
// B2 ran slower than with the phases in its own body.  As one function, with
// one B2 instance for each of its two variants, both stay within 2% of that
// code with equal outputs (PERF.md has the readings).  The functions take
// the kernel's argument struct (GlArgs or GlFusedArgs), whose common fields
// have the same names.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

// Measurement only (sstts_torch/tools/ablate_gl_semi.py): a bit mask of
// phases to skip (1 the A panel, 2 the GEMM, 4 the epilogue).  0 in every
// other build, and the compiler then removes the tests below.
#ifndef SSTTS_ABLATE
#define SSTTS_ABLATE 0
#endif

namespace {

constexpr int BM = 64;  // frames per block
constexpr int BN = 64;  // bins per GEMM2 tile; the tile holds 2 * BN columns
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int kThreads = 256;
constexpr int A_PAD = 8;
constexpr int B_LD = 2 * BN + 8;
constexpr int C_LD = 2 * BN + 4;

// Shared memory of `gl_tail`: the A panel, then the GEMM2 ring, which the
// f32 tile aliases.
inline int tail_smem_bytes(int wp) {
  const int a = BM * (wp + A_PAD) * 2;
  const int b = STAGES * BK * B_LD * 2;
  const int c = BM * C_LD * 4;
  return a + (b > c ? b : c);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [k0, k0+BK) of w_fwd's columns [j0, j0+BN) and [hp+j0, ...) into a
// (BK, 2*BN) shared tile: 16-byte chunks, 4 per thread.
template <typename Args>
__device__ __forceinline__ void load_b_stage(bf16* dst, const Args& p, int k0,
                                             int j0) {
  const int L = 2 * p.hp;
  constexpr int chunks_per_row = 2 * BN / 8;
  for (int c = threadIdx.x; c < BK * chunks_per_row; c += kThreads) {
    const int kk = c / chunks_per_row;
    const int col = (c % chunks_per_row) * 8;
    const int gcol = col < BN ? j0 + col : p.hp + j0 + (col - BN);
    cp_async16(dst + kk * B_LD + col,
               p.w_fwd + (size_t)(k0 + kk) * L + gcol);
  }
}

// Phases 1-3 for frames [blockIdx.x * BM, + BM) of utterance blockIdx.y.
// F holds rows of p.wp lanes, its row 0 being frame f_row0.  kMomentum: the
// iteration takes p.prev, p.s_out and p.momentum (B2 with momentum; the
// kernel has no other use for them).  smem_raw holds tail_smem_bytes(p.wp)
// bytes.
template <bool kMomentum, typename Args, typename FT>
__device__ __forceinline__ void gl_tail(const Args& p, unsigned char* smem_raw,
                                        const FT* F, int f_row0) {
  using namespace nvcuda;
  const int lda = p.wp + A_PAD;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // (BM, lda)
  bf16* Bs = As + BM * lda;                      // STAGES x (BK, B_LD)
  float* Cs = reinterpret_cast<float*>(Bs);      // (BM, C_LD), aliases Bs
  const int t0 = blockIdx.x * BM;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 32-row slice
  const int wn = warp >> 1;  // 32-column slice of [re | im]
  const int L = 2 * p.hp;

  // Phase 1: the reprojected A panel, built once.
  constexpr int RG = 4;                 // rows per pass
  constexpr int KPT = 5;                // lanes per thread per pass
  for (int kb = 0; kb < ((SSTTS_ABLATE & 1) ? 0 : p.wp); kb += KPT * kThreads)
  for (int r0 = 0; r0 < BM; r0 += RG) {
    float acc[RG][KPT];
#pragma unroll
    for (int rr = 0; rr < RG; ++rr)
#pragma unroll
      for (int i = 0; i < KPT; ++i) acc[rr][i] = 0.f;
    for (int di = 0; di <= 2 * p.d_max; ++di) {
      // d = 0 first, then -D..-1, 1..D: the Pallas kernel's order.
      const int d = di == 0 ? 0 : (di <= p.d_max ? di - 1 - p.d_max : di - p.d_max);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        const int t = t0 + r0 + rr, ts = t - d;
        const bool row_ok = t < p.T && ts >= 0 && ts < p.T;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int k = kb + tid + i * kThreads, ks = k + d * p.hop;
          if (row_ok && k < p.w_len && ks >= 0 && ks < p.w_len)
            acc[rr][i] += as_f32(F[(size_t)(ts - f_row0) * p.wp + ks]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      const int t = t0 + r0 + rr;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int k = kb + tid + i * kThreads;
        if (k < p.wp) {
          const float w = t < p.T ? p.wss2d[(size_t)t * p.wp + k] : 0.f;
          As[(r0 + rr) * lda + k] = __float2bfloat16(acc[rr][i] * w);
        }
      }
    }
  }
  __syncthreads();

  // Phases 2 and 3: per bin tile, the GEMM over K through a STAGES-deep
  // cp.async ring (one barrier per K chunk), then the renorm epilogue.
  const int n_k = p.wp / BK;
  for (int j0 = 0; j0 < p.hp; j0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[i][f], 0.f);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_k) load_b_stage(Bs + s * BK * B_LD, p, s * BK, j0);
      cp_async_commit();
    }
    for (int kc = 0; kc < ((SSTTS_ABLATE & 2) ? 0 : n_k); ++kc) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nxt = kc + STAGES - 1;
      if (nxt < n_k) load_b_stage(Bs + (nxt % STAGES) * BK * B_LD, p, nxt * BK, j0);
      cp_async_commit();
      const bf16* stage = Bs + (kc % STAGES) * BK * B_LD;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              a[i], As + (wm * 32 + i * 16) * lda + kc * BK + ks * 16, lda);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          wmma::load_matrix_sync(
              bfr[f], stage + (ks * 16) * B_LD + wn * 32 + f * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int f = 0; f < 2; ++f)
            wmma::mma_sync(acc[i][f], a[i], bfr[f], acc[i][f]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < 2; ++f)
        wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + f * 16, acc[i][f],
            C_LD, wmma::mem_row_major);
    __syncthreads();

    // Epilogue: each thread takes bin pairs (j, j+1), so every global
    // access is a 4-byte bf16x2; all loads of the tile are issued before
    // any is used.
    constexpr int kPer = BM * BN / 2 / kThreads;
    float2 mre[kPer], mim[kPer], pre[kPer], pim[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / (BN / 2), j = 2 * (e % (BN / 2));
      const int t = t0 + r;
      if (!(SSTTS_ABLATE & 4) && t < p.T) {
        const size_t row = ((size_t)bi * p.T + t) * L;
        mre[u] = ld2(p.mag2 + row + j0 + j);
        mim[u] = ld2(p.mag2 + row + p.hp + j0 + j);
        if constexpr (kMomentum) {
          pre[u] = ld2(p.prev + row + j0 + j);
          pim[u] = ld2(p.prev + row + p.hp + j0 + j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / (BN / 2), j = 2 * (e % (BN / 2));
      const int t = t0 + r;
      if ((SSTTS_ABLATE & 4) || t >= p.T) continue;
      const size_t row = ((size_t)bi * p.T + t) * L;
      float sr0 = Cs[r * C_LD + j], sr1 = Cs[r * C_LD + j + 1];
      float si0 = Cs[r * C_LD + BN + j], si1 = Cs[r * C_LD + BN + j + 1];
      if constexpr (kMomentum) {
        st2(p.s_out + row + j0 + j, sr0, sr1);
        st2(p.s_out + row + p.hp + j0 + j, si0, si1);
        sr0 = sr0 + p.momentum * (sr0 - pre[u].x);
        sr1 = sr1 + p.momentum * (sr1 - pre[u].y);
        si0 = si0 + p.momentum * (si0 - pim[u].x);
        si1 = si1 + p.momentum * (si1 - pim[u].y);
      }
      const float inv0 = rsqrtf(sr0 * sr0 + si0 * si0 + 1e-24f);
      const float inv1 = rsqrtf(sr1 * sr1 + si1 * si1 + 1e-24f);
      st2(p.q_out + row + j0 + j, sr0 * inv0 * mre[u].x, sr1 * inv1 * mre[u].y);
      st2(p.q_out + row + p.hp + j0 + j, si0 * inv0 * mim[u].x,
          si1 * inv1 * mim[u].y);
    }
    __syncthreads();
  }
}

}  // namespace
