// Semi-fused Griffin-Lim iteration tail for Hopper (sm_90a): kernel B2.
//
// Replaces sstts/dsp/gl_fused.py:fused_reproject_analyze, the Pallas TPU
// kernel that fuses, for one Griffin-Lim iteration, everything after the
// synthesis GEMM:
//   1. the banded shift-add in the frames domain (the reprojection)
//        A[t, j] = bf16( wss2d[t, j] * sum_{d=-D..D} F[t-d, j+d*hop] ),
//      with the source lane j+d*hop kept inside the window support,
//   2. the analysis GEMM  S = A @ w_fwd  (bf16 operands, f32 accumulation),
//   3. the phase renorm   q' = s * rsqrt(re^2 + im^2 + 1e-24) * mag,
//      where bin j's real part sits in lane j and its imaginary part in lane
//      j + hp; with momentum, s is first extrapolated to s + m*(s - prev)
//      and the raw s is returned as well.
// The few reflect-pad edge rows are repaired afterwards in plain torch by
// the wrapper (sstts_torch/dsp/gl_fused.py), as the JAX package repairs them
// in XLA.
//
// Bound on the H100: operations.  At the main path's shapes (32 x 800 rows,
// K = w_len = 1101 of wp = 1152 lanes, N = 2048) the GEMM needs
// 2*25600*1101*2048 = 115.4 GFLOP, 0.1167 ms at 989 TFLOP/s bf16, against
// ~0.08 ms for its ~274 MB of traffic at 3.35 TB/s; it runs 60 times per
// batch at GL-60.  At that rate one SM would take in 64 bytes of w_fwd a
// clock, more than L2 can give 132 of them: the weights' way from L2, the
// panel's build and the epilogue's loads are what a design has to hide, not
// only the product.
//
// Design: grid (row block of BM = 64 frames, utterance), clusters of two
// blocks along the utterances, 384 threads: two consumer warpgroups and a
// producer.  The block is gl_tail.cuh's tail and nothing else: the panel
// from rows of the bf16 frames (JAX rounds at fr.astype(dtype)) that pass
// through shared memory once, GEMM2 on wgmma over a TMA ring of w_fwd that
// the cluster shares by multicast, the renorm in registers.  The tensor map
// of w_fwd is encoded on the host at every launch (microseconds).  PERF.md has the
// time of each stage (sstts_torch/tools/ablate_gl_semi.py builds this file
// with SSTTS_ABLATE set to skip stages).

// The kernel above is the whole-panel configuration: the bf16 loop at a
// window support up to 1152 lanes and D <= 8.  gl_semi_wide_kernel below
// runs gl_wide.cuh's wide configuration everywhere else up to D = 128, at
// any support and bin count, in bf16 or f32
// (sstts_torch/dsp/gl_tiles.py:config chooses).
//
// Plain C interface (bound with ctypes); launch on the caller's stream,
// return cudaGetLastError() (or a negative code when a tensor map cannot be
// encoded).

#include "gl_wide.cuh"

extern "C" {

// Field order is mirrored by sstts_torch/dsp/gl_fused.py:_GlArgs.
struct GlArgs {
  const bf16* frames;  // (Bt, T, wp)
  const bf16* mag2;    // (Bt, T, 2 hp)
  const bf16* w_fwd;   // (wp, 2 hp); this kernel reads w_fwd_t instead, the
                       // field stays so that the first port's build takes the
                       // same struct (tools/compare_gl_builds.py)
  const float* wss2d;  // (T, wp), zero beyond w_len and outside the signal
  const bf16* prev;    // (Bt, T, 2 hp) or NULL (classic iteration)
  bf16* q_out;         // (Bt, T, 2 hp)
  bf16* s_out;         // (Bt, T, 2 hp) or NULL
  int Bt, T, wp, hp, w_len, hop, d_max;
  float momentum;
  const bf16* w_fwd_t;  // (2 hp, wp): w_fwd transposed
  // The wide configuration (gl_wide.cuh) only; the whole-panel kernel reads
  // none of them.  With f32 set every tensor above but wss2d is f32.
  void* slab;           // n_slabs x wide::slab_bytes(wp, elem, false, d_max)
  int n_slabs;
  int f32;
};

}  // extern "C"

namespace {

// One instance for the classic iteration (prev NULL) and one with momentum.
template <bool kMomentum>
__global__ void __launch_bounds__(kThreads)
gl_semi_kernel(const GlArgs p, __grid_constant__ const CUtensorMap map_w) {
  extern __shared__ unsigned char smem_raw[];
  const TailSmem s = tail_smem(smem_raw, p.w_len);
  if (threadIdx.x == 0) {
    tail_init_barriers(s, sm90::cluster_nctarank());
    sm90::fence_barrier_init();
  }
  sm90::cluster_sync();
  const int t0 = blockIdx.x * BM;
  const int bi = blockIdx.y;
  if (threadIdx.x >= kConsumers) {
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers)
      // A member without an utterance reads the last one's frames.
      tail_producer<bf16>(
          p, s, p.frames + (size_t)min(bi, p.Bt - 1) * p.T * p.wp, 0, &map_w, t0);
    sm90::cluster_sync();  // no member leaves while another may signal it
  } else {
    sm90::reg_alloc<kConsumerRegs>();
    tail_build_panel<bf16>(p, s, t0);
    tail_gemm_renorm<kMomentum>(p, s, t0, bi);
    sm90::cluster_sync();
  }
}

// The wide configuration (gl_wide.cuh): a persistent block walks work items of
// 64 frames of one utterance: the panel from the frames (the loop dtype OT)
// into its slab, then GEMM2 (its sums in mode kSum, wide::gemm2_sum) and the
// renorm a column tile at a time.
template <typename OT, bool kMomentum, int kSum>
__global__ void __launch_bounds__(wide::kThreads, 2)
gl_semi_wide_kernel(const GlArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const OT* frames = reinterpret_cast<const OT*>(p.frames);
  OT* panel = reinterpret_cast<OT*>(static_cast<unsigned char*>(p.slab) +
                                    blockIdx.x * wide::slab_bytes(p.wp, sizeof(OT), false,
                                                                  p.d_max));
  const int n_rb = (p.T + wide::kRows - 1) / wide::kRows;
  for (int item = blockIdx.x; item < n_rb * p.Bt; item += gridDim.x) {
    const int t0 = item % n_rb * wide::kRows, bi = item / n_rb;
    const OT* f = frames + (size_t)bi * p.T * p.wp;
    wide::build_panel<OT>(p, panel, t0, [&](int u) { return f + (size_t)u * p.wp; });
    wide::gemm2_renorm<kMomentum, kSum, OT>(p, smem, panel,
                                            reinterpret_cast<const OT*>(p.w_fwd_t), t0, bi);
  }
}

// The instances: the bf16 loop's GEMM2 chained or compensated, the f32 loop's
// rounded; each with its attribute set once ([sum][momentum]).
bool wide_ready[3][2];

template <bool kMomentum>
int blocks_per_sm_of(int f32) {
  using wide::blocks_per_sm;
  if (f32)
    return blocks_per_sm(gl_semi_wide_kernel<float, kMomentum, wide::kRounded>,
                         wide_ready[wide::kRounded][kMomentum]);
  const int a = blocks_per_sm(gl_semi_wide_kernel<bf16, kMomentum, wide::kChained>,
                              wide_ready[wide::kChained][kMomentum]);
  const int b = blocks_per_sm(gl_semi_wide_kernel<bf16, kMomentum, wide::kCompensated>,
                              wide_ready[wide::kCompensated][kMomentum]);
  return a < b ? a : b;
}

template <bool kMomentum>
int launch_wide(const GlArgs* a, int items, cudaStream_t st) {
  const int sum = wide::gemm2_sum(a->f32 != 0, a->w_len);
  bool& ready = wide_ready[sum][kMomentum];
  if (sum == wide::kRounded)
    return wide::launch(gl_semi_wide_kernel<float, kMomentum, wide::kRounded>, ready, items,
                        a->n_slabs, st, *a);
  if (sum == wide::kCompensated)
    return wide::launch(gl_semi_wide_kernel<bf16, kMomentum, wide::kCompensated>, ready, items,
                        a->n_slabs, st, *a);
  return wide::launch(gl_semi_wide_kernel<bf16, kMomentum, wide::kChained>, ready, items,
                      a->n_slabs, st, *a);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch, or -1 when the rows of frames do not fit
// in the ring's memory or d_max is beyond a group of rows (8).
int sstts_gl_semi_smem_bytes(int w_len, int d_max) {
  return f_rows_fit(w_len, d_max, 2) ? tail_smem_bytes(w_len) : -1;
}

// Requires wp % 64 == 0, hp % 128 == 0, 16-byte aligned tensors and
// 0 <= sstts_gl_semi_smem_bytes(w_len, d_max) <= 232448.
int sstts_gl_semi(const GlArgs* a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = tail_smem_bytes(a->w_len);
  void (*kernel)(const GlArgs, const CUtensorMap) =
      a->prev ? gl_semi_kernel<true> : gl_semi_kernel<false>;
  static int smem_set[2] = {0, 0};
  if (smem > smem_set[a->prev != nullptr]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[a->prev != nullptr] = smem;
  }
  CUtensorMap map_w;
  const int rc = encode_w_fwd_map(&map_w, a->w_fwd_t, a->hp, a->wp, a->w_len);
  if (rc != 0) return rc < 0 ? rc : -1000 - rc;
  const int cl = cluster_size(a->Bt);
  dim3 grid((a->T + BM - 1) / BM, round_up(a->Bt, cl));
  cudaError_t err = launch_clustered(kernel, grid, cl, smem, st, *a, map_w);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The wide configuration: its shared memory, or -1 beyond its envelope
// (d_max > 128).
int sstts_gl_semi_wide_smem_bytes(int w_len, int d_max) {
  return wide::smem_bytes(w_len, d_max);
}

// Blocks of the wide kernel an SM holds (the fewest of its instances for
// the loop dtype), or -1.
int sstts_gl_semi_wide_blocks_per_sm(int f32) {
  const int a = blocks_per_sm_of<false>(f32), b = blocks_per_sm_of<true>(f32);
  return a < b ? a : b;
}

// Requires wp % 64 == 0, hp % 128 == 0, 16-byte aligned tensors,
// 0 <= sstts_gl_semi_wide_smem_bytes(w_len, d_max), and a->n_slabs slabs of
// wide::slab_bytes(wp, elem, false, d_max) bytes at a->slab.
int sstts_gl_semi_wide(const GlArgs* a, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int items = (a->T + wide::kRows - 1) / wide::kRows * a->Bt;
  return a->prev ? launch_wide<true>(a, items, st) : launch_wide<false>(a, items, st);
}

const char* sstts_error_string(int code) { return tail_error_string(code); }

}  // extern "C"
