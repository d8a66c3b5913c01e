// Whole-sequence GRU for Hopper (sm_90a): kernel B3 of the port, forward
// and backward.
//
// Replaces sstts/ops/pallas_gru.py:gru_sequence (the Pallas TPU kernel that
// runs an entire GRU sequence in one pallas_call) and the recurrence of its
// gradient, gru_sequence_ad (which JAX differentiates through its lax.scan
// oracle).  Same math, gate order r, z, n and the "v3" candidate
// n = tanh(xn + r * (h @ Wh_n)):
//
//   gx = x @ Wx + b,  gh = h @ Wh,
//   r = sigmoid(xr + hr),  z = sigmoid(xz + hz),  n = tanh(xn + r * hn),
//   h' = z * h + (1 - z) * n,
//
// with the optional (B, T) mask freezing the carry and zeroing the output on
// padded steps (h = m*h' + (1-m)*h, out = m*h), and `reverse` walking T right
// to left while writing outputs in the original order.  All f32.
//
// Bound on the H100: the arithmetic, 2*B*T*(D + H)*3H = 5.0 GFLOP at B=32,
// T=800, D=H=128, is 0.075 ms of the card's f32 rate, and the bytes less.
// What sets the time is the serial chain: T dependent steps per utterance,
// each a 128-deep product, a gate, and a hand-over of h to every thread of
// the block, on 32 of the card's 132 SMs at B=32.  One step's 3H*H = 49,152
// multiply-adds take an SM's 128 f32 lanes 384 cycles to dispatch, and every
// 32-bit value a thread loads from shared memory takes one more cycle of
// its quarter's register-file write port (a float4 load four, whether the
// lanes read one address or 32), so a step costs about 550 cycles before
// the gates, two barriers and the hand-over: ~1,050 cycles (0.54 us) as
// measured.  The kernels below therefore stay several times over the
// roofline bound by design; everything that is not on that chain is kept
// off it.
//
// Three stages:
//  1. gru_input_proj: x @ Wx + b has no sequential dependence and runs as
//     one tiled f32 GEMM over all B*T rows (128x64 output tiles, 8x4
//     outputs a thread, both operands read from shared memory as float4,
//     the next slice loaded into registers while this one is multiplied).
//  2. The forward recurrence, one block per utterance, the loop over T
//     inside the block.
//     * H = 128 (gru_fwd_h128; the width of every GRU that gru_sequence
//       sees at the default configuration): 512 threads; thread (q, i) =
//       (tid / 128, tid % 128) owns hidden unit i and the K-quarter q and
//       keeps its 3 x 32 weights Wh[32q..32q+31, {i, H+i, 2H+i}] in
//       registers for the whole sequence.  q is the same in all lanes of a
//       warp, so each of a thread's 8 float4 loads of h is one broadcast;
//       three independent chains of 32 (one a gate) end in 3 x 4 partial
//       sums a unit in shared memory; after a barrier warps 0..3, one
//       thread a unit and every lane busy, add the four quarters, apply
//       the gates (ex2.approx / rcp.approx, see fast_sigmoid) and write h;
//       a second barrier ends the step.  (Four lanes a unit joined by
//       shuffles, with one barrier, was slower: every warp then runs the
//       gate's instructions with a quarter of its lanes, and the instruction
//       slots, not the barrier, are what a step runs out of.)  The step's
//       gx row and mask value arrive through an 8-deep cp.async ring in
//       shared memory, started 7 steps ahead by warps 4..7, so no load
//       from device memory is on the chain; the stores (out, and
//       gates/hprev when a gradient is wanted) are sent off and not waited
//       on.
//     * any other H up to 137 (gru_fwd_generic): one thread per gate
//       column, Wh in dynamic shared memory (3H*H*4 bytes of the 227 KB
//       opt-in), exact expf/tanhf, two barriers a step.
//     * H from 138 to 522 (gru_fwd_wide): Wh no longer fits one SM (786 KB
//       at H = 256, 3.1 MB at 512), so a thread-block cluster of C blocks
//       runs a tile of Bt rows of the batch, Bt = ceil(B / the clusters of C
//       the card holds), so that the whole batch runs in one wave (at B =
//       32: C = 5, 8, 16 and Bt = 2, 3, 5 at H = 138, 256, 512).  Rank c
//       owns U = ceil(H / C) hidden units and keeps their 3U gate columns
//       of Wh, transposed, in its shared memory (WideShape), and the tile's
//       whole carry (Bt, H).  A step: the (Bt, H) x (H, 3U) product in f32
//       FMAs, a thread taking one unit's three gate columns for every row of
//       the tile (each float4 of Wh feeds 4 Bt FMAs) over one of KS slices
//       of K, one block barrier, one thread a (row, unit) adds the slices in
//       order and applies the gates (exact expf/tanhf), writes its new h
//       into every rank's carry (distributed shared memory,
//       double-buffered), and one cluster barrier ends the step.  The
//       step's gx row is loaded into registers a step ahead.  C is the
//       smallest cluster, up to 16 (the non-portable cluster size), with
//       at most 32 units a rank where one allows, whose block holds the
//       rows that B = 32 needs for one wave (the wrapper's rule); from 523
//       no cluster's does, and the grid kind takes over.
//     * H from 523 to 5456 (gru_fwd_grid, the grid kind): one persistent
//       grid a direction, launched cooperatively, NB <= 132 blocks (one an
//       SM), all resident for the T steps.  Block c owns U = ceil(H / 132)
//       units for every sequence of the batch (U = 5, 6, 9, 16, 42 at H =
//       560, 752, 1104, 2048, 5456: 112, 126, 123, 128, 130 blocks) and keeps
//       their 3U gate columns of Wh in shared memory (GridShape: 119 KB at
//       1104).  A step: for each tile of 32 batch rows, the (32, H) x (H,
//       3U) product in f32 FMAs, the batch as the rows, the carry streamed
//       from a (2, Bp, KA) buffer in device memory through a 3-stage
//       cp.async.cg ring of K tiles (4 x 3 outputs a thread, K split over KS
//       slices added in a fixed order); one thread a (row, unit), up to 3
//       (row, unit) items a thread past U = 16, applies the gates and mask
//       and writes the unit's new carry into the buffer's other half; one
//       grid barrier (cg::this_grid().sync(), a fence and an arrival) ends
//       the step.  So Wh is read once a step for the whole batch; the carry
//       is written inside the launch, so it is read at L2 (cp.async.cg,
//       ld.global.cg), never through the non-coherent path.  Up to H =
//       1430 (backward 1419) the whole slice fits beside the ring; past
//       it the block keeps the K range [0, R) of its slice in
//       shared memory, R the most whole K tiles of 16 quads that fit beside
//       a ring whose stages also carry a tile of the slice's other rows
//       [R, KA), and streams those from a packed copy (gru_pack_grid, run
//       before the recurrence on the same stream) tile by tile, once a step
//       for the 32 rows of a batch tile: 32 MB a step in all at H = 2048
//       (L2 holds 50 MB; 16-byte copies), 370 MB at 5456 (read from HBM
//       every step; one bulk copy a tile).
//     When a gradient is wanted both write, per step, the gates r, z, n, the
//     recurrent candidate term hn and the carry before the step (5H floats;
//     42 MB at B=32, T=515, H=128), so that the backward never repeats the
//     forward's serial chain.
//  3. The reverse-time recurrence of the gradient, one block per utterance.
//     Per step, from the saved gates and the incoming carry gradient, it
//     writes the gate-preactivation gradients dgx (input side) and dgh
//     (recurrent side: dgx with the candidate's entry times r) and carries
//     dh_prev[k] = direct part + sum_c dgh[c] * Wh[k, c].  The carry
//     gradient passes straight through masked steps.
//     * H = 128 (gru_bwd_h128): 512 threads; warp s owns the 24 gate
//       columns 24s..24s+23 and lane l the four units 4l..4l+3, so a thread
//       keeps the 4 x 24 weights Wh[4l..4l+3, 24s..24s+23] in registers
//       (read once from the untransposed Wh) and each dgh value it loads
//       (6 float4 broadcasts a step) serves four multiply-adds.  The 16
//       warps' sums of a unit meet in shared memory; warps 0..3, one
//       thread a unit, add them, keep the direct part of dh[k] in a
//       register from step to step and do the elementwise phase; two
//       barriers a step.  The step's gates, hprev, dout and mask value
//       arrive through the same kind of cp.async ring (warps 4..10).
//     * any other H up to 137 (gru_bwd_generic): Wh transposed in dynamic
//       shared memory, three barriers a step.
//     * H from 138 to 522 (gru_bwd_wide): the forward's clusters, tiles and
//       columns of Wh.  Each rank computes the tile's dgh of its own 3U
//       columns (its units' gates), multiplies them by its slice of Wh into
//       a partial dh_prev for all H units of every row of the tile (a
//       thread two of Wh's rows over all 3U columns), and sends each unit's
//       partial to the rank that owns the unit (a reduce-scatter through
//       distributed shared memory, double-buffered); the owner adds the C
//       partials in rank order at the start of the next step.  One block
//       barrier and one cluster barrier a step.  (The grid backward's
//       layout, a rank holding its units' rows of Wh and gathering the
//       step's dgh, (Bt, 3H), would not fit beside Wh at H = 512.)
//     * H from 523 to 5456 (gru_bwd_grid): the forward's grid.  Block c
//       keeps the rows of Wh of its U units, all 3H columns (U x 3H: the
//       forward's bytes), in shared memory.  A step: for each row tile, the
//       (32, 3H) x (3H, U) product of the previous step's dgh, read from a
//       (2, Bp, KA) exchange buffer as the forward reads its carry, gives
//       dh_prev of its own units; one thread a (row, unit) forms dar, daz,
//       dan, writes dgx and dgh and the unit's three dgh values into the
//       buffer's other half (laid out block by block, 3U columns a block);
//       one grid barrier a step.  The step reads 3H floats a row from L2
//       into every block, three times the forward's.  Past H = 1419 the
//       forward's split of K: columns [0, R) of the slice in shared memory,
//       [R, KA) streamed through the ring from the packed copy.
//     The weight gradients dWx = xs^T dgx, dWh = h_prev^T dgh, db = sum dgx
//     and dxs = dgx Wx^T are large independent products that the wrapper
//     leaves to cuBLAS, as the JAX package leaves them to XLA.  Bound:
//     2*3H*H operations per step and utterance (1.6 GFLOP at B=32, T=515)
//     and ~100 MB of saved state and outputs, so ~0.03 ms; the 515
//     dependent steps set the time.
//
// The wrapper chooses the kernel from H (`kind`, and for the wide kind the
// cluster size, from which and B the library takes the tile's rows, for the
// grid kind its block count and its scratch: the
// zeroed exchange buffer and the packed copy); a kind that does not fit the
// shape is refused with cudaErrorInvalidValue, and a grid that the card
// cannot hold at once with cudaErrorCooperativeLaunchTooLarge, never
// replaced.
//
// Plain C interface (bound with ctypes); the launch goes on the caller's
// stream, nothing synchronises, and the return value is cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------------ tools --

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- the input projection --

constexpr int kPM = 128;  // rows of an output tile
constexpr int kPN = 64;   // columns of an output tile
constexpr int kPK = 16;   // depth of a staged slice

__global__ void __launch_bounds__(256, 2)
gru_input_proj(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int M, int K, int N) {
  // Two buffers of one staged slice each.  As is stored transposed,
  // (k, row), so that a thread's 8 rows are two float4; the 4 floats of
  // padding keep each row of As 16-byte aligned.
  __shared__ __align__(16) float As[2][kPK][kPM + 4];
  __shared__ __align__(16) float Bs[2][kPK][kPN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kPM;
  const int n0 = blockIdx.x * kPN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // A thread's share of a slice: 8 elements of x, 4 of w, held in registers
  // from the load (started before the products of the slice in hand) to the
  // store into the other buffer (after them).
  float pa[8], pb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = tid + 256 * u;
      const int gm = m0 + e / kPK, gk = k0 + e % kPK;
      pa[u] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + 256 * u;
      const int gk = k0 + e / kPN, gn = n0 + e % kPN;
      pb[u] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = tid + 256 * u;
      As[buf][e % kPK][e / kPK] = pa[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + 256 * u;
      Bs[buf][e / kPN][e % kPN] = pb[u];
    }
  };

  fetch(0);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kPK, buf ^= 1) {
    const bool more = k0 + kPK < K;
    if (more) fetch(k0 + kPK);
#pragma unroll
    for (int kk = 0; kk < kPK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8 + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }
  const int gn = n0 + tx * 4;
  const bool vec = (N % 4 == 0) && gn + 3 < N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
    float* o = out + (size_t)gm * N + gn;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0] + bias[gn], acc[i][1] + bias[gn + 1],
                      acc[i][2] + bias[gn + 2], acc[i][3] + bias[gn + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) o[j] = acc[i][j] + bias[gn + j];
    }
  }
}

// ------------------------------------------ recurrences at any width H --

__global__ void gru_fwd_generic(const float* __restrict__ gx,
                                const float* __restrict__ wh,
                                const float* __restrict__ mask,
                                float* __restrict__ out,
                                float* __restrict__ gates,
                                float* __restrict__ hprev, int T, int H,
                                int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* w_s = smem;          // (H, 3H) recurrent weights
  float* h_s = w_s + H * G;   // (H,) carry
  float* gh_s = h_s + H;      // (3H,) h @ Wh
  float* gx_s = gh_s + G;     // (3H,) this step's input projection
  const int b = blockIdx.x;

  for (int i = threadIdx.x; i < H * G; i += blockDim.x) w_s[i] = wh[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* gx_t = gx + ((size_t)b * T + t) * G;
    for (int n = threadIdx.x; n < G; n += blockDim.x) {
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(h_s[k], w_s[k * G + n], acc);
      gh_s[n] = acc;
      gx_s[n] = gx_t[n];
    }
    __syncthreads();
    const float m = mask ? mask[(size_t)b * T + t] : 1.f;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float r = sigmoidf_(gx_s[i] + gh_s[i]);
      const float z = sigmoidf_(gx_s[H + i] + gh_s[H + i]);
      const float n = tanhf(gx_s[2 * H + i] + r * gh_s[2 * H + i]);
      const float h = h_s[i];
      if (gates) {
        const size_t row = (size_t)b * T + t;
        float* g = gates + row * 4 * H;
        g[i] = r;
        g[H + i] = z;
        g[2 * H + i] = n;
        g[3 * H + i] = gh_s[2 * H + i];
        hprev[row * H + i] = h;
      }
      float hn = z * h + (1.f - z) * n;
      float o = hn;
      if (mask) {
        hn = m * hn + (1.f - m) * h;
        o = m * hn;
      }
      h_s[i] = hn;
      out[((size_t)b * T + t) * H + i] = o;
    }
    __syncthreads();
  }
}

// Reverse-time recurrence of the gradient (see the header).  Walks the steps
// in the opposite order to the forward scan.
__global__ void gru_bwd_generic(const float* __restrict__ dout,
                                const float* __restrict__ gates,
                                const float* __restrict__ hprev,
                                const float* __restrict__ wh,
                                const float* __restrict__ mask,
                                float* __restrict__ dgx,
                                float* __restrict__ dgh, int T, int H,
                                int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* wt_s = smem;           // (3H, H) Wh transposed
  float* dh_s = wt_s + G * H;   // (H,) gradient of the carry after the step
  float* dhc_s = dh_s + H;      // (H,) its direct part before the step
  float* dgh_s = dhc_s + H;     // (3H,) this step's recurrent gradient
  float* part_s = dgh_s + G;    // (3H,) three groups' partial sums
  const int b = blockIdx.x;

  for (int i = threadIdx.x; i < H * G; i += blockDim.x)
    wt_s[(i % G) * H + i / G] = wh[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) dh_s[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const size_t row = (size_t)b * T + t;
    const float m = mask ? mask[row] : 1.f;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float* g = gates + row * 4 * H;
      const float r = g[i], z = g[H + i], n = g[2 * H + i], hn = g[3 * H + i];
      const float h = hprev[row * H + i];
      // out = m * h_t, h_t = m * h' + (1 - m) * h.
      const float dh_t = dh_s[i] + m * dout[row * H + i];
      const float dh_new = m * dh_t;
      const float dz = dh_new * (h - n);
      const float dn = dh_new * (1.f - z);
      const float dan = dn * (1.f - n * n);
      const float dar = dan * hn * r * (1.f - r);
      const float daz = dz * z * (1.f - z);
      float* gxo = dgx + row * G;
      float* gho = dgh + row * G;
      gxo[i] = dar;
      gxo[H + i] = daz;
      gxo[2 * H + i] = dan;
      gho[i] = dar;
      gho[H + i] = daz;
      gho[2 * H + i] = dan * r;
      dgh_s[i] = dar;
      dgh_s[H + i] = daz;
      dgh_s[2 * H + i] = dan * r;
      dhc_s[i] = (1.f - m) * dh_t + dh_new * z;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < G; e += blockDim.x) {
      const int grp = e / H, k = e % H;
      const float* w = wt_s + (size_t)grp * H * H + k;
      const float* d = dgh_s + grp * H;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < H; ++c) acc = fmaf(d[c], w[c * H], acc);
      part_s[e] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < H; i += blockDim.x)
      dh_s[i] = dhc_s[i] + part_s[i] + part_s[H + i] + part_s[2 * H + i];
    __syncthreads();
  }
}

// ------------------------------------ recurrences past H = 137: clusters --

constexpr int kWideThreads = 512;  // threads of a wide block, at most
constexpr int kMaxCluster = 16;
constexpr int kWideMaxRows = 8;    // batch rows of a cluster's tile, at most
constexpr int kWideMaxSmem = 232448;  // a block's shared memory, the opt-in
// More than half an SM's shared memory (228 KB, less 1 KB a block), so that
// the card places one wide block on an SM, as kWideClusters counts them.
constexpr int kWideMinSmem = 118784;
// Clusters of C blocks, one block an SM, that an H100 SXM holds at once
// (index C; cudaOccupancyMaxActiveClusters, which
// sstts_gru_wide_active_clusters reads on the card).  A cluster takes
// ceil(B / kWideClusters[C]) batch rows, so that the batch runs in one wave.
constexpr int kWideClusters[kMaxCluster + 1] = {0, 132, 66, 39, 30, 22, 17, 15, 15,
                                                9, 7,   7,  7,  7,  7,  7,  7};

// The wide kernels' split of width H over a cluster of C blocks that runs a
// tile of `rows` batch rows (see the header); rank c owns U = ceil(H / C)
// units.  Forward (bwd = 0): the rank keeps its units' N = 3U gate columns
// of Wh, transposed, as N slice rows of the K = H carry columns; thread
// (i, ks) takes slice rows i, i + U, i + 2U (unit i's three gates) for every
// row of the tile over the float4 quads ks, ks + KS, ... of K and leaves
// KS partial sums; KS the most slices, up to kWideThreads / U and the quads
// of K, whose sums fit beside the slice and the tile's carry (2, rows, KA).
// Backward: the same 3U columns, untransposed, as N = 2 NG slice rows
// (Wh's rows: the units of dh_prev; NG = ceil(H / 2)) of K = 3U columns;
// thread i takes slice rows i and i + NG over all of K (KS = 1), beside
// the step's dgh of the rank's columns (rows, KA) and each rank's partial
// dh_prev of the rank's units (2, C, rows, U).  K padded to KA, a multiple
// of 4; slice rows ldw floats apart, 4 mod 8, so that the 8 lanes of a
// quarter warp reading 8 rows 16 bytes each hit 32 distinct banks.  The
// gate pass takes one (row, unit) item a thread.
struct WideShape {
  int C, bwd, rows, U, NG, N, KA, ldw, KS, threads;
  __host__ __device__ WideShape(int H, int C_, int rows_, int bwd_)
      : C(C_), bwd(bwd_), rows(rows_) {
    U = (H + C - 1) / C;
    NG = bwd ? (H + 1) / 2 : U;
    N = bwd ? 2 * NG : 3 * U;
    KA = ((bwd ? 3 * U : H) + 3) / 4 * 4;
    ldw = KA % 8 == 4 ? KA : KA + 4;
    KS = 1;
    while (!bwd && KS < kWideThreads / U && KS < KA / 4 && floats(KS + 1) * 4 <= kWideMaxSmem)
      ++KS;
    const int prod = bwd ? NG : U * KS, gate = rows * U;
    threads = ((prod > gate ? prod : gate) + 31) / 32 * 32;
  }
  __host__ __device__ int floats(int ks) const {
    return N * ldw + (bwd ? rows * KA + 2 * C * rows * U : 2 * rows * KA + ks * rows * N);
  }
  __host__ __device__ int smem_bytes() const {
    return floats(KS) * 4 > kWideMinSmem ? floats(KS) * 4 : kWideMinSmem;
  }
  __host__ __device__ bool valid() const {
    return C >= 2 && C <= kMaxCluster && rows >= 1 && rows <= kWideMaxRows &&
           threads <= kWideThreads && floats(KS) * 4 <= kWideMaxSmem;
  }
};

// The batch rows of a cluster's tile at (H, B) on clusters of C: enough for
// the batch in one wave of the clusters the card holds, at most
// kWideMaxRows, fewer where the forward's or the backward's block would not
// fit; 0 where not one row fits.
int wide_rows(int H, int B, int C) {
  if (C < 2 || C > kMaxCluster || B < 1) return 0;
  int rows = (B + kWideClusters[C] - 1) / kWideClusters[C];
  for (rows = rows < kWideMaxRows ? rows : kWideMaxRows; rows >= 1; --rows)
    if (WideShape(H, C, rows, 0).valid() && WideShape(H, C, rows, 1).valid()) return rows;
  return 0;
}

// acc[r][j] += x[r] . w[j NG] over the float4 quads q0, q0 + step, ... <
// quads, in order, in f32 FMAs: kRows rows of the tile (x, ldx floats
// apart) times kW slice rows (w, NG rows of ldw floats apart).  Each
// float4 of the slice feeds kRows x 4 FMAs, each of the tile kW x 4.  The
// loop is unrolled by 4, so that the next quads' loads issue before this
// one's FMAs (5% off the backward at 5 rows, and the forward at 512).
template <int kRows, int kW>
__device__ __forceinline__ void wide_dot(float (&acc)[kRows][kW], const float* w, int ldw,
                                         int NG, const float* x, int ldx, int q0, int quads,
                                         int step) {
#pragma unroll 4
  for (int q = q0; q < quads; q += step) {
    float4 wv[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j)
      wv[j] = *reinterpret_cast<const float4*>(w + (size_t)j * NG * ldw + 4 * q);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(x + r * ldx + 4 * q);
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        acc[r][j] = fmaf(xv.x, wv[j].x, acc[r][j]);
        acc[r][j] = fmaf(xv.y, wv[j].y, acc[r][j]);
        acc[r][j] = fmaf(xv.z, wv[j].z, acc[r][j]);
        acc[r][j] = fmaf(xv.w, wv[j].w, acc[r][j]);
      }
    }
  }
}

// The forward.  Cluster q runs batch rows [q kRows, q kRows + kRows) (rows
// past B are carried as zeros and write nothing); rank c owns units [c U,
// c U + U) and keeps their gate columns of Wh, transposed (w_s[g U + u][k]
// = Wh[k][g H + c U + u]), and the tile's whole carry, double-buffered:
// step s reads half s & 1, and each gate thread writes its unit's new
// carry into half (s + 1) & 1 of every rank (distributed shared memory);
// one block barrier and one cluster barrier a step.
template <int kRows>
__global__ void __launch_bounds__(kWideThreads, 1)
gru_fwd_wide(const float* __restrict__ gx, const float* __restrict__ wh,
             const float* __restrict__ mask, float* __restrict__ out,
             float* __restrict__ gates, float* __restrict__ hprev, int B, int T, int H,
             int reverse) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const WideShape ws(H, C, kRows, 0);
  const int U = ws.U, N = ws.N, KA = ws.KA, tid = threadIdx.x;
  float* w_s = smem;                     // (N, ldw) the rank's gate columns, transposed
  float* h_s = w_s + N * ws.ldw;         // (2, kRows, KA) the tile's carry
  float* part_s = h_s + 2 * kRows * KA;  // (KS, kRows, N) the K slices' sums
  const int b0 = blockIdx.x / C * kRows;

  for (int i = tid; i < N * ws.ldw; i += blockDim.x) {  // neighbouring threads, neighbouring units
    const int k = i / N, n = i - k * N, g = n / U, unit = c * U + (n - g * U);
    w_s[n * ws.ldw + k] = k < H && unit < H ? wh[(size_t)k * 3 * H + g * H + unit] : 0.f;
  }
  for (int i = tid; i < 2 * kRows * KA; i += blockDim.x) h_s[i] = 0.f;

  // Product thread (item, ks): unit `item`'s three gate columns, slice ks.
  const int item = tid % U, ks = tid / U;
  const bool prod = ks < ws.KS;
  // Gate thread: row gr of the tile, unit c U + gu; its gx and mask value a
  // step ahead.
  const int gr = tid / U, gu = tid - gr * U, unit = c * U + gu, b = b0 + gr;
  const bool gate = gr < kRows && unit < H && b < B;
  const size_t row0 = (size_t)b * T;
  float nr = 0.f, nz = 0.f, nn = 0.f, nm = 1.f;
  auto fetch = [&](int s) {
    const size_t row = row0 + (reverse ? T - 1 - s : s);
    const float* g = gx + row * 3 * H;
    nr = g[unit];
    nz = g[H + unit];
    nn = g[2 * H + unit];
    nm = mask ? mask[row] : 1.f;
  };
  if (gate) fetch(0);
  float h_own = 0.f;
  cluster.sync();  // every rank's carry is zero before any peer writes it

  for (int s = 0; s < T; ++s) {
    const float* hc = h_s + (s & 1) * kRows * KA;
    const float xr = nr, xz = nz, xn = nn, m = nm;
    if (gate && s + 1 < T) fetch(s + 1);
    if (prod) {
      float acc[kRows][3] = {};
      wide_dot<kRows, 3>(acc, w_s + item * ws.ldw, ws.ldw, U, hc, KA, ks, KA / 4, ws.KS);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 3; ++j) part_s[(ks * kRows + r) * N + j * U + item] = acc[r][j];
    }
    __syncthreads();
    if (gate) {
      float hr = 0.f, hz = 0.f, hn = 0.f;
      for (int q = 0; q < ws.KS; ++q) {
        const float* p = part_s + (q * kRows + gr) * N + gu;
        hr += p[0];
        hz += p[U];
        hn += p[2 * U];
      }
      const float r = sigmoidf_(xr + hr);
      const float z = sigmoidf_(xz + hz);
      const float n = tanhf(xn + r * hn);
      const size_t row = row0 + (reverse ? T - 1 - s : s);
      if (gates) {
        float* g = gates + row * 4 * H;
        g[unit] = r;
        g[H + unit] = z;
        g[2 * H + unit] = n;
        g[3 * H + unit] = hn;
        hprev[row * H + unit] = h_own;
      }
      float h_new = z * h_own + (1.f - z) * n;
      float o = h_new;
      if (mask) {
        h_new = m * h_new + (1.f - m) * h_own;
        o = m * h_new;
      }
      h_own = h_new;
      out[row * H + unit] = o;
      float* dst = h_s + ((s + 1) & 1) * kRows * KA + gr * KA + unit;
      for (int rank = 0; rank < C; ++rank) *cluster.map_shared_rank(dst, rank) = h_new;
    }
    cluster.sync();  // the new carry is in every rank; the step's sums are read
  }
}

// The backward, on the forward's clusters and tiles.  Rank c keeps the same
// gate columns of Wh, untransposed (w_s[k][g U + u] = Wh[k][g H + c U +
// u]).  A step: each gate thread (row, unit of the rank) adds the C ranks'
// partial dh_prev of its unit in rank order to its direct part, forms dgx
// and dgh and leaves the unit's three dgh values in d_s; a block barrier;
// thread i multiplies the tile's d_s by slice rows i and i + NG, a partial
// dh_prev for those units from the rank's 3U columns, and sends each to the
// rank that owns the unit (a reduce-scatter through distributed shared
// memory, double-buffered); one cluster barrier.
template <int kRows>
__global__ void __launch_bounds__(kWideThreads, 1)
gru_bwd_wide(const float* __restrict__ dout, const float* __restrict__ gates,
             const float* __restrict__ hprev, const float* __restrict__ wh,
             const float* __restrict__ mask, float* __restrict__ dgx,
             float* __restrict__ dgh, int B, int T, int H, int reverse) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const WideShape ws(H, C, kRows, 1);
  const int U = ws.U, NG = ws.NG, KA = ws.KA, tid = threadIdx.x;
  float* w_s = smem;                   // (N, ldw) the rank's gate columns
  float* d_s = w_s + ws.N * ws.ldw;    // (kRows, KA) the step's dgh of those columns
  float* recv_s = d_s + kRows * KA;    // (2, C, kRows, U) each rank's partial dh_prev
  const int b0 = blockIdx.x / C * kRows;

  for (int i = tid; i < ws.N * ws.ldw; i += blockDim.x) {  // neighbouring threads, neighbouring columns
    const int k = i / ws.ldw, j = i - k * ws.ldw, g = j / U, unit = c * U + (j - g * U);
    w_s[i] = k < H && j < 3 * U && unit < H ? wh[(size_t)k * 3 * H + g * H + unit] : 0.f;
  }
  for (int i = tid; i < kRows * KA + 2 * C * kRows * U; i += blockDim.x) d_s[i] = 0.f;

  // Gate thread: row gr of the tile, unit c U + gu; its saved gates,
  // carry, output gradient and mask value a step ahead.
  const int gr = tid / U, gu = tid - gr * U, unit = c * U + gu, b = b0 + gr;
  const bool gate = gr < kRows && unit < H && b < B;
  const size_t row0 = (size_t)b * T;
  float nr = 0.f, nz = 0.f, nn = 0.f, nhn = 0.f, nh = 0.f, nd = 0.f, nm = 1.f;
  auto fetch = [&](int s) {
    const size_t row = row0 + (reverse ? s : T - 1 - s);
    const float* g = gates + row * 4 * H;
    nr = g[unit];
    nz = g[H + unit];
    nn = g[2 * H + unit];
    nhn = g[3 * H + unit];
    nh = hprev[row * H + unit];
    nd = dout[row * H + unit];
    nm = mask ? mask[row] : 1.f;
  };
  if (gate) fetch(0);
  float dhc = 0.f;  // direct part of the carry gradient, the gate threads
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    if (gate) {
      const float r = nr, z = nz, n = nn, hn = nhn, h = nh, d = nd, m = nm;
      if (s + 1 < T) fetch(s + 1);
      const float* rv = recv_s + ((s & 1) * C * kRows + gr) * U + gu;
      float dh = dhc;
      for (int q = 0; q < C; ++q) dh += rv[q * kRows * U];
      // out = m * h_t, h_t = m * h' + (1 - m) * h.
      const float dh_t = dh + m * d;
      const float dh_new = m * dh_t;
      const float dz = dh_new * (h - n);
      const float dan = dh_new * (1.f - z) * (1.f - n * n);
      const float dar = dan * hn * r * (1.f - r);
      const float daz = dz * z * (1.f - z);
      const size_t row = row0 + (reverse ? s : T - 1 - s);
      float* gxo = dgx + row * 3 * H;
      float* gho = dgh + row * 3 * H;
      gxo[unit] = dar;
      gxo[H + unit] = daz;
      gxo[2 * H + unit] = dan;
      gho[unit] = dar;
      gho[H + unit] = daz;
      gho[2 * H + unit] = dan * r;
      float* ds = d_s + gr * KA + gu;
      ds[0] = dar;
      ds[U] = daz;
      ds[2 * U] = dan * r;
      dhc = (1.f - m) * dh_t + dh_new * z;
    }
    __syncthreads();
    if (tid < NG) {
      float acc[kRows][2] = {};
      wide_dot<kRows, 2>(acc, w_s + tid * ws.ldw, ws.ldw, NG, d_s, KA, 0, KA / 4, 1);
      float* dst = recv_s + (((s + 1) & 1) * C + c) * kRows * U;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = tid + j * NG, owner = k / U;
        if (k >= H) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (b0 + r < B) *cluster.map_shared_rank(dst + r * U + k - owner * U, owner) = acc[r][j];
      }
    }
    cluster.sync();  // every partial has reached its owner
  }
}

// ---------------------- recurrences from H = 523 to 5456: a grid a direction --

constexpr int kGridBlocks = 132;   // the H100's SMs: the most blocks of a grid
constexpr int kGridThreads = 512;
constexpr int kGridRows = 32;      // batch rows of a tile
constexpr int kGridStages = 3;     // K tiles in the ring
constexpr int kGridStreamStages = 3;  // K tiles in the ring where the slice streams
constexpr int kGridStreamQuads = 16;  // quads of a K tile where the slice streams
constexpr int kGridGateItems = 3;  // (row, unit) gate items a thread, at most
constexpr int kGridMaxHidden = 5456;  // the widest H taken: U = 42 units a block
constexpr int kGridL2Bytes = 52428800;  // the H100's L2 (50 MB)
// How a grid kernel reads its slice: all of it from shared memory, or the
// streamed tiles by 16-byte copies, or by one bulk copy a tile.
constexpr int kGridResident = 0, kGridCopies = 1, kGridBulk = 2;

constexpr int kGridMaxSmem = 232448;  // a block's shared memory, the opt-in

// The grid kind's split of width H (see the header): U units a block, NB
// blocks; the exchanged row (the forward's carry, NB U wide; the backward's
// dgh, NB 3U wide, block by block) padded to KA, a multiple of the K tile
// KT; the block's slice of Wh as N rows (the forward's 3U gate columns; the
// backward's U rows of Wh, padded to a multiple of 3) of which the K range
// [0, R) lies in shared memory, ldw floats a row, and [R, KA) streams
// through the ring; the product's thread tile 4 batch rows x 3 slice rows,
// `items` tiles a row tile of the batch and KS slices of K, each taking
// `quads` float4 quads of a K tile, KT = 4 KS quads.  A K tile holds about
// 32 (forward) or 48 (backward) quads, fewer where the whole slice would
// pass the block's shared memory (down to 16): the step's reads of the
// exchanged rows from L2 are what a step waits on, and larger tiles wait
// fewer times.  Where the whole slice does not fit even then, the tile
// holds kGridStreamQuads quads, the ring kGridStreamStages stages, each
// also holding the tile's N slice rows, and R is the most whole tiles that
// fit beside that ring (R < KA).  Where the packed tiles of all blocks
// pass L2 (`bulk`: from H = 2377), so that every step reads them from HBM,
// a tile moves as one bulk copy, counted on an mbarrier a stage (each
// thread's 16-byte copies, waiting that long, hold back the product's
// issue); where L2 keeps them, as 16-byte copies beside the exchanged
// rows'.  ldw and ldt are 4 mod 8 floats, so that the 8 lanes of a quarter
// warp reading 8 rows 16 bytes each hit 32 distinct banks.  The gate pass
// takes (row, unit) items tid, tid + threads, ...: one a thread where the
// slice is resident, at most kGridGateItems where it streams.
struct GridShape {
  int U, NB, N, NG, items, KS, KT, KA, R, ldw, ldt, threads, stages;
  __host__ __device__ GridShape(int H, int bwd) {
    const int target[3] = {bwd ? 48 : 32, 32, 16};
    for (int i = 0; i < 3; ++i) {
      init(H, bwd, target[i]);
      if (smem_bytes() <= kGridMaxSmem) return;
    }
    init(H, bwd, kGridStreamQuads);
    stages = kGridStreamStages;
    for (R = 0; R + KT < KA && N * ld(R + KT) + ring_floats() + 2 * stages <= kGridMaxSmem / 4;)
      R += KT;
    ldw = ld(R);
  }
  __host__ __device__ void init(int H, int bwd, int target) {
    U = (H + kGridBlocks - 1) / kGridBlocks;
    NB = (H + U - 1) / U;
    const int K = bwd ? NB * 3 * U : NB * U;
    N = bwd ? 3 * ((U + 2) / 3) : 3 * U;
    NG = N / 3;
    items = (kGridRows / 4) * NG;
    KS = items <= kGridThreads ? kGridThreads / items : 0;
    const int quads = KS > 0 ? (target + KS - 1) / KS : 1;
    KT = 4 * (KS > 0 ? KS : 1) * quads;
    KA = (K + KT - 1) / KT * KT;
    R = KA;
    stages = kGridStages;
    ldw = ld(KA);
    ldt = ld(KT);
    // The product's threads, or as many as the gate items up to a block.
    const int prod = (items * KS + 31) / 32 * 32;
    const int gate = kGridRows * U < kGridThreads ? kGridRows * U : kGridThreads;
    threads = prod > gate ? prod : gate;
  }
  __host__ __device__ static int ld(int k) { return k % 8 == 4 ? k : k + 4; }
  __host__ __device__ bool streams() const { return R < KA; }
  __host__ __device__ bool bulk() const {
    return streams() && (long long)NB * pack_floats() * 4 > kGridL2Bytes;
  }
  __host__ __device__ int mode() const {
    return !streams() ? kGridResident : bulk() ? kGridBulk : kGridCopies;
  }
  __host__ __device__ int gate_items() const { return (kGridRows * U + threads - 1) / threads; }
  // Rows of a ring stage: the exchanged rows' tile, and where the slice
  // streams, its N rows' tile.
  __host__ __device__ int stage_rows() const { return kGridRows + (streams() ? N : 0); }
  // The ring, (stages, stage_rows, ldt); the K slices' sums, (KS, rows, N),
  // share its space once a row tile's product is done.
  __host__ __device__ int ring_floats() const {
    const int ring = stages * stage_rows() * ldt, part = KS * kGridRows * N;
    return ring > part ? ring : part;
  }
  // The slice's K range [0, R), the ring and, where the slice streams, an
  // mbarrier a stage.
  __host__ __device__ int smem_bytes() const {
    return (N * ldw + ring_floats() + (streams() ? 2 * stages : 0)) * 4;
  }
  // Floats of a block's packed K range [R, KA): its streamed K tiles, each
  // N rows of ldt floats (the ring's layout, so that one bulk copy moves a
  // tile).
  __host__ __device__ long long pack_floats() const {
    return (long long)(KA - R) / KT * N * ldt;
  }
  __host__ __device__ bool valid(int H) const {
    return H <= kGridMaxHidden && KS >= 1 && gate_items() <= (streams() ? kGridGateItems : 1) &&
           threads <= kGridThreads && NB <= kGridBlocks && smem_bytes() <= kGridMaxSmem;
  }
};

// Entry (n, k) of block c's slice of Wh, zero past H: forward w[g U +
// u][k] = Wh[k][g H + c U + u]; backward, the columns in the exchange
// buffer's order, w[u][c' 3U + g U + u'] = Wh[c U + u][g H + c' U + u'].
__device__ __forceinline__ float grid_slice(const float* __restrict__ wh, const GridShape& gs,
                                            int H, int bwd, int c, int n, int k) {
  const int U = gs.U;
  if (!bwd) {
    const int g = n / U, unit = c * U + (n - g * U);
    return k < H && unit < H ? wh[(size_t)k * 3 * H + g * H + unit] : 0.f;
  }
  const int G = 3 * U, c2 = k / G, g = (k - c2 * G) / U, u2 = k - c2 * G - g * U;
  const int unit = c * U + n, col = c2 * U + u2;
  return n < U && unit < H && c2 < gs.NB && col < H ? wh[(size_t)unit * 3 * H + g * H + col]
                                                    : 0.f;
}

// The K range [R, KA) of every block's slice, packed (NB, (KA - R) / KT,
// N, ldt): each streamed K tile as the ring holds it, zero in the padding,
// so that one bulk copy moves it.  Run before each launch that streams, on
// the same stream.
__global__ void gru_pack_grid(const float* __restrict__ wh, float* __restrict__ pack, int H,
                              int bwd) {
  const GridShape gs(H, bwd);
  const size_t per = gs.pack_floats(), n = per * gs.NB, tile = (size_t)gs.N * gs.ldt;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i / per);
    const size_t e = i - c * per;
    const int jt = (int)(e / tile), row = (int)(e % tile) / gs.ldt, q = (int)(e % gs.ldt);
    pack[i] = q < gs.KT ? grid_slice(wh, gs, H, bwd, c, row, gs.R + jt * gs.KT + q) : 0.f;
  }
}

// Block c's slice, the K range [0, R), into w_s (N, ldw); zero past R.
__device__ __forceinline__ void load_grid_slice(float* w_s, const float* __restrict__ wh,
                                                const GridShape& gs, int H, int bwd, int c) {
  for (int i = threadIdx.x; i < gs.N * gs.ldw; i += blockDim.x) {
    // Forward: neighbouring threads, neighbouring units (Wh's columns).
    const int k = bwd ? i % gs.ldw : i / gs.N, n = bwd ? i / gs.ldw : i % gs.N;
    w_s[(size_t)n * gs.ldw + k] = k < gs.R ? grid_slice(wh, gs, H, bwd, c, n, k) : 0.f;
  }
}

// P (rows, N) = A (kGridRows rows of an exchange buffer from `a`, KA wide)
// times the block's slice transposed, in f32 FMAs.  The K tiles of A stream
// through a ring in shared memory by cp.async.cg: A was
// written by other blocks in this launch, and .cg reads it at L2, the point
// of coherence, never from a stale L1 line; the ring's `stages` - 1 tiles
// ahead of the one in use are in flight.  The slice's tiles below R are
// read from w_s (N, ldw); those from R on arrive in the same ring stage as
// A's, from the block's packed tiles `wp`: one bulk copy a tile in mode
// kGridBulk (issued by thread 0, counted on the stage's mbarrier in `bars`;
// `phases` holds the parity each stage's barrier waits for next), 16-byte
// copies in A's groups in mode kGridCopies.  Thread (rg, ng, ks)
// sums batch rows rg + 8i and slice rows ng + NG j over the quads ks, ks +
// KS, ... of each tile in order, and leaves its 4 x 3 sums in part (KS,
// rows, N), aliasing the ring, behind a block barrier.
template <int kMode>
__device__ __forceinline__ void grid_product(const GridShape& gs, float* ring,
                                             const float* w_s, const float* wp, uint64_t* bars,
                                             uint32_t& phases, const float* a, bool prod, int rg,
                                             int ng, int ks) {
  constexpr bool kStream = kMode != kGridResident, bulk = kMode == kGridBulk;
  constexpr int stages = kStream ? kGridStreamStages : kGridStages;
  const int tid = threadIdx.x;
  const int kt4 = gs.KT / 4, tiles = gs.KA / gs.KT, chunks = kGridRows * kt4;
  const int rt = kStream ? gs.R / gs.KT : tiles, sr = kStream ? kGridRows + gs.N : kGridRows;
  const uint32_t wbytes = gs.N * gs.ldt * 4;
  auto issue = [&](int kt) {
    if (kt < tiles) {
      float* dst = ring + (kt % stages) * sr * gs.ldt;
      const float* src = a + (size_t)kt * gs.KT;
      for (int e = tid; e < chunks; e += blockDim.x) {
        const int r = e / kt4, q = e - r * kt4;
        cp_async16(dst + r * gs.ldt + 4 * q, src + (size_t)r * gs.KA + 4 * q);
      }
      if (kStream && kt >= rt) {  // the slice's rows of a streamed tile
        const float* w = wp + (size_t)(kt - rt) * gs.N * gs.ldt;
        float* wd = dst + kGridRows * gs.ldt;
        if constexpr (!bulk) {
          for (int e = tid; e < gs.N * kt4; e += blockDim.x) {
            const int r = e / kt4, q = e - r * kt4;
            cp_async16(wd + r * gs.ldt + 4 * q, w + r * gs.ldt + 4 * q);
          }
        } else if (tid == 0) {
          uint64_t* bar = bars + kt % stages;
          sm90::mbar_expect_tx(bar, wbytes);
          sm90::bulk_load(wd, w, wbytes, bar);
        }
      }
    }
    cp_async_commit();
  };
  float acc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < stages - 1; ++kt) issue(kt);
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<stages - 2>();  // this thread's copies of tile kt have landed
    if (bulk && kt >= rt) {  // and the tile's slice rows
      const int stage = kt % stages;
      sm90::mbar_wait(bars + stage, (phases >> stage) & 1u);
      phases ^= 1u << stage;
    }
    __syncthreads();  // everyone's have; everyone is done with tile kt - 1
    issue(kt + stages - 1);  // into tile kt - 1's stage
    if (prod) {
      const float* stage = ring + (kt % stages) * sr * gs.ldt;
      const float* as = stage + rg * gs.ldt;
      const bool resident = !kStream || kt < rt;
      const int ld = resident ? gs.ldw : gs.ldt;
      const float* ws = resident ? w_s + (size_t)ng * gs.ldw + kt * gs.KT
                                 : stage + (kGridRows + ng) * gs.ldt;
      for (int q = ks; q < kt4; q += gs.KS) {
        float4 av[4], wv[3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(as + 8 * i * gs.ldt + 4 * q);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          wv[j] = *reinterpret_cast<const float4*>(ws + (size_t)j * gs.NG * ld + 4 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            acc[i][j] = fmaf(av[i].x, wv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, wv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, wv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, wv[j].w, acc[i][j]);
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: its space takes the sums
  if (prod) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        ring[(ks * kGridRows + rg + 8 * i) * gs.N + ng + j * gs.NG] = acc[i][j];
  }
  // The sums' stores before the next tiles' bulk copies into their space.
  if constexpr (bulk) sm90::fence_proxy_async();
  __syncthreads();
}

// The streamed tiles' mbarriers, one a ring stage (mode kGridBulk), armed
// by thread 0 before the block's first barrier.
__device__ __forceinline__ void grid_init_bars(const GridShape& gs, uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < gs.stages; ++s) sm90::mbar_init(bars + s, 1);
    sm90::fence_barrier_init();
  }
}

// A thread's gate items: item i, e = tid + i threads, is (row gr[i] of
// each row tile, unit c U + gu[i]); `own[i]` where that unit exists.
template <int kItems>
struct GateItems {
  int gr[kItems], gu[kItems];
  bool own[kItems];
  __device__ GateItems(const GridShape& gs, int c, int H) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = threadIdx.x + i * blockDim.x;
      gr[i] = e / gs.U;
      gu[i] = e - gr[i] * gs.U;
      own[i] = e < kGridRows * gs.U && c * gs.U + gu[i] < H;
    }
  }
};

// The forward.  Block c owns units [c U, c U + U) and keeps their 3U gate
// columns of Wh, the K range [0, R), in shared memory (w_s[g U + u][k] =
// Wh[k][g H + c U + u]); `pack` holds every block's [R, KA) (unread where R
// = KA).  `xbuf` is the carry, (2, Bp, KA), zero on entry: step s reads
// half s & 1 and writes half (s + 1) & 1; one grid barrier a step.  A gate
// item keeps nothing between steps: its unit's carry comes back from the
// buffer it wrote (its own write, read at L2).
template <int kMode, int kItems>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_fwd_grid(const float* __restrict__ gx, const float* __restrict__ wh,
             const float* __restrict__ pack, const float* __restrict__ mask,
             float* __restrict__ out, float* __restrict__ gates, float* __restrict__ hprev,
             float* xbuf, int B, int T, int H, int reverse) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const GridShape gs(H, 0);
  const int c = blockIdx.x, tid = threadIdx.x, U = gs.U, N = gs.N;
  float* w_s = smem;                            // (N, ldw) the slice's K range [0, R)
  float* ring = w_s + (size_t)N * gs.ldw;       // the K tiles, then the sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + gs.ring_floats());
  const float* wp = pack + (size_t)c * gs.pack_floats();
  uint32_t phases = 0;
  if constexpr (kMode == kGridBulk) grid_init_bars(gs, bars);
  load_grid_slice(w_s, wh, gs, H, 0, c);
  const int Bp = (B + kGridRows - 1) / kGridRows * kGridRows;
  const size_t half = (size_t)Bp * gs.KA;
  const int item = tid % gs.items, ks = tid / gs.items;
  const bool prod = ks < gs.KS;
  const int rg = item % (kGridRows / 4), ng = item / (kGridRows / 4);
  const GateItems<kItems> gi(gs, c, H);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hc = xbuf + (s & 1) * half;
    float* hn = xbuf + ((s + 1) & 1) * half;
    for (int r0 = 0; r0 < B; r0 += kGridRows) {
      float xr[kItems], xz[kItems], xn[kItems], m[kItems], h[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {  // issued now, used after the product
        const int b = r0 + gi.gr[i], unit = c * U + gi.gu[i];
        xr[i] = xz[i] = xn[i] = h[i] = 0.f;
        m[i] = 1.f;
        if (gi.own[i] && b < B) {
          const size_t row = (size_t)b * T + t;
          const float* g = gx + row * 3 * H;
          xr[i] = g[unit];
          xz[i] = g[H + unit];
          xn[i] = g[2 * H + unit];
          if (mask) m[i] = mask[row];
          h[i] = __ldcg(hc + (size_t)b * gs.KA + unit);
        }
      }
      grid_product<kMode>(gs, ring, w_s, wp, bars, phases, hc + (size_t)r0 * gs.KA, prod, rg, ng, ks);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int b = r0 + gi.gr[i], unit = c * U + gi.gu[i];
        if (!(gi.own[i] && b < B)) continue;
        const size_t row = (size_t)b * T + t;
        float hr = 0.f, hz = 0.f, hh = 0.f;
        for (int q = 0; q < gs.KS; ++q) {
          const float* p = ring + (q * kGridRows + gi.gr[i]) * N + gi.gu[i];
          hr += p[0];
          hz += p[U];
          hh += p[2 * U];
        }
        const float r = sigmoidf_(xr[i] + hr);
        const float z = sigmoidf_(xz[i] + hz);
        const float n = tanhf(xn[i] + r * hh);
        if (gates) {
          float* g = gates + row * 4 * H;
          g[unit] = r;
          g[H + unit] = z;
          g[2 * H + unit] = n;
          g[3 * H + unit] = hh;
          hprev[row * H + unit] = h[i];
        }
        float h_new = z * h[i] + (1.f - z) * n;
        float o = h_new;
        if (mask) {
          h_new = m[i] * h_new + (1.f - m[i]) * h[i];
          o = m[i] * h_new;
        }
        out[row * H + unit] = o;
        hn[(size_t)b * gs.KA + unit] = h_new;
      }
      __syncthreads();  // the sums are read before the ring takes the next tiles
    }
    grid.sync();  // every block's new carry is in the buffer
  }
}

// The backward.  Block c owns units [c U, c U + U) and keeps their rows of
// Wh, all 3H columns, in the exchange buffer's order, the K range [0, R) in
// shared memory (w_s[u][c' 3U + g U + u'] = Wh[c U + u][g H + c' U + u'])
// and [R, KA) in `pack` (unread where R = KA).  `xbuf` holds (2, Bp, KA),
// the dgh of each step laid out block by block (block c' writes its 3U
// columns, [c' 3U, c' 3U + 3U)), then (Bp, NB U) the direct part of each
// unit's carry gradient; zero on entry.  Step s reads the previous step's
// dgh (half (s + 1) & 1) for dh_prev of its own units, and writes its own
// into half s & 1; one grid barrier a step.
template <int kMode, int kItems>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_bwd_grid(const float* __restrict__ dout, const float* __restrict__ gates,
             const float* __restrict__ hprev, const float* __restrict__ wh,
             const float* __restrict__ pack, const float* __restrict__ mask,
             float* __restrict__ dgx, float* __restrict__ dgh, float* xbuf, int B, int T, int H,
             int reverse) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const GridShape gs(H, 1);
  const int c = blockIdx.x, tid = threadIdx.x, U = gs.U, N = gs.N, G = 3 * U;
  float* w_s = smem;                            // (N, ldw) the slice's K range [0, R)
  float* ring = w_s + (size_t)N * gs.ldw;       // the K tiles, then the sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + gs.ring_floats());
  const float* wp = pack + (size_t)c * gs.pack_floats();
  uint32_t phases = 0;
  if constexpr (kMode == kGridBulk) grid_init_bars(gs, bars);
  load_grid_slice(w_s, wh, gs, H, 1, c);
  const int Bp = (B + kGridRows - 1) / kGridRows * kGridRows;
  const size_t half = (size_t)Bp * gs.KA;
  float* dhc = xbuf + 2 * half;  // (Bp, NB U)
  const int item = tid % gs.items, ks = tid / gs.items;
  const bool prod = ks < gs.KS;
  const int rg = item % (kGridRows / 4), ng = item / (kGridRows / 4);
  const GateItems<kItems> gi(gs, c, H);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    float* xc = xbuf + (s & 1) * half;
    const float* xp = xbuf + ((s + 1) & 1) * half;
    for (int r0 = 0; r0 < B; r0 += kGridRows) {
      float r[kItems], z[kItems], n[kItems], hn[kItems], h[kItems], d[kItems], m[kItems],
          dh[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {  // issued now, used after the product
        const int b = r0 + gi.gr[i], unit = c * U + gi.gu[i];
        r[i] = z[i] = n[i] = hn[i] = h[i] = d[i] = dh[i] = 0.f;
        m[i] = 1.f;
        if (gi.own[i] && b < B) {
          const size_t row = (size_t)b * T + t;
          const float* g = gates + row * 4 * H;
          r[i] = g[unit];
          z[i] = g[H + unit];
          n[i] = g[2 * H + unit];
          hn[i] = g[3 * H + unit];
          h[i] = hprev[row * H + unit];
          d[i] = dout[row * H + unit];
          if (mask) m[i] = mask[row];
          dh[i] = __ldcg(dhc + (size_t)b * gs.NB * U + unit);
        }
      }
      grid_product<kMode>(gs, ring, w_s, wp, bars, phases, xp + (size_t)r0 * gs.KA, prod, rg, ng, ks);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int b = r0 + gi.gr[i], unit = c * U + gi.gu[i];
        if (!(gi.own[i] && b < B)) continue;
        const size_t row = (size_t)b * T + t;
        float dhi = dh[i];
        for (int q = 0; q < gs.KS; ++q) dhi += ring[(q * kGridRows + gi.gr[i]) * N + gi.gu[i]];
        // out = m * h_t, h_t = m * h' + (1 - m) * h.
        const float dh_t = dhi + m[i] * d[i];
        const float dh_new = m[i] * dh_t;
        const float dz = dh_new * (h[i] - n[i]);
        const float dan = dh_new * (1.f - z[i]) * (1.f - n[i] * n[i]);
        const float dar = dan * hn[i] * r[i] * (1.f - r[i]);
        const float daz = dz * z[i] * (1.f - z[i]);
        float* gxo = dgx + row * 3 * H;
        float* gho = dgh + row * 3 * H;
        gxo[unit] = dar;
        gxo[H + unit] = daz;
        gxo[2 * H + unit] = dan;
        gho[unit] = dar;
        gho[H + unit] = daz;
        gho[2 * H + unit] = dan * r[i];
        float* x = xc + (size_t)b * gs.KA + c * G + gi.gu[i];
        x[0] = dar;
        x[U] = daz;
        x[2 * U] = dan * r[i];
        dhc[(size_t)b * gs.NB * U + unit] = (1.f - m[i]) * dh_t + dh_new * z[i];
      }
      __syncthreads();  // the sums are read before the ring takes the next tiles
    }
    grid.sync();  // every block's dgh of the step is in the buffer
  }
}

// ---------------------------------------------- recurrences at H = 128 --

constexpr int kH = 128;        // hidden units
constexpr int kG = 3 * kH;     // gate columns
constexpr int kThreads = 512;
constexpr int kRing = 8;       // steps in flight from device memory
constexpr int kFwdSlot = kG + 4;      // a gx row and the mask value
constexpr int kBwdSlot = 6 * kH + 4;  // gates, hprev, dout and the mask value
constexpr int kFetchWarp0 = 4;  // the warps from this one on start the copies

// Starts the copy of step s's gx row (and mask value) into its ring slot
// and commits it as one group; called by the threads from warp kFetchWarp0
// on, of which the first kG / 4 + 1 have something to copy.
__device__ __forceinline__ void fwd_fetch(float (*ring)[kFwdSlot],
                                          const float* __restrict__ gx,
                                          const float* __restrict__ mask,
                                          size_t row0, int s, int T,
                                          int reverse) {
  if (s < T) {
    const size_t row = row0 + (reverse ? T - 1 - s : s);
    float* slot = ring[s % kRing];
    const int c = threadIdx.x - 32 * kFetchWarp0;
    if (c < kG / 4)
      cp_async16(slot + 4 * c, gx + row * kG + 4 * c);
    else if (c == kG / 4 && mask)
      cp_async4(slot + kG, mask + row);
  }
  cp_async_commit();
}

// The gates of the H = 128 forward, from ex2.approx and rcp.approx (a few
// instructions each, where expf, an IEEE division and tanhf are ~80 on the
// step's serial chain).  Each is within ~1e-6 of the exact function in
// absolute terms, also where the result saturates (exp to inf gives 0 or 1,
// never NaN), which over 800 steps moves the output no further from the
// plain version than the exact functions do (4e-7 against 3e-7 of the
// largest value at T = 800).
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float fast_tanh(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_h128(const float* __restrict__ gx, const float* __restrict__ wh,
             const float* __restrict__ mask, float* __restrict__ out,
             float* __restrict__ gates, float* __restrict__ hprev, int T,
             int reverse) {
  __shared__ __align__(16) float h_s[kH];
  __shared__ __align__(16) float part_s[3][4][kH];  // (gate, K-quarter, unit)
  __shared__ __align__(16) float ring[kRing][kFwdSlot];
  const int tid = threadIdx.x;
  const int q = tid >> 7, i = tid & (kH - 1);  // q is the same in a warp
  const bool fetcher = q == 1;  // warps 4..7 (kFetchWarp0 on)
  const size_t row0 = (size_t)blockIdx.x * T;

  float w[3][32];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int kk = 0; kk < 32; ++kk)
      w[g][kk] = wh[(size_t)(32 * q + kk) * kG + g * kH + i];

  if (tid < kH) h_s[tid] = 0.f;
  if (fetcher) {
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s)
      fwd_fetch(ring, gx, mask, row0, s, T, reverse);
  }
  __syncthreads();

  float h_own = 0.f;  // h[i], in the threads with q = 0
  for (int s = 0; s < T; ++s) {
    if (fetcher) fwd_fetch(ring, gx, mask, row0, s + kRing - 1, T, reverse);

    // Every thread: its quarter of the three products for unit i.  All
    // lanes of a warp read the same h values (one broadcast a load).
    const float4* hb = reinterpret_cast<const float4*>(h_s + 32 * q);
    float ar = 0.f, az = 0.f, an = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 hv = hb[j];
      ar = fmaf(hv.x, w[0][4 * j], ar);
      az = fmaf(hv.x, w[1][4 * j], az);
      an = fmaf(hv.x, w[2][4 * j], an);
      ar = fmaf(hv.y, w[0][4 * j + 1], ar);
      az = fmaf(hv.y, w[1][4 * j + 1], az);
      an = fmaf(hv.y, w[2][4 * j + 1], an);
      ar = fmaf(hv.z, w[0][4 * j + 2], ar);
      az = fmaf(hv.z, w[1][4 * j + 2], az);
      an = fmaf(hv.z, w[2][4 * j + 2], an);
      ar = fmaf(hv.w, w[0][4 * j + 3], ar);
      az = fmaf(hv.w, w[1][4 * j + 3], az);
      an = fmaf(hv.w, w[2][4 * j + 3], an);
    }
    part_s[0][q][i] = ar;
    part_s[1][q][i] = az;
    part_s[2][q][i] = an;
    if (fetcher) cp_async_wait<kRing - 1>();  // this step's slot has landed
    __syncthreads();

    // Warps 0..3, one thread a unit, every lane busy: the gates.
    if (q == 0) {
      const float* rs = ring[s % kRing];
      const size_t row = row0 + (reverse ? T - 1 - s : s);
      const float hr = (part_s[0][0][i] + part_s[0][1][i]) +
                       (part_s[0][2][i] + part_s[0][3][i]);
      const float hz = (part_s[1][0][i] + part_s[1][1][i]) +
                       (part_s[1][2][i] + part_s[1][3][i]);
      const float hn = (part_s[2][0][i] + part_s[2][1][i]) +
                       (part_s[2][2][i] + part_s[2][3][i]);
      const float r = fast_sigmoid(rs[i] + hr);
      const float z = fast_sigmoid(rs[kH + i] + hz);
      const float n = fast_tanh(rs[2 * kH + i] + r * hn);
      if (kSave) {
        float* g = gates + row * 4 * kH;
        g[i] = r;
        g[kH + i] = z;
        g[2 * kH + i] = n;
        g[3 * kH + i] = hn;
        hprev[row * kH + i] = h_own;
      }
      float h_new = z * h_own + (1.f - z) * n;
      float o = h_new;
      if (mask) {
        const float m = rs[kG];
        h_new = m * h_new + (1.f - m) * h_own;
        o = m * h_new;
      }
      h_own = h_new;
      h_s[i] = h_new;
      out[row * kH + i] = o;
    }
    __syncthreads();
  }
}

// The same for the backward's step: gates, hprev, dout and the mask value,
// kH + kH / 2 + 1 threads with something to copy.
__device__ __forceinline__ void bwd_fetch(float (*ring)[kBwdSlot],
                                          const float* __restrict__ gates,
                                          const float* __restrict__ hprev,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ mask,
                                          size_t row0, int s, int T,
                                          int reverse) {
  if (s < T) {
    const size_t row = row0 + (reverse ? s : T - 1 - s);
    float* slot = ring[s % kRing];
    const int c = threadIdx.x - 32 * kFetchWarp0;
    if (c < kH)
      cp_async16(slot + 4 * c, gates + row * 4 * kH + 4 * c);
    else if (c < kH + kH / 4)
      cp_async16(slot + 4 * c, hprev + row * kH + 4 * (c - kH));
    else if (c < kH + kH / 2)
      cp_async16(slot + 4 * c, dout + row * kH + 4 * (c - kH - kH / 4));
    else if (c == kH + kH / 2 && mask)
      cp_async4(slot + 6 * kH, mask + row);
  }
  cp_async_commit();
}

constexpr int kBwdCols = kG / 16;  // gate columns a warp owns: 24

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_h128(const float* __restrict__ dout, const float* __restrict__ gates,
             const float* __restrict__ hprev, const float* __restrict__ wh,
             const float* __restrict__ mask, float* __restrict__ dgx,
             float* __restrict__ dgh, int T, int reverse) {
  __shared__ __align__(16) float d_s[kG];          // this step's dgh
  __shared__ __align__(16) float part_s[16][kH];   // (column slice, unit)
  __shared__ __align__(16) float ring[kRing][kBwdSlot];
  const int tid = threadIdx.x;
  const int slice = tid >> 5, lane = tid & 31;
  // Warps 4..10 hold the kH + kH / 2 + 1 threads that copy.
  const bool fetcher = slice >= kFetchWarp0 && slice < kFetchWarp0 + 7;
  const size_t row0 = (size_t)blockIdx.x * T;

  // Wh[4 * lane + u, 24 * slice + c]: each dgh value a thread loads serves
  // four units.
  float w[4][kBwdCols];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4* wr = reinterpret_cast<const float4*>(
        wh + (size_t)(4 * lane + u) * kG + kBwdCols * slice);
#pragma unroll
    for (int j = 0; j < kBwdCols / 4; ++j) {
      const float4 v = wr[j];
      w[u][4 * j] = v.x;
      w[u][4 * j + 1] = v.y;
      w[u][4 * j + 2] = v.z;
      w[u][4 * j + 3] = v.w;
    }
  }
  for (int e = tid; e < 16 * kH; e += kThreads) (&part_s[0][0])[e] = 0.f;
  if (fetcher) {
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s)
      bwd_fetch(ring, gates, hprev, dout, mask, row0, s, T, reverse);
    cp_async_wait<kRing - 2>();
  }
  __syncthreads();

  float dhc = 0.f;  // direct part of the carry gradient, threads 0..kH-1
  for (int s = 0; s < T; ++s) {
    if (fetcher)
      bwd_fetch(ring, gates, hprev, dout, mask, row0, s + kRing - 1, T, reverse);

    // Warps 0..3, one thread a unit: close the carry gradient of the step
    // before from the 16 slices' sums, then the elementwise phase.
    if (tid < kH) {
      const int k = tid;
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[c] = (part_s[c][k] + part_s[4 + c][k]) +
               (part_s[8 + c][k] + part_s[12 + c][k]);
      const float dh = dhc + ((p[0] + p[1]) + (p[2] + p[3]));

      const float* rs = ring[s % kRing];
      const size_t row = row0 + (reverse ? s : T - 1 - s);
      const float r = rs[k], z = rs[kH + k], n = rs[2 * kH + k];
      const float hn = rs[3 * kH + k], h = rs[4 * kH + k];
      const float m = mask ? rs[6 * kH] : 1.f;
      // out = m * h_t, h_t = m * h' + (1 - m) * h.
      const float dh_t = dh + m * rs[5 * kH + k];
      const float dh_new = m * dh_t;
      const float dz = dh_new * (h - n);
      const float dn = dh_new * (1.f - z);
      const float dan = dn * (1.f - n * n);
      const float dar = dan * hn * r * (1.f - r);
      const float daz = dz * z * (1.f - z);
      const float dghn = dan * r;
      float* gxo = dgx + row * kG;
      float* gho = dgh + row * kG;
      gxo[k] = dar;
      gxo[kH + k] = daz;
      gxo[2 * kH + k] = dan;
      gho[k] = dar;
      gho[kH + k] = daz;
      gho[2 * kH + k] = dghn;
      d_s[k] = dar;
      d_s[kH + k] = daz;
      d_s[2 * kH + k] = dghn;
      dhc = (1.f - m) * dh_t + dh_new * z;
    }
    __syncthreads();

    // Every thread: its 24 columns of dgh times its 4 x 24 weights.
    const float4* dq = reinterpret_cast<const float4*>(d_s + kBwdCols * slice);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBwdCols / 4; ++j) {
      const float4 v = dq[j];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = fmaf(v.x, w[u][4 * j], a[u]);
        a[u] = fmaf(v.y, w[u][4 * j + 1], a[u]);
        a[u] = fmaf(v.z, w[u][4 * j + 2], a[u]);
        a[u] = fmaf(v.w, w[u][4 * j + 3], a[u]);
      }
    }
    *reinterpret_cast<float4*>(&part_s[slice][4 * lane]) =
        make_float4(a[0], a[1], a[2], a[3]);
    if (fetcher) cp_async_wait<kRing - 2>();  // the next step's slot has landed
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Which kernel runs a recurrence; the wrapper chooses from H.
enum { SSTTS_GRU_GENERIC = 0, SSTTS_GRU_H128 = 1, SSTTS_GRU_WIDE = 2, SSTTS_GRU_GRID = 4 };

// Dynamic shared memory of the generic kernels at width H.
int sstts_gru_smem_bytes(int H) { return (H * 3 * H + H + 6 * H) * 4; }

int sstts_gru_bwd_smem_bytes(int H) { return (3 * H * H + 8 * H) * 4; }

// The batch rows of a wide cluster's tile at (H, B) on clusters of C
// (wide_rows; 0 where not one row fits).
int sstts_gru_wide_rows(int H, int B, int C) { return wide_rows(H, B, C); }

// Dynamic shared memory of one block of the wide forward (backward: 1) at
// width H in a cluster of C for a tile of `rows` batch rows (WideShape, at
// least kWideMinSmem), and its threads.
int sstts_gru_wide_smem_bytes(int H, int C, int rows, int backward) {
  return WideShape(H, C, rows, backward).smem_bytes();
}

int sstts_gru_wide_threads(int H, int C, int rows, int backward) {
  return WideShape(H, C, rows, backward).threads;
}

// Dynamic shared memory of one block of the grid kind's forward (backward:
// 1) at width H: the slice's K range [0, R) and the ring (gru_fwd_grid,
// gru_bwd_grid).
int sstts_gru_grid_smem_bytes(int H, int backward) { return GridShape(H, backward).smem_bytes(); }

// The K range of a block's slice that the grid kind's forward (backward:
// 1) keeps in shared memory at width H, R (KA, the whole padded range,
// where nothing streams).
int sstts_gru_grid_resident(int H, int backward) { return GridShape(H, backward).R; }

// The grid kind's exchange buffer at (B, H), in floats: (2, Bp, KA), and
// for the backward the carry gradient's direct part (Bp, NB U); Bp rows, a
// multiple of 32, so what follows it stays 16-byte aligned.
long long sstts_gru_grid_exchange_floats(int B, int H, int backward) {
  const GridShape gs(H, backward);
  const long long Bp = (B + kGridRows - 1) / kGridRows * kGridRows;
  return Bp * (2LL * gs.KA + (backward ? (long long)gs.NB * gs.U : 0));
}

// The grid kind's scratch at (B, H), in floats: the exchange buffer, then
// the packed K range [R, KA) of every block's slice (gru_pack_grid).
long long sstts_gru_grid_scratch_floats(int B, int H, int backward) {
  const GridShape gs(H, backward);
  return sstts_gru_grid_exchange_floats(B, H, backward) + gs.NB * gs.pack_floats();
}

// Blocks of the grid kind at width H (NB), and threads a block.
int sstts_gru_grid_blocks(int H) { return GridShape(H, 0).NB; }

int sstts_gru_grid_threads(int H, int backward) { return GridShape(H, backward).threads; }

}  // extern "C"

namespace {

// The instantiation of the wide forward and backward for a tile of `rows`
// batch rows (1 to kWideMaxRows).
using WideFwd = void (*)(const float*, const float*, const float*, float*, float*, float*, int,
                         int, int, int);
using WideBwd = void (*)(const float*, const float*, const float*, const float*, const float*,
                         float*, float*, int, int, int, int);

WideFwd wide_fwd_kernel(int rows) {
  static const WideFwd k[kWideMaxRows] = {gru_fwd_wide<1>, gru_fwd_wide<2>, gru_fwd_wide<3>,
                                          gru_fwd_wide<4>, gru_fwd_wide<5>, gru_fwd_wide<6>,
                                          gru_fwd_wide<7>, gru_fwd_wide<8>};
  return k[rows - 1];
}

WideBwd wide_bwd_kernel(int rows) {
  static const WideBwd k[kWideMaxRows] = {gru_bwd_wide<1>, gru_bwd_wide<2>, gru_bwd_wide<3>,
                                          gru_bwd_wide<4>, gru_bwd_wide<5>, gru_bwd_wide<6>,
                                          gru_bwd_wide<7>, gru_bwd_wide<8>};
  return k[rows - 1];
}

// The launch configuration of a wide kernel: `clusters` clusters of C
// blocks of the shape's threads, its shared memory allowed (and the
// non-portable cluster sizes past 8).
template <class Kernel>
cudaError_t wide_config(Kernel kernel, int clusters, const WideShape& ws, cudaStream_t st,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (!ws.valid()) return cudaErrorInvalidValue;
  const int C = ws.C, smem = ws.smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * C);
  cfg->blockDim = dim3(ws.threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launches a wide kernel over the batch, ceil(B / rows) clusters; a cluster
// that no part of the card can hold is refused here
// (cudaErrorInvalidConfiguration), before the launch.
template <class... Params, class... Args>
int launch_wide(void (*kernel)(Params...), const WideShape& ws, int B, cudaStream_t st,
                Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = wide_config(kernel, (B + ws.rows - 1) / ws.rows, ws, st, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiation of the grid kind's forward and backward for a shape:
// its mode, and one gate item a thread or up to kGridGateItems (always
// where the tiles move as bulk copies: past H = 2376, U >= 19).
using GridFwd = void (*)(const float*, const float*, const float*, const float*, float*,
                         float*, float*, float*, int, int, int, int);
using GridBwd = void (*)(const float*, const float*, const float*, const float*,
                         const float*, const float*, float*, float*, float*, int, int, int,
                         int);

GridFwd grid_fwd_kernel(const GridShape& gs) {
  if (gs.mode() == kGridResident) return gru_fwd_grid<kGridResident, 1>;
  if (gs.mode() == kGridBulk) return gru_fwd_grid<kGridBulk, kGridGateItems>;
  return gs.gate_items() == 1 ? gru_fwd_grid<kGridCopies, 1>
                              : gru_fwd_grid<kGridCopies, kGridGateItems>;
}

GridBwd grid_bwd_kernel(const GridShape& gs) {
  if (gs.mode() == kGridResident) return gru_bwd_grid<kGridResident, 1>;
  if (gs.mode() == kGridBulk) return gru_bwd_grid<kGridBulk, kGridGateItems>;
  return gs.gate_items() == 1 ? gru_bwd_grid<kGridCopies, 1>
                              : gru_bwd_grid<kGridCopies, kGridGateItems>;
}

// Launches a grid kernel cooperatively: NB blocks, all resident for the T
// steps (their grid barriers wait on each other).  A card without
// cooperative launches, or one whose SMs cannot hold the NB blocks at once
// (one block an SM: fewer SMs than NB), is refused here
// (cudaErrorCooperativeLaunchTooLarge), before the launch.
template <class... Params, class... Args>
int launch_grid(void (*kernel)(Params...), int H, int backward, cudaStream_t st,
                Args... args) {
  const GridShape gs(H, backward);
  if (!gs.valid(H)) return (int)cudaErrorInvalidValue;
  const int smem = sstts_gru_grid_smem_bytes(H, backward);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, gs.threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm * sms < gs.NB)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args...};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(gs.NB),
                                    dim3(gs.threads), params, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Packs the K range [R, KA) of every block's slice (gru_pack_grid) into
// `scratch` after its exchange buffer, on `st`, and points `pack` there;
// nothing to pack where the slice is resident.
int pack_grid(const float* wh, float* scratch, int B, int H, int backward, cudaStream_t st,
              const float** pack) {
  const GridShape gs(H, backward);
  if (!gs.valid(H) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  float* dst = scratch + sstts_gru_grid_exchange_floats(B, H, backward);
  *pack = dst;
  const size_t n = (size_t)gs.NB * gs.pack_floats();
  if (n == 0) return 0;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  gru_pack_grid<<<blocks, 256, 0, st>>>(wh, dst, H, backward);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// How many clusters of the wide forward (backward: 1) kernel at width H,
// cluster size C and a tile of `rows` batch rows the card holds at once, or
// minus a CUDA error code.
int sstts_gru_wide_active_clusters(int H, int C, int rows, int backward) {
  if (rows < 1 || rows > kWideMaxRows) return -(int)cudaErrorInvalidValue;
  const WideShape ws(H, C, rows, backward);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err;
  if (backward) {
    err = wide_config(wide_bwd_kernel(rows), 1, ws, 0, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, wide_bwd_kernel(rows), &cfg);
  } else {
    err = wide_config(wide_fwd_kernel(rows), 1, ws, 0, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, wide_fwd_kernel(rows), &cfg);
  }
  return err == cudaSuccess ? clusters : -(int)err;
}

// How many blocks of the grid kind's forward (backward: 1) at width H the
// card holds at once (a cooperative launch needs NB), or minus a CUDA error
// code.
int sstts_gru_grid_active_blocks(int H, int backward) {
  const GridShape gs(H, backward);
  const int smem = gs.smem_bytes();
  const void* kernel = backward ? reinterpret_cast<const void*>(grid_bwd_kernel(gs))
                                : reinterpret_cast<const void*>(grid_fwd_kernel(gs));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, gs.threads, smem);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// gx (M, N) = xs (M, K) @ wx (K, N) + b (N), all f32 and contiguous.
int sstts_gru_input_proj(const float* xs, const float* wx, const float* b,
                         float* gx, int M, int K, int N, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM);
  gru_input_proj<<<grid, 256, 0, st>>>(xs, wx, b, gx, M, K, N);
  return (int)cudaGetLastError();
}

// The forward recurrence over gx (B, T, 3H); see sstts_gru_sequence.
int sstts_gru_recurrence(const float* gx, const float* wh, const float* mask,
                         float* out, float* gates, float* hprev, float* scratch, int B,
                         int T, int H, int reverse, int kind, int cluster, void* stream) {
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == SSTTS_GRU_WIDE) {
    const int rows = wide_rows(H, B, cluster);
    if (rows < 1) return (int)cudaErrorInvalidValue;
    return launch_wide(wide_fwd_kernel(rows), WideShape(H, cluster, rows, 0), B, st, gx, wh, mask,
                       out, gates, hprev, B, T, H, reverse);
  }
  if (kind == SSTTS_GRU_GRID) {
    if (cluster != GridShape(H, 0).NB) return (int)cudaErrorInvalidValue;
    const float* pack = nullptr;
    const int rc = pack_grid(wh, scratch, B, H, 0, st, &pack);
    if (rc != 0) return rc;
    return launch_grid(grid_fwd_kernel(GridShape(H, 0)), H, 0, st, gx, wh, pack, mask, out,
                       gates, hprev, scratch, B, T, H, reverse);
  }
  if (kind == SSTTS_GRU_H128) {
    if (H != kH) return (int)cudaErrorInvalidValue;
    if (gates)
      gru_fwd_h128<true><<<B, kThreads, 0, st>>>(gx, wh, mask, out, gates,
                                                 hprev, T, reverse);
    else
      gru_fwd_h128<false><<<B, kThreads, 0, st>>>(gx, wh, mask, out, gates,
                                                  hprev, T, reverse);
    return (int)cudaGetLastError();
  }
  if (kind != SSTTS_GRU_GENERIC) return (int)cudaErrorInvalidValue;
  const int smem = sstts_gru_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_generic, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  gru_fwd_generic<<<B, threads, smem, st>>>(gx, wh, mask, out, gates, hprev,
                                            T, H, reverse);
  return (int)cudaGetLastError();
}

// xs (B, T, D), wx (D, 3H), wh (H, 3H), b (3H), mask (B, T) or NULL, all
// f32 and contiguous (16-byte aligned); gx_scratch (B, T, 3H) f32; out
// (B, T, H) f32; gates (B, T, 4H) and hprev (B, T, H) f32, or both NULL
// when no gradient is wanted.  `cluster` is the wide kind's C or the grid
// kind's NB (else unread); `scratch` the grid kind's,
// sstts_gru_grid_scratch_floats (B, H, 0) floats, its exchange buffer zero
// (else unread).
int sstts_gru_sequence(const float* xs, const float* wx, const float* wh,
                       const float* b, const float* mask, float* gx_scratch,
                       float* out, float* gates, float* hprev, float* scratch, int B,
                       int T, int D, int H, int reverse, int kind, int cluster,
                       void* stream) {
  const int rc =
      sstts_gru_input_proj(xs, wx, b, gx_scratch, B * T, D, 3 * H, stream);
  if (rc != 0) return rc;
  return sstts_gru_recurrence(gx_scratch, wh, mask, out, gates, hprev, scratch, B, T, H,
                              reverse, kind, cluster, stream);
}

// dout (B, T, H), gates (B, T, 4H), hprev (B, T, H) from the forward, wh
// (H, 3H), mask (B, T) or NULL, all f32 and contiguous (16-byte aligned);
// dgx and dgh (B, T, 3H) f32 outputs; `cluster` and `scratch` as in
// sstts_gru_sequence (the backward's: sstts_gru_grid_scratch_floats (B, H,
// 1) floats).
int sstts_gru_sequence_backward(const float* dout, const float* gates,
                                const float* hprev, const float* wh,
                                const float* mask, float* dgx, float* dgh,
                                float* scratch, int B, int T, int H, int reverse,
                                int kind, int cluster, void* stream) {
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kind == SSTTS_GRU_WIDE) {
    const int rows = wide_rows(H, B, cluster);
    if (rows < 1) return (int)cudaErrorInvalidValue;
    return launch_wide(wide_bwd_kernel(rows), WideShape(H, cluster, rows, 1), B, st, dout, gates,
                       hprev, wh, mask, dgx, dgh, B, T, H, reverse);
  }
  if (kind == SSTTS_GRU_GRID) {
    if (cluster != GridShape(H, 1).NB) return (int)cudaErrorInvalidValue;
    const float* pack = nullptr;
    const int rc = pack_grid(wh, scratch, B, H, 1, st, &pack);
    if (rc != 0) return rc;
    return launch_grid(grid_bwd_kernel(GridShape(H, 1)), H, 1, st, dout, gates, hprev, wh, pack,
                       mask, dgx, dgh, scratch, B, T, H, reverse);
  }
  if (kind == SSTTS_GRU_H128) {
    if (H != kH) return (int)cudaErrorInvalidValue;
    gru_bwd_h128<<<B, kThreads, 0, st>>>(dout, gates, hprev, wh, mask, dgx,
                                         dgh, T, reverse);
    return (int)cudaGetLastError();
  }
  if (kind != SSTTS_GRU_GENERIC) return (int)cudaErrorInvalidValue;
  const int smem = sstts_gru_bwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_generic, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  gru_bwd_generic<<<B, threads, smem, st>>>(dout, gates, hprev, wh, mask, dgx,
                                            dgh, T, H, reverse);
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
