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
// to left while writing outputs in the original order.
//
// Bound on the H100: the recurrence is serial-latency-bound.  The post-CBHG
// call has T = 800 dependent steps per utterance; its arithmetic,
// 2*B*T*(D + H)*3H = 5.0 GFLOP at B=32, T=800, D=H=128, is negligible next
// to 800 rounds of a 128-deep dot product plus two block barriers each.
//
// Design: three kernels.
//  1. gru_input_proj: the input projection has no sequential dependence, so
//     it runs as one tiled f32 GEMM over all B*T rows (64x64 output tiles,
//     4x4 outputs per thread, operands staged through shared memory).
//  2. gru_recurrence: one block per utterance, one thread per gate column
//     (3H = 384 threads at H = 128).  Wh stays in dynamic shared memory in
//     f32 for the whole sequence (128*384*4 = 192 KB, under the 227 KB
//     opt-in), the carry h lives in shared memory, and the loop over T runs
//     inside the block, so no state round-trips device memory between steps.
//     Each step: thread c computes gh[c] = sum_k h[k] * Wh[k, c]; after a
//     barrier, threads 0..H-1 apply the gates and write h and the output.
//     When a gradient is wanted it also writes, per step, the gates r, z, n,
//     the recurrent candidate term hn and the carry before the step
//     (5H floats; 42 MB at B=32, T=515, H=128), so that the backward never
//     repeats the forward's serial chain.
//  3. gru_recurrence_bwd: the reverse-time recurrence of the gradient, one
//     block per utterance.  Wh is held transposed in shared memory, (3H, H),
//     so that dh_prev[k] = sum_c dgh[c] * Wh[k, c] reads consecutive
//     addresses across threads; the 3H-long sum is split over three groups
//     of H threads (128-long chains, as in the forward) that meet in shared
//     memory.  Per step, from the saved gates and the incoming carry
//     gradient, it writes the gate-preactivation gradients dgx (input side)
//     and dgh (recurrent side, dgx with the candidate's entry times r).
//     The carry gradient passes straight through masked steps.  The weight
//     gradients dWx = xs^T dgx, dWh = h_prev^T dgh, db = sum dgx and
//     dxs = dgx Wx^T are large independent products that the wrapper leaves
//     to cuBLAS, as the JAX package leaves them to XLA.  Bound: 2*3H*H
//     operations per step and utterance (1.6 GFLOP at B=32, T=515) and
//     ~100 MB of saved state and outputs, so ~0.03 ms; the 515 dependent
//     steps set the time.
//
// Plain C interface (bound with ctypes); the launch goes on the caller's
// stream, nothing synchronises, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kTileK = 16;

__global__ void __launch_bounds__(256)
gru_input_proj(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int M, int K, int N) {
  __shared__ float As[kTileK][kTile + 1];
  __shared__ float Bs[kTileK][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTile * kTileK; e += blockDim.x) {
      const int r = e / kTileK, kk = e % kTileK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * kTileK; e += blockDim.x) {
      const int kk = e / kTile, c = e % kTile;
      const int gk = k0 + kk, gn = n0 + c;
      Bs[kk][c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j] + bias[gn];
    }
  }
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

__global__ void gru_recurrence(const float* __restrict__ gx,
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
__global__ void gru_recurrence_bwd(const float* __restrict__ dout,
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

}  // namespace

extern "C" {

int sstts_gru_smem_bytes(int H) { return (H * 3 * H + H + 6 * H) * 4; }

int sstts_gru_bwd_smem_bytes(int H) { return (3 * H * H + 8 * H) * 4; }

// xs (B, T, D), wx (D, 3H), wh (H, 3H), b (3H), mask (B, T) or NULL, all
// f32 and contiguous; gx_scratch (B, T, 3H) f32; out (B, T, H) f32; gates
// (B, T, 4H) and hprev (B, T, H) f32, or both NULL when no gradient is
// wanted.
int sstts_gru_sequence(const float* xs, const float* wx, const float* wh,
                       const float* b, const float* mask, float* gx_scratch,
                       float* out, float* gates, float* hprev, int B, int T,
                       int D, int H, int reverse, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * T, N = 3 * H;
  dim3 pgrid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gru_input_proj<<<pgrid, 256, 0, st>>>(xs, wx, b, gx_scratch, M, D, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = sstts_gru_smem_bytes(H);
  err = cudaFuncSetAttribute(gru_recurrence,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  gru_recurrence<<<B, threads, smem, st>>>(gx_scratch, wh, mask, out, gates,
                                           hprev, T, H, reverse);
  return (int)cudaGetLastError();
}

// dout (B, T, H), gates (B, T, 4H), hprev (B, T, H) from the forward, wh
// (H, 3H), mask (B, T) or NULL, all f32 and contiguous; dgx and dgh
// (B, T, 3H) f32 outputs.
int sstts_gru_sequence_backward(const float* dout, const float* gates,
                                const float* hprev, const float* wh,
                                const float* mask, float* dgx, float* dgh,
                                int B, int T, int H, int reverse,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = sstts_gru_bwd_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_recurrence_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  gru_recurrence_bwd<<<B, threads, smem, st>>>(dout, gates, hprev, wh, mask,
                                               dgx, dgh, T, H, reverse);
  return (int)cudaGetLastError();
}

const char* sstts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
