// What one SM of the card charges for the pieces a recurrence kernel is
// built from: shared-memory float4 loads by address pattern, alone and
// before 96 multiply-adds a thread, a block barrier, and a thread-block
// cluster's barrier with a store into every member's shared memory.
//
// A stand-alone program (nvcc -o sm_microbench sm_microbench.cu), run by
// `python3 -m sstts_torch.tools.sm_microbench`.  32 blocks (or clusters) of
// 512 threads, one a SM, as the GRU kernels launch at B = 32; every time is
// from CUDA events over 20,000 iterations of the loop.

#include <cstdio>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kIters = 20000;

// PATTERN 0: all lanes of a warp read one address; 1: four addresses, one a
// lane of each group of four, the four 16 bytes apart in the banks; 2: the
// same four addresses on the same banks; 3: 32 addresses.  NL float4 loads
// an iteration; with FMA, 96 multiply-adds on them from 96 registers.
template <int PATTERN, int NL, bool FMA>
__global__ void __launch_bounds__(512, 1)
loads(const float* win, float* out, int iters) {
  __shared__ __align__(16) float s[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s[i] = 1e-3f * (i & 15);
  float w[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) w[i] = win[i * 512 + threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (PATTERN == 1) base = (lane & 3) * (4 * NL + 4);
  if (PATTERN == 2) base = (lane & 3) * (4 * NL);
  if (PATTERN == 3) base = lane * 4;
  float a0 = 0, a1 = 0, a2 = 0;
  for (int it = 0; it < iters; ++it) {
    const unsigned p = (unsigned)__cvta_generic_to_shared(s + base + ((it & 3) * 512));
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      float4 v;  // volatile: the loads stay in the loop
      asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(p + 16 * j));
      if (!FMA) {
        a0 += v.x;
      } else if (NL == 8) {  // each value serves three chains
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
          a0 = fmaf(x, w[4 * j + c], a0);
          a1 = fmaf(x, w[32 + 4 * j + c], a1);
          a2 = fmaf(x, w[64 + 4 * j + c], a2);
        }
      } else {  // each value serves one
        float& a = (j % 3 == 0) ? a0 : (j % 3 == 1) ? a1 : a2;
        a = fmaf(v.x, w[4 * j], a);
        a = fmaf(v.y, w[4 * j + 1], a);
        a = fmaf(v.z, w[4 * j + 2], a);
        a = fmaf(v.w, w[4 * j + 3], a);
      }
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1 + a2;
}

__global__ void __launch_bounds__(512, 1)
block_barrier(const float*, float* out, int iters) {
  __shared__ float h[2][128];
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (threadIdx.x < 128) h[(it + 1) & 1][threadIdx.x] = acc + it;
    __syncthreads();
    acc += h[(it + 1) & 1][(threadIdx.x * 7) & 127];
  }
  out[blockIdx.x * 512 + threadIdx.x] = acc;
}

// Each block of a cluster of C writes its 128 / C values into every
// member's buffer, then the cluster's barrier, then every thread reads.
template <int C>
__global__ void __launch_bounds__(512, 1)
cluster_barrier(const float*, float* out, int iters) {
  __shared__ float h[2][128];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  float acc = 0.f;
  cluster.sync();
  for (int it = 0; it < iters; ++it) {
    if (threadIdx.x < 128 / C) {
      const int u = (128 / C) * rank + threadIdx.x;
#pragma unroll
      for (int r = 0; r < C; ++r)
        cluster.map_shared_rank(&h[0][0], r)[((it + 1) & 1) * 128 + u] = acc + it;
    }
    cluster.sync();
    acc += h[(it + 1) & 1][(threadIdx.x * 7) & 127];
  }
  out[blockIdx.x * 512 + threadIdx.x] = acc;
}

template <class K>
void run(const char* name, K kernel, int cluster, const float* w, float* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(32 * cluster);
  cfg.blockDim = dim3(512);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, kernel, w, out, kIters);  // warm-up
  cudaEventRecord(a);
  cudaLaunchKernelEx(&cfg, kernel, w, out, kIters);
  cudaEventRecord(b);
  cudaDeviceSynchronize();
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("%s: %s\n", name, cudaGetErrorString(err));
    exit(1);
  }
  printf("%-52s %8.1f ns an iteration\n", name, ms * 1e6 / kIters);
}

int main() {
  float *w, *out;
  cudaMalloc(&w, 96 * 512 * 4);
  cudaMemset(w, 0, 96 * 512 * 4);
  cudaMalloc(&out, 128 * 512 * 4);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("SM clock at most %d MHz; 16 warps a SM\n", khz / 1000);
  run("8 float4 loads, one address a warp", loads<0, 8, false>, 1, w, out);
  run("8 float4 loads, four addresses, banks apart", loads<1, 8, false>, 1, w, out);
  run("8 float4 loads, four addresses, same banks", loads<2, 8, false>, 1, w, out);
  run("8 float4 loads, 32 addresses", loads<3, 8, false>, 1, w, out);
  run("24 float4 loads, one address a warp", loads<0, 24, false>, 1, w, out);
  run("24 float4 loads, four addresses, banks apart", loads<1, 24, false>, 1, w, out);
  run("8 float4 loads + 96 FMA, one address a warp", loads<0, 8, true>, 1, w, out);
  run("8 float4 loads + 96 FMA, four addresses, banks apart", loads<1, 8, true>, 1, w, out);
  run("8 float4 loads + 96 FMA, four addresses, same banks", loads<2, 8, true>, 1, w, out);
  run("24 float4 loads + 96 FMA, one address a warp", loads<0, 24, true>, 1, w, out);
  run("24 float4 loads + 96 FMA, four addresses, banks apart", loads<1, 24, true>, 1, w, out);
  run("24 float4 loads + 96 FMA, 32 addresses", loads<3, 24, true>, 1, w, out);
  run("block barrier + 128 shared stores", block_barrier, 1, w, out);
  run("cluster of 2: barrier + stores into both blocks", cluster_barrier<2>, 2, w, out);
  run("cluster of 4: barrier + stores into all four", cluster_barrier<4>, 4, w, out);
  return 0;
}
