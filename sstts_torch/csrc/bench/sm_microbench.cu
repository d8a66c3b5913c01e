// What one SM of the card charges for the pieces a recurrence kernel is
// built from: shared-memory float4 loads by address pattern, alone and
// before 96 multiply-adds a thread, a block barrier, and a thread-block
// cluster's barrier with a store into every member's shared memory; and the
// rate at which one SM streams an L2-resident buffer through a ring of
// cp.async.bulk stages in shared memory (what kernel B4 reads its weights
// through).
//
// A stand-alone program (nvcc -o sm_microbench sm_microbench.cu), run by
// `python3 -m sstts_torch.tools.sm_microbench`.  32 blocks (or clusters) of
// 512 threads, one a SM, as the GRU kernels launch at B = 32; every time is
// from CUDA events over 20,000 iterations of the loop.  The stream probe
// runs 32, 64 or 128 blocks, one a SM (its shared memory admits no second),
// each reading B4's bytes a decoder step (3,362,816 at the default config:
// the cell's weights with rows padded to 16 bytes, and one utterance's keys
// and memory) ten times over, every block the same buffer.

#include <cstdio>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../sm90.cuh"

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

// One producer lane walks the buffer `passes` times in stages of at most
// `stage_bytes`, each filled by `copies` equal bulk copies: wait for the
// stage to be empty, expect its bytes, the copies.  16 consumer warps wait
// for each stage to be full (every lane, or with `poll_one` lane 0 and then
// the warp) and release it; with `read`, they first load every 16 bytes of
// it once (conflict-free).
constexpr int kStreamConsumers = 16;
constexpr int kStreamSmem = 200 * 1024;  // > half the SM: one block a SM

struct StreamCfg {
  int stages, stage_bytes, copies, read, poll_one, spin, one_arrival;
};

// Both sides' waits: try_wait (may suspend the thread), or with `spin`
// test_wait in a loop (never suspends).
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity, int spin) {
  if (!spin) return sm90::mbar_wait(bar, parity);
  const uint32_t addr = sm90::smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 27)) __trap();
  }
}

__global__ void __launch_bounds__(32 * (kStreamConsumers + 1), 1)
stream_ring(const unsigned char* buf, int bytes, int passes, StreamCfg cfg, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 16;
  unsigned char* ring = smem + 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stages = cfg.stages, stage_bytes = cfg.stage_bytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, cfg.one_arrival ? 1 : kStreamConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int per_pass = (bytes + stage_bytes - 1) / stage_bytes;
  const int n = per_pass * passes;
  if (warp == kStreamConsumers) {
    if (lane == 0) {
      for (int i = 0, c = 0; i < n; ++i, c = c + 1 == per_pass ? 0 : c + 1) {
        const int s = i % stages;
        if (i >= stages) ring_wait(empty + s, ((i / stages) - 1) & 1, cfg.spin);
        const int off = c * stage_bytes;
        const int len = min(stage_bytes, bytes - off);
        sm90::mbar_expect_tx(full + s, len);
        const int piece = (len / cfg.copies + 15) & ~15;
        for (int o = 0; o < len; o += piece)
          sm90::bulk_load(ring + s * stage_bytes + o, buf + off + o, min(piece, len - o),
                          full + s);
      }
    }
    return;
  }
  float acc = 0.f;
  for (int i = 0, c = 0; i < n; ++i, c = c + 1 == per_pass ? 0 : c + 1) {
    const int s = i % stages;
    if (cfg.one_arrival) {  // thread 0 waits and releases for all
      if (threadIdx.x == 0) ring_wait(full + s, (i / stages) & 1, cfg.spin);
      sm90::named_barrier(1, 32 * kStreamConsumers);
      if (cfg.read) {
        const int len = min(stage_bytes, bytes - c * stage_bytes);
        const float4* p = reinterpret_cast<const float4*>(ring + s * stage_bytes);
        for (int j = threadIdx.x; j < len / 16; j += 32 * kStreamConsumers) {
          const float4 v = p[j];
          acc += (v.x + v.y) + (v.z + v.w);
        }
      }
      sm90::named_barrier(1, 32 * kStreamConsumers);
      if (threadIdx.x == 0) sm90::mbar_arrive(empty + s);
      continue;
    }
    if (!cfg.poll_one || lane == 0) ring_wait(full + s, (i / stages) & 1, cfg.spin);
    __syncwarp();
    if (cfg.read) {
      const int len = min(stage_bytes, bytes - c * stage_bytes);
      const float4* p = reinterpret_cast<const float4*>(ring + s * stage_bytes);
      for (int j = threadIdx.x; j < len / 16; j += 32 * kStreamConsumers) {
        const float4 v = p[j];
        acc += (v.x + v.y) + (v.z + v.w);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + s);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// One thread alone: rounds of `stages` copies of `stage_bytes` on one
// barrier, waited for before the next round (no consumers, no ring).
__global__ void __launch_bounds__(32, 1)
stream_burst(const unsigned char* buf, int bytes, int passes, StreamCfg cfg, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + 256;
  if (threadIdx.x != 0) return;
  sm90::mbar_init(bar, 1);
  sm90::fence_barrier_init();
  uint32_t phase = 0;
  for (int p = 0; p < passes; ++p) {
    for (int off = 0; off < bytes;) {
      int total = 0;
      for (int s = 0; s < cfg.stages && off + total < bytes; ++s)
        total += min(cfg.stage_bytes, bytes - off - total);
      sm90::mbar_expect_tx(bar, total);
      for (int o = 0; o < total; o += cfg.stage_bytes)
        sm90::bulk_load(ring + o, buf + off + o, min(cfg.stage_bytes, total - o), bar);
      sm90::mbar_wait(bar, phase);
      phase ^= 1;
      off += total;
    }
  }
  out[blockIdx.x] = ring[0];
}

void stream(const char* what, int sms, StreamCfg cfg, bool burst, const unsigned char* buf,
            float* out) {
  constexpr int kBytes = 3362816, kPasses = 10;
  auto kernel = burst ? stream_burst : stream_ring;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStreamSmem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const dim3 grid(sms), block(burst ? 32 : 32 * (kStreamConsumers + 1));
  kernel<<<grid, block, kStreamSmem>>>(buf, kBytes, kPasses, cfg, out);  // into L2
  cudaEventRecord(a);
  constexpr int kReps = 5;
  for (int r = 0; r < kReps; ++r) kernel<<<grid, block, kStreamSmem>>>(buf, kBytes, kPasses, cfg, out);
  cudaEventRecord(b);
  cudaDeviceSynchronize();
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("stream: %s\n", cudaGetErrorString(err));
    exit(1);
  }
  const double s = ms * 1e-3 / kReps;
  printf("stream %3d SMs, %2d x %2d KB, %s %8.1f GB/s a SM, %8.1f us a step\n", sms,
         cfg.stages, cfg.stage_bytes / 1024, what, (double)kBytes * kPasses / s * 1e-9,
         s / kPasses * 1e6);
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

  unsigned char* buf;
  float* sout;
  cudaMalloc(&buf, 3362816);
  cudaMemset(buf, 1, 3362816);
  cudaMalloc(&sout, 128 * 32 * (kStreamConsumers + 1) * sizeof(float));
  // {stages, stage bytes, copies a stage, read, poll_one, spin, one_arrival}
  for (int sms : {32, 64, 128})
    for (int stages : {4, 6, 8})
      stream("ring              ", sms, {stages, 16384, 1, 0, 0, 0, 0}, false, buf, sout);
  for (int kb : {8, 16, 32, 64}) {
    const int stages = 128 / kb;
    stream("ring              ", 32, {stages, kb * 1024, 1, 0, 0, 0, 0}, false, buf, sout);
    stream("ring, read        ", 32, {stages, kb * 1024, 1, 1, 0, 0, 0}, false, buf, sout);
    stream("ring, lane 0 polls", 32, {stages, kb * 1024, 1, 0, 1, 0, 0}, false, buf, sout);
    stream("ring, spin        ", 32, {stages, kb * 1024, 1, 0, 0, 1, 0}, false, buf, sout);
    stream("ring, one arrival ", 32, {stages, kb * 1024, 1, 0, 0, 0, 1}, false, buf, sout);
    stream("burst, one thread ", 32, {stages, kb * 1024, 1, 0, 0, 0, 0}, true, buf, sout);
  }
  stream("ring, 4 copies    ", 32, {2, 65536, 4, 0, 0, 0, 0}, false, buf, sout);
  stream("ring, 8 copies    ", 32, {2, 65536, 8, 0, 0, 0, 0}, false, buf, sout);
  stream("ring              ", 32, {3, 65536, 1, 0, 0, 0, 0}, false, buf, sout);
  stream("ring, read        ", 32, {3, 65536, 1, 1, 0, 0, 0}, false, buf, sout);
  stream("ring              ", 32, {2, 98304, 1, 0, 0, 0, 0}, false, buf, sout);
  stream("ring              ", 128, {2, 65536, 1, 0, 0, 0, 0}, false, buf, sout);
  stream("burst, one thread ", 32, {12, 16384, 1, 0, 0, 0, 0}, true, buf, sout);
  stream("burst, one thread ", 32, {1, 196608, 1, 0, 0, 0, 0}, true, buf, sout);
  return 0;
}
