// K6: InstanceNorm (affine=False) with an optional ReLU or LeakyReLU(0.2),
// NHWC, f32 statistics for f32 and bf16 I/O. Replaces the Pallas TPU kernel
// ctagan_tpu/ops/pallas_kernels.py::instance_norm_pallas.
//
// What bounds it on the H100: bytes. It does a few operations per element,
// so the least it can take is one read of the activation and one write
// (0.080 ms at the int8 forward's (2, 512, 512, 64) f32, 3.35 TB/s).
//
// The work is cut into (sample, channel group) planes: a group is G
// channels of every pixel, G * sizeof(T) = 32-256 bytes, so each pixel's
// slice of a plane is whole 32-byte sectors. A thread owns one fixed slot
// of V channels (one 16-byte vector, or one element when C or x is not
// 16-byte aligned) and walks pixels, so no index is taken modulo C. Two
// routes, chosen per shape by ops/pallas_kernels.py::k6_plan:
//
//  1. one read (k6_cluster_kernel), where a plane fits a thread-block
//     cluster's shared memory (up to 16 blocks of 128 KB): each block of
//     the cluster loads its band of the plane's pixels into shared memory
//     with 16-byte loads and sums [sum, sum^2] while loading; the blocks
//     exchange their partials through distributed shared memory and each
//     adds them in rank order, so every block holds the same totals; each
//     block then normalizes its band from shared memory and stores it with
//     a streaming hint. The activation is read once.
//  2. two reads (k6_stats_kernel, k6_norm_kernel), where it does not (the
//     512^2 planes), in about two blocks per SM of 256-byte groups: the
//     blocks of a plane write their partials to a scratch buffer, and the
//     last block to arrive (an integer arrival counter after
//     __threadfence, reset by that block) adds them in a fixed order and
//     writes (mean, rstd); the second launch normalizes with 16-byte loads
//     and streaming stores.
//
// The statistics are summed in a fixed order (per-thread partials in pixel
// order, a tree over the warp's lanes, a tree over the block's warps, then
// the blocks in order): two calls on one input give the same bits, as the
// TPU kernel's sequential grid does. No float atomics, no memset. The
// variance is the TPU kernel's unclamped one-pass s2 / hw - mean^2.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "element.cuh"

namespace cg = cooperative_groups;

namespace ctk {
namespace inorm {

constexpr int CLUSTER_NT = 512;  // threads of a cluster block
constexpr int TWO_NT = 256;      // threads of a two-read block
constexpr int UNROLL = 8;        // loads in flight per thread
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_TWO_G = 128;   // channels of a two-read group: k6_plan's
                                 // 256 bytes of bf16

// V elements of T, 16 bytes when V > 1
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_nc(const T* p) {
  if constexpr (sizeof(T) * V == 16) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<Pack<T, V>*>(&u);
  } else {
    Pack<T, V> r;
    r.v[0] = __ldg(p);
    return r;
  }
}

// st.global.cs: the output is not read again by this kernel
template <typename T, int V>
__device__ __forceinline__ void store_cs(T* p, const Pack<T, V>& r) {
  if constexpr (sizeof(T) * V == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(&r);
    asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
                 : "memory");
  } else if constexpr (sizeof(T) == 4) {
    asm volatile("st.global.cs.b32 [%0], %1;" ::"l"(p),
                 "r"(__float_as_uint(to_f(r.v[0])))
                 : "memory");
  } else {
    const unsigned short b = *reinterpret_cast<const unsigned short*>(&r.v[0]);
    asm volatile("st.global.cs.b16 [%0], %1;" ::"l"(p), "h"(b) : "memory");
  }
}

// f(q, pack) for the thread's pixels q = r, r + R, .. < np in order, with
// UNROLL 16-byte (or element) loads in flight
template <typename T, int V, typename F>
__device__ __forceinline__ void walk(const T* xs, int c, int r, int R, int np,
                                     F f) {
  for (int q0 = r; q0 < np; q0 += R * UNROLL) {
    Pack<T, V> buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = q0 + u * R;
      if (q < np) buf[u] = load_nc<T, V>(xs + (long long)q * c);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (q0 + u * R < np) f(q0 + u * R, buf[u]);
    }
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v >= 0.f ? v : __fmul_rn(0.2f, v);
  return v;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> normalize(const Pack<T, V>& in,
                                                const float* mean,
                                                const float* rstd, int act) {
  Pack<T, V> o;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float v = __fmul_rn(__fsub_rn(to_f(in.v[e]), mean[e]), rstd[e]);
    o.v[e] = from_f<T>(activate(v, act));
  }
  return o;
}

template <typename T, int V>
__device__ __forceinline__ void accumulate(const Pack<T, V>& in, float* s,
                                           float* s2) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float v = to_f(in.v[e]);
    s[e] = __fadd_rn(s[e], v);
    s2[e] = __fadd_rn(s2[e], __fmul_rn(v, v));
  }
}

// The block's [sum, sum^2] of its G channels into red[0 .. 2G): per-thread
// partials (slot s = tid % S, row tid / S), then a tree over the rows of a
// warp (shuffles at offsets 16, 8, .., S), then a tree over the warps
// (halving). red holds (blockDim / 32) * 2G floats. Ends synchronized.
template <int V>
__device__ void block_sums(float* s, float* s2, float* red, int S, int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int off = 16; off >= S; off >>= 1) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s[e] = __fadd_rn(s[e], __shfl_down_sync(0xffffffffu, s[e], off));
      s2[e] = __fadd_rn(s2[e], __shfl_down_sync(0xffffffffu, s2[e], off));
    }
  }
  if (lane < S) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[warp * 2 * G + lane * V + e] = s[e];
      red[warp * 2 * G + G + lane * V + e] = s2[e];
    }
  }
  __syncthreads();
  for (int h = nw >> 1; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h * 2 * G; i += blockDim.x) {
      red[i] = __fadd_rn(red[i], red[i + h * 2 * G]);
    }
    __syncthreads();
  }
}

// mean and rstd from the totals, the TPU kernel's unclamped variance
__device__ __forceinline__ void finish(float s, float s2, float count,
                                      float eps, float* mean, float* rstd) {
  const float m = __fdiv_rn(s, count);
  const float var = __fsub_rn(__fdiv_rn(s2, count), __fmul_rn(m, m));
  *mean = m;
  *rstd = rsqrtf(__fadd_rn(var, eps));
}

// Route 1. grid (K, groups, N), cluster (K, 1, 1); block rank b holds
// pixels [b * band, min((b + 1) * band, hw)) of group blockIdx.y of sample
// blockIdx.z. Dynamic shared memory: the band [band][G] of T, then
// red [(CLUSTER_NT / 32) * 2G], part [2G], tot [2G], mr [2G] floats.
template <typename T, int V>
__global__ void __launch_bounds__(CLUSTER_NT) k6_cluster_kernel(
    const T* __restrict__ x, T* __restrict__ out, int hw, int c, int G,
    int band, int act, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = G / V, R = CLUSTER_NT / S;
  const int s = threadIdx.x % S, r = threadIdx.x / S;
  const int b = static_cast<int>(cluster.block_rank());
  const int K = static_cast<int>(cluster.num_blocks());
  const int ch = blockIdx.y * G + s * V;
  const bool live = ch < c;
  const int p0 = b * band;
  const int np = max(0, min(band, hw - p0));
  T* tile = reinterpret_cast<T*>(smem);
  const size_t tile_bytes = ((size_t)band * G * sizeof(T) + 15) & ~size_t(15);
  float* red = reinterpret_cast<float*>(smem + tile_bytes);
  float* part = red + (CLUSTER_NT / 32) * 2 * G;
  float* tot = part + 2 * G;
  float* mr = tot + 2 * G;
  const T* xs = x + ((long long)blockIdx.z * hw + p0) * c + ch;
  T* os = out + ((long long)blockIdx.z * hw + p0) * c + ch;

  float sum[V], sum2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sum[e] = sum2[e] = 0.f;
  if (live) {
    walk<T, V>(xs, c, r, R, np, [&](int q, const Pack<T, V>& in) {
      *reinterpret_cast<Pack<T, V>*>(tile + (size_t)q * G + s * V) = in;
      accumulate<T, V>(in, sum, sum2);
    });
  }
  block_sums<V>(sum, sum2, red, S, G);
  for (int i = threadIdx.x; i < 2 * G; i += CLUSTER_NT) part[i] = red[i];
  cluster.sync();  // every block's partials are in its shared memory
  for (int i = threadIdx.x; i < 2 * G; i += CLUSTER_NT) {
    float t = 0.f;
    for (int k = 0; k < K; ++k) {
      t = __fadd_rn(t, cluster.map_shared_rank(part, k)[i]);
    }
    tot[i] = t;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G; i += CLUSTER_NT) {
    finish(tot[i], tot[G + i], static_cast<float>(hw), eps, &mr[i],
           &mr[G + i]);
  }
  cluster.sync();  // no block leaves while another reads its partials
  if (!live) return;
  float mean[V], rstd[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mean[e] = mr[s * V + e];
    rstd[e] = mr[G + s * V + e];
  }
  for (int q = r; q < np; q += R) {
    const Pack<T, V> in =
        *reinterpret_cast<const Pack<T, V>*>(tile + (size_t)q * G + s * V);
    store_cs<T, V>(os + (long long)q * c,
                   normalize<T, V>(in, mean, rstd, act));
  }
}

// Route 2, pass 1. grid (chunks, groups, N); block (k, g, n) sums pixels
// [k * band, min((k + 1) * band, hw)) of group g of sample n, plane
// p = n * groups + g, into partials[(p * chunks + k) * 2G ..]; the last
// block of a plane to arrive adds the chunks' partials in a fixed order
// (part j of NT / 2G sums chunks j, j + parts, ..; then a tree over the
// parts) and writes norm[n][0][ch] = mean, norm[n][1][ch] = rstd.
template <typename T, int V>
__global__ void __launch_bounds__(TWO_NT) k6_stats_kernel(
    const T* __restrict__ x, float* partials, float* norm,
    unsigned int* counters, int hw, int c, int G, int band, int chunks,
    float eps) {
  __shared__ float red[(TWO_NT / 32) * 2 * MAX_TWO_G];
  __shared__ bool last;
  const int S = G / V, R = TWO_NT / S;
  const int s = threadIdx.x % S, r = threadIdx.x / S;
  const int k = blockIdx.x, g = blockIdx.y, n = blockIdx.z;
  const long long plane = (long long)n * gridDim.y + g;
  const int ch = g * G + s * V;
  const bool live = ch < c;
  const int p0 = k * band;
  const int np = max(0, min(band, hw - p0));
  const T* xs = x + ((long long)n * hw + p0) * c + ch;

  float sum[V], sum2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sum[e] = sum2[e] = 0.f;
  if (live) {
    walk<T, V>(xs, c, r, R, np, [&](int, const Pack<T, V>& in) {
      accumulate<T, V>(in, sum, sum2);
    });
  }
  block_sums<V>(sum, sum2, red, S, G);
  float* mine = partials + (plane * chunks + k) * 2 * G;
  for (int i = threadIdx.x; i < 2 * G; i += TWO_NT) mine[i] = red[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&counters[plane], 1u) ==
           static_cast<unsigned>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int U = 2 * G, parts = TWO_NT / U;
  const float* all = partials + plane * chunks * 2 * G;
  {
    const int u = threadIdx.x % U, j = threadIdx.x / U;
    float t = 0.f;
    if (j < parts) {
      for (int k0 = j; k0 < chunks; k0 += parts * UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int e = 0; e < UNROLL; ++e) {
          const int kk = k0 + e * parts;
          v[e] = kk < chunks ? __ldcg(all + (long long)kk * U + u) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < UNROLL; ++e) {
          if (k0 + e * parts < chunks) t = __fadd_rn(t, v[e]);
        }
      }
    }
    __syncthreads();  // red is reused
    if (j < parts) red[j * U + u] = t;
  }
  __syncthreads();
  for (int h = parts >> 1; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h * U; i += TWO_NT) {
      red[i] = __fadd_rn(red[i], red[i + h * U]);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G; i += TWO_NT) {
    const int cc = g * G + i;
    if (cc < c) {
      finish(red[i], red[G + i], static_cast<float>(hw), eps,
             &norm[(n * 2 + 0) * c + cc], &norm[(n * 2 + 1) * c + cc]);
    }
  }
  if (threadIdx.x == 0) counters[plane] = 0u;  // ready for the next call
}

// Route 2, pass 2: the same blocks normalize their pixels
template <typename T, int V>
__global__ void __launch_bounds__(TWO_NT) k6_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ norm,
    T* __restrict__ out, int hw, int c, int G, int band, int act) {
  const int S = G / V, R = TWO_NT / S;
  const int s = threadIdx.x % S, r = threadIdx.x / S;
  const int n = blockIdx.z;
  const int ch = blockIdx.y * G + s * V;
  if (ch >= c) return;
  const int p0 = blockIdx.x * band;
  const int np = max(0, min(band, hw - p0));
  const T* xs = x + ((long long)n * hw + p0) * c + ch;
  T* os = out + ((long long)n * hw + p0) * c + ch;
  float mean[V], rstd[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mean[e] = norm[(n * 2 + 0) * c + ch + e];
    rstd[e] = norm[(n * 2 + 1) * c + ch + e];
  }
  walk<T, V>(xs, c, r, R, np, [&](int q, const Pack<T, V>& in) {
    store_cs<T, V>(os + (long long)q * c,
                   normalize<T, V>(in, mean, rstd, act));
  });
}

size_t cluster_smem(int band, int G, int elem) {
  const size_t tile = ((size_t)band * G * elem + 15) & ~size_t(15);
  return tile + ((CLUSTER_NT / 32) * 2 * G + 3 * 2 * G) * sizeof(float);
}

template <typename T, int V>
cudaError_t cluster_config(int K, size_t smem, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  static size_t allowed = 0;  // the largest shared memory set so far
  if (smem > allowed) {
    auto kern = k6_cluster_kernel<T, V>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(CLUSTER_NT);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int V>
int run(const void* xv, void* outv, float* scratch, unsigned int* counters,
        int n, int hw, int c, int act, float eps, int cluster, int G,
        int band, int chunks, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int groups = (c + G - 1) / G;
  if (cluster > 0) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config<T, V>(
        cluster, cluster_smem(band, G, sizeof(T)), &cfg, &attr);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(cluster, groups, n);
    cfg.stream = st;
    err = cudaLaunchKernelEx(&cfg, k6_cluster_kernel<T, V>, x, out, hw, c, G,
                             band, act, eps);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  // scratch: norm (N, 2, C), then partials (N * groups, chunks, 2G)
  float* norm = scratch;
  float* partials = scratch + (size_t)n * 2 * c;
  const dim3 grid(chunks, groups, n);
  k6_stats_kernel<T, V><<<grid, TWO_NT, 0, st>>>(x, partials, norm, counters,
                                                 hw, c, G, band, chunks, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k6_norm_kernel<T, V><<<grid, TWO_NT, 0, st>>>(x, norm, out, hw, c, G, band,
                                                act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int max_clusters(int K, int G, int band, int* count) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T, V>(
      K, cluster_smem(band, G, sizeof(T)), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(K, 1, 1);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      count, k6_cluster_kernel<T, V>, &cfg));
}

}  // namespace inorm
}  // namespace ctk

// The plan (ops/pallas_kernels.py::k6_plan): vec V (1, or 16 bytes of T),
// group G channels, cluster K blocks of band pixels (route 1, K > 0), or
// chunks blocks of band pixels per plane (route 2, K == 0; scratch then
// holds N * 2C + N * groups * chunks * 2G floats, and counters N * groups
// zeros, which the kernel leaves zero). Returns cudaGetLastError().
extern "C" int ctk_instance_norm(const void* x, void* out, void* scratch,
                                 void* counters, int n, int h, int wd, int c,
                                 int act, int bf16, float eps, int vec,
                                 int group, int cluster, int band,
                                 int chunks, void* stream) {
  using ctk::inorm::run;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  const int hw = h * wd;
  if (cluster > ctk::inorm::MAX_CLUSTER ||
      (cluster == 0 && group > ctk::inorm::MAX_TWO_G)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto go = [&](auto fn) {
    return fn(x, out, sc, cnt, n, hw, c, act, eps, cluster, group, band,
              chunks, s);
  };
  if (bf16) {
    return vec > 1 ? go(run<__nv_bfloat16, 8>) : go(run<__nv_bfloat16, 1>);
  }
  return vec > 1 ? go(run<float, 4>) : go(run<float, 1>);
}

// cudaOccupancyMaxActiveClusters for route 1's kernel at a plan's cluster
// size, group and band: how many such clusters the card runs at once
extern "C" int ctk_instance_norm_clusters(int bf16, int vec, int group,
                                          int cluster, int band, int* count) {
  using ctk::inorm::max_clusters;
  auto go = [&](auto fn) { return fn(cluster, group, band, count); };
  if (bf16) {
    return vec > 1 ? go(max_clusters<__nv_bfloat16, 8>)
                   : go(max_clusters<__nv_bfloat16, 1>);
  }
  return vec > 1 ? go(max_clusters<float, 4>) : go(max_clusters<float, 1>);
}
