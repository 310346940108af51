// K6: InstanceNorm (affine=False) with an optional ReLU or LeakyReLU(0.2),
// NHWC, f32 statistics for f32 and bf16 I/O. Replaces the Pallas TPU kernel
// ctagan_tpu/ops/pallas_kernels.py::instance_norm_pallas.
//
// The TPU kernel ran one launch whose sequential grid carried per-channel
// sums from the accumulate phase to the normalize phase in scratch memory.
// Blocks on the H100 run in no order, so the two phases are two launches on
// the caller's stream:
//   1. in_stats_kernel: each block reduces a tile of one sample's pixels to
//      per-channel f32 [sum, sum^2] and adds them into the zeroed (N, 2, C)
//      buffer with atomics;
//   2. in_norm_kernel: each block turns its sample's sums into (mean, rstd)
//      in shared memory, with the TPU kernel's unclamped one-pass variance
//      var = s2 / hw - mean^2, then normalizes, applies the activation and
//      stores in the input's dtype.
// What bounds it on the H100: bytes. It reads the activation twice and
// writes it once (~0.1 ms at the int8 forward's (2, 512, 512, 64) f32 at
// 3.35 TB/s) and does a few operations per element; a (2, 128, 128, 256) f32
// input fits the 50 MB L2, which serves the second read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "element.cuh"

namespace ctk {
namespace inorm {

constexpr int NT = 256;
constexpr int STATS_ELEMS = 32768;  // elements of one sample per stats block
constexpr int NORM_ELEMS = 8192;    // elements of one sample per norm block

// block (tile, sample): channel lane cl = tid % CL walks channels
// cl, cl + CL, ...; pixel lane pl = tid / CL walks the tile's pixels
template <typename T>
__global__ void __launch_bounds__(NT) in_stats_kernel(const T* x,
                                                      float* stats, int hw,
                                                      int c, int tile) {
  __shared__ float red[2][NT];
  const int CL = c < NT ? c : NT;
  const int PL = NT / CL;
  const int cl = threadIdx.x % CL, pl = threadIdx.x / CL;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int p1 = min(p0 + tile, hw);
  const T* xs = x + (long long)n * hw * c;
  for (int c0 = 0; c0 < c; c0 += CL) {
    const int ch = c0 + cl;
    float s = 0.f, s2 = 0.f;
    if (pl < PL && ch < c) {
      for (int q = p0 + pl; q < p1; q += PL) {
        const float v = to_f(xs[(long long)q * c + ch]);
        s += v;
        s2 += v * v;
      }
    }
    red[0][threadIdx.x] = s;
    red[1][threadIdx.x] = s2;
    __syncthreads();
    if (pl == 0 && ch < c) {
      float t = 0.f, t2 = 0.f;
      for (int k = 0; k < PL; ++k) {
        t += red[0][cl + k * CL];
        t2 += red[1][cl + k * CL];
      }
      atomicAdd(&stats[(n * 2 + 0) * c + ch], t);
      atomicAdd(&stats[(n * 2 + 1) * c + ch], t2);
    }
    __syncthreads();
  }
}

// act: 0 none, 1 relu, 2 leaky_relu(0.2); dynamic shared memory 2 C floats
template <typename T>
__global__ void __launch_bounds__(NT) in_norm_kernel(const T* x,
                                                     const float* stats,
                                                     T* out, int hw, int c,
                                                     int act, float eps) {
  extern __shared__ float mr[];  // [0, C): mean, [C, 2C): rstd
  const int n = blockIdx.y;
  const float count = static_cast<float>(hw);
  for (int ch = threadIdx.x; ch < c; ch += NT) {
    const float mean = __fdiv_rn(stats[(n * 2 + 0) * c + ch], count);
    const float var = __fsub_rn(__fdiv_rn(stats[(n * 2 + 1) * c + ch], count),
                                __fmul_rn(mean, mean));
    mr[ch] = mean;
    mr[c + ch] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  const int per = hw * c;
  const int e0 = blockIdx.x * NORM_ELEMS;
  const int e1 = min(e0 + NORM_ELEMS, per);
  const T* xs = x + (long long)n * per;
  T* os = out + (long long)n * per;
  for (int e = e0 + threadIdx.x; e < e1; e += NT) {
    const int ch = e % c;
    float v = __fmul_rn(__fsub_rn(to_f(xs[e]), mr[ch]), mr[c + ch]);
    if (act == 1) {
      v = fmaxf(v, 0.f);
    } else if (act == 2) {
      v = v >= 0.f ? v : __fmul_rn(0.2f, v);
    }
    os[e] = from_f<T>(v);
  }
}

template <typename T>
int run(const void* x, void* out, float* stats, int n, int hw, int c,
        int act, float eps, cudaStream_t s) {
  const int tile = STATS_ELEMS / c > 0 ? STATS_ELEMS / c : 1;
  dim3 g1((hw + tile - 1) / tile, n);
  in_stats_kernel<T><<<g1, NT, 0, s>>>(static_cast<const T*>(x), stats, hw,
                                       c, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 g2((hw * c + NORM_ELEMS - 1) / NORM_ELEMS, n);
  in_norm_kernel<T><<<g2, NT, 2 * c * sizeof(float), s>>>(
      static_cast<const T*>(x), stats, static_cast<T*>(out), hw, c, act, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace inorm
}  // namespace ctk

// stats: (N, 2, C) f32, zeroed by the caller; returns cudaGetLastError()
extern "C" int ctk_instance_norm(const void* x, void* out, void* stats, int n,
                                 int h, int wd, int c, int act, int bf16,
                                 float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (bf16) {
    return ctk::inorm::run<__nv_bfloat16>(x, out, st, n, h * wd, c, act, eps,
                                          s);
  }
  return ctk::inorm::run<float>(x, out, st, n, h * wd, c, act, eps, s);
}
