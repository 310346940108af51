// K2's implicit-GEMM core (CUDA-core FMAs), and the element helpers that
// K1, K3 and K4 (conv_wgmma.cuh) and K5 (fused_resblock_grad.cuh), on the
// tensor cores, also use.
//
// K2 is a 3x3 ConvTranspose (k3 s2 p1 op1) over an NHWC tensor that also
// emits the per-(sample, channel) [sum, sum^2] of its own dtype-rounded
// output, with the previous InstanceNorm's (mean, rstd) and ReLU folded into
// the input read (ops/fused_convt.py). Its mode, CONVT_S2, runs one output
// phase per blockIdx.z (1/2/2/4 taps; no dilated buffer); the mode stays a
// template argument so the kernel keeps its name, conv_stats_kernel<2, T>,
// which tools/profile_port.py reads.
//
// Block = one tile of BM output pixels of one sample x BN output channels.
// K = taps x C is walked in BK-channel chunks: the block stages a BK x BM
// input tile (boundary, norm and ReLU applied as it is loaded, f32) and a
// BK x BN weight tile in shared memory, and each of the 256 threads
// accumulates a 4x4 register tile in f32 (CUDA-core FMAs, no tensor
// cores). The epilogue adds the bias, rounds to the I/O dtype, stores,
// reduces sum/sum^2 of the rounded values over the tile's pixels and
// atomically adds them into the zeroed f32 (N, 2, Cout) stats buffer.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ctk {

enum Mode { CONVT_S2 = 2 };

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per K chunk
constexpr int NT = 256;  // threads per block (16 x 16, 4 x 4 outputs each)

struct Params {
  const void* x;       // (N, H, W, C) input, T
  const void* weight;  // (3, 3, C, Cout) weight, T
  const float* b;      // (Cout,) bias, f32
  const float* norm;   // (N, 2, C) [mean, rstd], f32, or null
  void* out;           // (N, Ho, Wo, Cout), T
  float* stats;        // (N, 2, Cout) [sum, sum^2], f32, zeroed by the caller
  int n, h, w, c, cout;
  int ho, wo;
  int relu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}
// reflect pad 1 of an index into [0, n): -1 -> 1, n -> n - 2 (K1)
__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

template <int MODE, typename T>
__global__ void __launch_bounds__(NT) conv_stats_kernel(Params p) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  __shared__ float red[2][NT / 16][BN];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.weight);
  T* __restrict__ out = static_cast<T*>(p.out);
  const float* __restrict__ norm = p.norm;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // compute role: columns tx + 16 j
  const int ty = tid / 16;  // compute role: rows ty + 16 i
  // pixel grid walked by the tiles: the input grid positions (q, r) of
  // output phase (py, px): output (2q+py, 2r+px)
  const int gw = p.w;
  const int P = p.h * gw;
  const int tiles = (P + BM - 1) / BM;
  const int n = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int py = blockIdx.z >> 1, px = blockIdx.z & 1;
  const int H = p.h, W = p.w, C = p.c, Cout = p.cout;

  // load role: channel lk of the tile's pixels lm + 16 i
  const int lk = tid % BK;
  const int lm = tid / BK;
  int gy[4], gx[4];
  bool gv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + lm + 16 * i;
    gv[i] = m < P;
    gy[i] = gv[i] ? m / gw : 0;
    gx[i] = gv[i] ? m % gw : 0;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // taps: the (1 + py) x (1 + px) taps of the phase. ConvTranspose row
  // taps: py = 0 -> ky 1 (input row q); py = 1 -> ky 0 (row q + 1) and ky 2
  // (row q). Same for columns.
  const int nty = 1 + py;
  const int ntx = 1 + px;
  for (int ti = 0; ti < nty; ++ti) {
    for (int tj = 0; tj < ntx; ++tj) {
      const int ky = py ? 2 * ti : 1;
      const int kx = px ? 2 * tj : 1;
      long long off[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int iy = gy[i] + (ky == 0 ? 1 : 0);
        const int ix = gx[i] + (kx == 0 ? 1 : 0);
        // past the bottom/right edge: the output-padding zero
        const bool ok = gv[i] && iy < H && ix < W;
        off[i] = ok ? ((long long)(n * H + iy) * W + ix) * C : -1;
      }
      const T* wt = w + (long long)(ky * 3 + kx) * C * Cout;
      for (int c0 = 0; c0 < C; c0 += BK) {
        const int c = c0 + lk;
        float mean = 0.f, rstd = 1.f;
        if (norm != nullptr) {
          mean = norm[(n * 2 + 0) * C + c];
          rstd = norm[(n * 2 + 1) * C + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = 0.f;  // zero pad lives in the post-norm domain
          if (off[i] >= 0) {
            v = to_f(x[off[i] + c]);
            if (norm != nullptr) {
              v = (v - mean) * rstd;
              if (p.relu) v = fmaxf(v, 0.f);
              v = round_to<T>(v);
            }
          }
          As[lk][lm + 16 * i] = v;
        }
        const int bk = tid / 16;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          Bs[bk][col] = to_f(wt[(long long)(c0 + bk) * Cout + n0 + col]);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          float a[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // epilogue: bias, round, store, stats of the stored values
  float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= P) continue;
    const int oy = 2 * (m / gw) + py, ox = 2 * (m % gw) + px;
    T* orow = out + ((long long)(n * p.ho + oy) * p.wo + ox) * Cout + n0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const T r = from_f<T>(acc[i][j] + p.b[n0 + col]);
      orow[col] = r;
      const float rf = to_f(r);
      s[j] += rf;
      s2[j] += rf * rf;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = s[j];
    red[1][ty][tx + 16 * j] = s2[j];
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int which = tid / BN, col = tid % BN;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < NT / 16; ++r) t += red[which][r][col];
    atomicAdd(&p.stats[(n * 2 + which) * Cout + n0 + col], t);
  }
}

template <int MODE>
int launch(Params p, int bf16, void* stream) {
  const int tiles = (p.h * p.w + BM - 1) / BM;
  dim3 grid(p.n * tiles, p.cout / BN, 4);  // one output phase per z
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    conv_stats_kernel<MODE, __nv_bfloat16><<<grid, NT, 0, s>>>(p);
  } else {
    conv_stats_kernel<MODE, float><<<grid, NT, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctk
