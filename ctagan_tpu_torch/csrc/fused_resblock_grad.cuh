// Backward kernels of the fused residual body (ops/fused_resblock_grad.py),
// compiled with K1 in fused_resblock.cu.
//
// K4 ctk_conv3x3_zero_corr replaces ops/fused_resblock_grad.py::
//   _corr3x3_zero (the Pallas kernel of conv3x3_input_grad): the interior of
//   dL/dx of a reflect-padded 3x3 conv, a zero-halo correlation of g with the
//   flipped, transposed kernel. It is conv_stats.cuh's implicit GEMM in its
//   ZERO_S1 mode (no bias, no stats); the wrapper adds the reflect folds.
//
// K5 ctk_conv3x3_weight_grad replaces ops/fused_resblock_grad.py::
//   conv3x3_weight_grad (_wgrad_kernel): dW[kh][kw][c][o] = sum over every
//   pixel (n, y, x) of f(x)[n, r(y + kh - 1), r(x + kw - 1), c] * g[n, y, x, o],
//   r the reflect map and f the optional prologue normalize (f32) -> ReLU ->
//   round to the I/O dtype -> add skip -> round, so relu(IN(h1)) is rebuilt
//   as tiles are staged and never stored. The TPU carried the sum across its
//   sequential grid; Hopper blocks run in any order, so the pixel axis is
//   split over grid.z and each block atomically adds its f32 (64 x 64)
//   partial into the zeroed dW, as K1 does with its stats.
//
// What bounds them on the H100: at the main path's (1, 128, 128, 256) x 256
// each is 19.3 GFLOP over ~33 MB of operands, far above the ops-per-byte
// ridge, so arithmetic bounds both. Like K1 they accumulate with f32 CUDA-core
// FMAs in a 4 x 4 register tile per thread (no tensor cores yet: the f32
// non-tensor peak is ~67 TFLOP/s, the bf16 tensor peak 989), so their speed
// is K1's: 13-20 TFLOP/s on an H100 80GB HBM3 at 700 W. wgmma and TMA are
// later work.
#pragma once

#include <algorithm>

#include "conv_stats.cuh"

namespace ctk {

constexpr int WM = 64;  // dW rows (input channels of one tap) per block
constexpr int WN = 64;  // dW columns (output channels) per block
constexpr int WK = 16;  // pixels per K chunk

struct WgradParams {
  const void* x;      // (N, H, W, C) conv input before the prologue, T
  const void* skip;   // (N, H, W, C) residual stream, T, or null
  const void* g;      // (N, H, W, Cout) output gradient, T
  const float* norm;  // (N, 2, C) [mean, rstd], f32, or null
  float* dw;          // (3, 3, C, Cout) f32, zeroed by the caller
  int n, h, w, c, cout, relu;
  int chunk;          // pixels per block along grid.z, a multiple of WK
};

template <typename T>
__global__ void __launch_bounds__(NT) wgrad_kernel(WgradParams p) {
  __shared__ float As[WK][WM + 4];
  __shared__ float Bs[WK][WN + 4];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ skip = static_cast<const T*>(p.skip);
  const T* __restrict__ g = static_cast<const T*>(p.g);
  const float* __restrict__ norm = p.norm;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // compute role: columns tx + 16 j
  const int ty = tid / 16;  // compute role: rows ty + 16 i
  const int H = p.h, W = p.w, C = p.c, Cout = p.cout;
  const int HW = H * W;
  const int ctiles = C / WM;
  const int tap = blockIdx.x / ctiles;
  const int ky = tap / 3, kx = tap % 3;
  const int c0 = (blockIdx.x % ctiles) * WM;
  const int o0 = blockIdx.y * WN;
  const int P = p.n * HW;
  const int q_begin = blockIdx.z * p.chunk;
  const int q_end = min(P, q_begin + p.chunk);

  // load role: channel lc (of x and of g) of the chunk's pixels lq + 4 i
  const int lc = tid % 64;
  const int lq = tid / 64;
  const int c = c0 + lc;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += WK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + lq + 4 * i;
      float a = 0.f, gv = 0.f;
      if (q < q_end) {
        const int nn = q / HW;
        const int rem = q - nn * HW;
        int iy = rem / W + ky - 1;
        int ix = rem % W + kx - 1;
        // reflect: -1 -> 1, H -> H - 2
        iy = iy < 0 ? -iy : (iy >= H ? 2 * H - 2 - iy : iy);
        ix = ix < 0 ? -ix : (ix >= W ? 2 * W - 2 - ix : ix);
        const long long off = ((long long)(nn * H + iy) * W + ix) * C + c;
        a = to_f(x[off]);
        if (norm != nullptr) {
          a = (a - norm[(nn * 2 + 0) * C + c]) * norm[(nn * 2 + 1) * C + c];
          if (p.relu) a = fmaxf(a, 0.f);
          a = round_to<T>(a);  // cast, then add the skip
          if (skip != nullptr) a = round_to<T>(to_f(skip[off]) + a);
        }
        gv = to_f(g[(long long)q * Cout + o0 + lc]);
      }
      As[lq + 4 * i][lc] = a;
      Bs[lq + 4 * i][lc] = gv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dw = p.dw + ((long long)tap * C + c0) * Cout + o0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      atomicAdd(&dw[(long long)(ty + 16 * i) * Cout + tx + 16 * j], acc[i][j]);
}

}  // namespace ctk

extern "C" int ctk_conv3x3_zero_corr(const void* g, const void* v, void* out,
                                     int n, int h, int wd, int c, int cout,
                                     int bf16, void* stream) {
  ctk::Params p{g, nullptr, v, nullptr, nullptr, out, nullptr, nullptr,
                n, h, wd, c, cout, h, wd, 0};
  return ctk::launch<ctk::ZERO_S1>(p, bf16, stream);
}

extern "C" int ctk_conv3x3_weight_grad(const void* x, const void* skip,
                                       const void* g, const void* norm,
                                       void* dw, int n, int h, int wd, int c,
                                       int cout, int relu, int bf16,
                                       void* stream) {
  ctk::WgradParams p{x, skip, g, static_cast<const float*>(norm),
                     static_cast<float*>(dw), n, h, wd, c, cout, relu, 0};
  const int pixels = n * h * wd;
  const int base = 9 * (c / ctk::WM) * (cout / ctk::WN);
  // ~8 blocks per SM of a 132-SM card, each with >= 256 pixels
  int splits = (1056 + base - 1) / base;
  splits = std::max(1, std::min(splits, (pixels + 255) / 256));
  int chunk = (pixels + splits - 1) / splits;
  chunk = (chunk + ctk::WK - 1) / ctk::WK * ctk::WK;
  p.chunk = chunk;
  dim3 grid(base / (cout / ctk::WN), cout / ctk::WN,
            (pixels + chunk - 1) / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    ctk::wgrad_kernel<__nv_bfloat16><<<grid, ctk::NT, 0, s>>>(p);
  } else {
    ctk::wgrad_kernel<float><<<grid, ctk::NT, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
