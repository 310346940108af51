// K7: reflect-padded 3x3 conv with int8 operands and int32 accumulation, a
// fused f32 dequant and the output's [sum, sum^2]. Replaces the Pallas TPU
// kernel ctagan_tpu/ops/fused_s8.py::conv3x3_reflect_s8 (the int8 serving
// path's residual body, 18 launches per generator forward).
//
// Two input modes, as the TPU kernel has them:
//   (i)  x int8, pre-quantized by the caller (the residual trunk);
//   (ii) x f32/bf16 raw conv output with (N, 2, C) [mean, rstd]: while the
//        input tile is staged the kernel computes
//        q = clamp(rint(max((x - mean) * rstd, 0) * qmul), 0, 127), so the
//        int8 image of relu(IN(x)) never exists in device memory.
// The epilogue is out = float(acc) * scale[o] + b[o] with the combined scale
// (w_scale * act_scale) computed by the caller, rounded once per operation
// (no FMA contraction), then rounded to the output dtype; the stats are of
// the rounded values and are added into the zeroed (N, 2, Cout) buffer with
// atomics.
//
// What bounds it on the H100: operations. At the body's (N, 128, 128, 256)
// -> 256, K = 9 * 256, each sample is ~19.3 G int8 multiply-adds x 2 against
// 1,979 TOPS on the int8 tensor cores, with ~17 MB moved per sample. This
// first version walks the pixels and taps of a reflect-padded 3x3 conv
// with int8 tiles in shared memory, four channels packed per 32-bit word
// (the weight's words transposed from its HWIO bytes while they are staged),
// and accumulates with __dp4a on the CUDA cores (no tensor cores): the int32
// sums are exact, whatever the order. mma.sync s8 or wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "element.cuh"

namespace ctk {
namespace s8 {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BKW = 16;  // packed 4-channel words per K chunk (64 channels)
constexpr int NT = 256;  // threads per block (16 x 16, 4 x 4 outputs each)

struct Params {
  const void* x;        // (N, H, W, C): int8 (mode i) or InT raw (mode ii)
  const int8_t* wq;     // (3, 3, C, Cout) HWIO, as quantize_generator has it
  const float* scale;   // (Cout,) combined dequant scale
  const float* b;       // (Cout,) bias
  const float* norm;    // (N, 2, C) [mean, rstd] (mode ii), else null
  void* out;            // (N, H, W, Cout), OutT
  float* stats;         // (N, 2, Cout) [sum, sum^2], zeroed by the caller
  int n, h, w, c, cout;
  float qmul;           // 127 / act_clip (mode ii)
};

// the four channels c..c+3 of one pixel of a raw input, normalized, ReLU'd
// and quantized to [0, 127], packed little-endian into one word
template <typename InT>
__device__ __forceinline__ int quantize4(const InT* src, const float* mean,
                                         const float* rstd, float qmul) {
  int v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f = __fmul_rn(__fsub_rn(to_f(src[j]), mean[j]), rstd[j]);
    f = rintf(__fmul_rn(fmaxf(f, 0.f), qmul));  // half to even
    f = fminf(fmaxf(f, 0.f), 127.f);
    v |= (static_cast<int>(f) & 0xff) << (8 * j);
  }
  return v;
}

// InT: int8_t (mode i), float or __nv_bfloat16 (mode ii); OutT: float or bf16
template <typename InT, typename OutT>
__global__ void __launch_bounds__(NT) conv_s8_kernel(Params p) {
  constexpr bool kPrenorm = !std::is_same<InT, int8_t>::value;
  __shared__ int As[BKW][BM + 4];
  __shared__ __align__(16) int Bs[BKW][BN];
  __shared__ float red[2][NT / 16][BN];

  const InT* __restrict__ x = static_cast<const InT*>(p.x);
  const int8_t* __restrict__ wq = p.wq;
  OutT* __restrict__ out = static_cast<OutT*>(p.out);

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // compute role: columns tx + 16 j
  const int ty = tid / 16;  // compute role: rows ty + 16 i
  const int H = p.h, W = p.w, C = p.c, Cout = p.cout;
  const int CW = C / 4;
  const int P = H * W;
  const int tiles = (P + BM - 1) / BM;
  const int n = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * BM;
  const int n0 = blockIdx.y * BN;

  // load role: word lk of the chunk (channels 4 lk..4 lk + 3) of the tile's
  // pixels lm + 16 i
  const int lk = tid % BKW;
  const int lm = tid / BKW;
  int gy[4], gx[4];
  bool gv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + lm + 16 * i;
    gv[i] = m < P;
    gy[i] = gv[i] ? m / W : 0;
    gx[i] = gv[i] ? m % W : 0;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      long long off[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int iy = reflect1(gy[i] + ky - 1, H);
        const int ix = reflect1(gx[i] + kx - 1, W);
        off[i] = gv[i] ? ((long long)(n * H + iy) * W + ix) * C : -1;
      }
      const int8_t* wt = wq + (long long)(ky * 3 + kx) * C * Cout;
      for (int w0 = 0; w0 < CW; w0 += BKW) {
        const int c = 4 * (w0 + lk);
        float mean[4], rstd[4];
        if constexpr (kPrenorm) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mean[j] = p.norm[(n * 2 + 0) * C + c + j];
            rstd[j] = p.norm[(n * 2 + 1) * C + c + j];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int v = 0;
          if (off[i] >= 0) {
            if constexpr (kPrenorm) {
              v = quantize4(x + off[i] + c, mean, rstd, p.qmul);
            } else {
              v = *reinterpret_cast<const int*>(x + off[i] + c);
            }
          }
          As[lk][lm + 16 * i] = v;
        }
        {  // weight words: thread (bk, cq) reads channels 4 (w0 + bk) + j,
           // j < 4, at the 4 output channels n0 + 4 cq .. + 3 (one int per
           // row), transposes the 4 x 4 bytes, and stores the 4 packed words
          const int bk = tid / 16, cq = tid % 16;
          const int8_t* src = wt + (long long)(4 * (w0 + bk)) * Cout + n0 + 4 * cq;
          int r[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            r[j] = *reinterpret_cast<const int*>(src + (long long)j * Cout);
          const int t0 = __byte_perm(r[0], r[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
          const int t1 = __byte_perm(r[0], r[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
          const int t2 = __byte_perm(r[2], r[3], 0x5140);
          const int t3 = __byte_perm(r[2], r[3], 0x7362);
          *reinterpret_cast<int4*>(&Bs[bk][4 * cq]) =
              make_int4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                        __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BKW; ++k) {
          int a[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // epilogue: dequant (one rounding per operation), round, store, stats
  float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  float sc[4], bb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = p.scale[n0 + tx + 16 * j];
    bb[j] = p.b[n0 + tx + 16 * j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= P) continue;
    OutT* orow = out + ((long long)n * P + m) * Cout + n0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v =
          __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), sc[j]), bb[j]);
      const OutT r = from_f<OutT>(v);
      orow[tx + 16 * j] = r;
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

template <typename InT>
void launch_in(const Params& p, int out_bf16, dim3 grid, cudaStream_t s) {
  if (out_bf16) {
    conv_s8_kernel<InT, __nv_bfloat16><<<grid, NT, 0, s>>>(p);
  } else {
    conv_s8_kernel<InT, float><<<grid, NT, 0, s>>>(p);
  }
}

}  // namespace s8
}  // namespace ctk

// in_kind: 0 int8 (mode i), 1 f32 raw, 2 bf16 raw (mode ii)
extern "C" int ctk_conv3x3_reflect_s8(
    const void* x, const void* w, const void* scale, const void* b,
    const void* norm, void* out, void* stats, int n, int h, int wd, int c,
    int cout, int in_kind, int out_bf16, float qmul, void* stream) {
  using namespace ctk::s8;
  Params p{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
           static_cast<const float*>(b), static_cast<const float*>(norm), out,
           static_cast<float*>(stats), n, h, wd, c, cout, qmul};
  const int tiles = (h * wd + BM - 1) / BM;
  dim3 grid(n * tiles, cout / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == 0) {
    launch_in<int8_t>(p, out_bf16, grid, s);
  } else if (in_kind == 1) {
    launch_in<float>(p, out_bf16, grid, s);
  } else {
    launch_in<__nv_bfloat16>(p, out_bf16, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}
