// The tensor-core implicit-GEMM 3x3 conv body of K1, K4, K3 and K2, in
// four modes under four kernel names (fused_resblock.cu holds K1's and
// K4's C entries, fused_down.cu K3's, fused_convt.cu K2's; each file
// instantiates only its own kernels). K5 (fused_resblock_grad.cuh) builds
// beside K1 and K4, and the tensor-core helpers all five share are in
// wgmma.cuh.
//
// Reflect (K1, k1_wgmma_kernel): reflect-padded 3x3 conv + output [sum,
// sum^2], with the previous InstanceNorm (+ReLU) and the previous block's
// skip-add folded into the input read; replaces ctagan_tpu/ops/
// fused_resblock.py::conv3x3_reflect_stats (its pallas_call at :251). At
// the main path's N=2, 128^2 x 256 -> 256 it is 38.65 GFLOP over ~70 MB of
// operands (f32), far above the ops-per-byte ridge: 0.039 ms at the bf16
// dense peak (989 TFLOP/s) and 0.234 ms for the f32 route's three TF32
// products (495 TFLOP/s). Either route is bound by arithmetic, so every
// multiply-add runs on the tensor cores:
//
// - Implicit GEMM: M = the output pixels of one sample (a tile never
//   crosses samples, so the stats atomics go to one n), N = Cout, K = 9 C
//   walked in chunks of one tap and one 128-byte row of operands (64 bf16
//   or 32 f32 channels, four k16 or k8 steps), taps inner, so the nine
//   chunks of a channel block re-read the same input rows from L1.
// - A block is two warpgroups (256 threads) on a 128-pixel x BN-channel
//   tile; each warpgroup issues wgmma.m64n{BN} (operands from shared
//   memory, f32 accumulator in registers) on its 64 rows. bf16 takes
//   BN = 256 where Cout allows: a wide BN stages each activation once for
//   more products, and the staging, not the tensor cores, is what limits
//   it. f32 takes BN = 128, since it holds two accumulators (below).
// - A, the activations, is staged by the threads (a tensor copy has no
//   reflect pad and no norm prologue): each thread loads 16 bytes of the
//   tap's source pixel a chunk ahead, applies the prologue in f32 in JAX's
//   rounding order, converts to the MMA type and stores into the
//   128B-swizzled K-major layout that the wgmma descriptor names. The
//   chunk's wgmmas are issued between the rows of the next chunk's staging,
//   so the tensor cores run while the threads work.
// - B, the weight, is a K-major (Cout, 9C) copy in the MMA type that the
//   wrapper makes per call, brought in by cp.async into the same swizzled
//   layout two chunks ahead (three shared-memory stages).
// - f32 I/O is 3xTF32: each f32 operand is split into TF32 hi = rna(v) and
//   lo = rna(v - hi) (A here, the weight once per call by the wrapper), and
//   three products, small terms first, A_lo B_hi + A_hi B_lo + A_hi B_hi,
//   go into a chunk accumulator (A_lo B_lo is left out). The tensor cores
//   add into it with truncation, so each chunk's sum is added to a second,
//   register accumulator in f32 with rounding to nearest: ~2e-6 of the
//   output's scale, an f32 FMA loop's grade. One TF32 pass is ~3e-4 (over
//   the f32 tolerance), and split-bf16 products or one accumulator over all
//   of K (~1e-5) leave the generator's gradients through 18 InstanceNorms
//   over twice as far from float64 as the plain route's.
// - Epilogue: bias, round to the I/O dtype, through shared memory to
//   16-byte row stores, and [sum, sum^2] of the rounded values by columns,
//   one atomicAdd per column per block into the zeroed f32 (N, 2, Cout)
//   buffer.
//
// Zero (K4, k4_wgmma_kernel): the interior of the reflect conv's input
// gradient, a zero-halo 3x3 correlation of g (N, H, W, Cout_f) with the
// flipped, in/out-swapped kernel as B. A source pixel outside the image
// stages zeros (hi and lo); no prologue, bias, stats or emitted input, so
// the shared memory holds the stages alone.
//
// Stride2 (K3, k3_wgmma_kernel): the stride-2 3x3 conv with zero pad 1 in
// the post-norm domain, + output [sum, sum^2], with the previous
// InstanceNorm (+ReLU) folded into the input read. Output pixel (oy, ox) at
// tap (ky, kx) reads input pixel (2 oy + ky - 1, 2 ox + kx - 1) of the
// (H, W) input (H, W even), so M walks the (H/2, W/2) output grid while the
// gather reads the input's plane. A source pixel outside the image
// contributes 0 to the conv's input, not relu((0 - mean) rstd): load_a
// records which rows are inside, and stage_a writes zeros for the others
// after the prologue. Bias and stats as Reflect; no skip or emitted input.
// Its bf16 128-wide tiles run two blocks per SM (below).
//
// ConvT2x (K2, k2_wgmma_kernel): the ConvTranspose2d (k3, s2, p1, op1) in
// phase form, + output [sum, sum^2] over all four phases, with the
// previous InstanceNorm (+ReLU) folded into the input read; replaces
// ctagan_tpu/ops/fused_convt.py::convt2x_stats (its pallas_call at :183).
// blockIdx.z is the output phase (py, px): M walks the input grid (q, r)
// of one sample, whose pixel (q, r) becomes output pixel (2 q + py, 2 r +
// px) of the (N, 2H, 2W, Cout) output, and K is the phase's (1 + py)(1 +
// px) taps x C, taps inner: row phase 0 takes ky = 1 at input row q, row
// phase 1 ky = 0 at row q + 1 and ky = 2 at row q (columns alike), with
// no dilated buffer. B is K1's K-major weight of PyTorch's (C, Cout, 3, 3)
// kernel as it is (no flip), read at column (3 ky + kx) C + c. The row or
// column q + 1 past the bottom or right edge is the output padding's zero
// in the post-norm domain, staged as Stride2's halo is. Each row is stored
// at its own output pixel, and the four phases' blocks add their column
// sums into one stats buffer. Up2's Cout = 64 takes 64-channel tiles, on
// which a block pairs the two column phases of its row phase (blockIdx.z
// = py) in one 128-column MMA tile: column shift 0 (input column r) feeds
// px = 0 at kx = 1 and px = 1 at kx = 2 with one 128-wide wgmma, shift 1
// (column r + 1) px = 1 at kx = 0 alone with a 64-wide one on the
// accumulator's upper half; the tile's row is then output pixels (2 q +
// py, 2 r) and (2 q + py, 2 r + 1). So each staged A row feeds 128
// columns' products, as at up1 (plain 64-wide tiles fed half as many: the
// kernel alone at up2 took 0.80 ms f32 and 0.24 bf16 on an H100, paired
// 0.65 and 0.19).
//
// Limits (the wrappers raise for anything else): C % 64 == 0 (K per tap),
// Cout % 128 == 0 (ConvT2x: % 64), C <= 2048 where the norm is staged,
// 16-byte aligned tensors; any N H W (the ragged tile masked), with H, W
// >= 2 (Reflect) or even (Stride2).
#pragma once

#include <cstdint>
#include <type_traits>

#include "element.cuh"
#include "wgmma.cuh"

namespace ctk {
namespace k1 {

constexpr int BM = 128;               // pixels per block, 64 per warpgroup
constexpr int NT = 256;               // two warpgroups
constexpr int A_BYTES = BM * ROW;     // one A tile
constexpr int EPAD = 8;               // epilogue tile row padding, elements
constexpr int STAGES = 3;             // A and B tiles in shared memory

// Reflect: K1 (reflect pad, norm/ReLU/skip prologue, bias, stats, emitted
// input). Zero: K4 (zero halo, none of these). Stride2: K3 (stride 2, zero
// halo after the norm/ReLU prologue, bias, stats). ConvT2x: K2 (the
// transposed conv's phases, Stride2's halo, prologue, bias and stats)
enum class Mode { Reflect, Zero, Stride2, ConvT2x };

struct Params {
  const void* x;      // (N, H, W, C) input, T
  const void* skip;   // (N, H, W, C) residual stream, T, or null
  const void* whi;    // (Cout, 9C) weight, bf16 (bf16 I/O) or TF32 hi (f32)
  const void* wlo;    // (Cout, 9C) TF32 lo (f32 I/O), or null
  const float* b;     // (Cout,) bias
  const float* norm;  // (N, 2, C) [mean, rstd], or null
  void* out;          // (N, H, W, Cout) (Stride2 (N, H/2, W/2, Cout),
                      // ConvT2x (N, 2H, 2W, Cout)), T
  float* stats;       // (N, 2, Cout) [sum, sum^2], zeroed by the caller
  void* xnew;         // (N, H, W, C) emitted conv input, T, or null
  int n, h, w, c, cout, relu;
};

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T, int BN>
struct Tiles {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static constexpr int kParts = kTf32 ? 2 : 1;  // hi [, lo]
  static constexpr int kVals = 16 / sizeof(T);  // values per 16 bytes
  static constexpr int kChunk = ROW / sizeof(T);  // channels per K chunk
  static constexpr int kBBytes = BN * ROW;
  static constexpr int kStage = kParts * (A_BYTES + kBBytes);
  // stage s: A hi [, A lo], B hi [, B lo]
  static __device__ __forceinline__ uint32_t a(int s, int part) {
    return s * kStage + part * A_BYTES;
  }
  static __device__ __forceinline__ uint32_t b(int s, int part) {
    return s * kStage + kParts * A_BYTES + part * kBBytes;
  }
  // the epilogue's (BM, BN + EPAD) output tile reuses the stages
  static_assert(BM * (BN + EPAD) * sizeof(T) <= STAGES * kStage, "tile");
  // + 1024 for the alignment; Reflect and Stride2 add the (2, C) norm and
  // the epilogue's column sums
  static size_t smem_bytes(Mode m, int c) {
    return 1024 + STAGES * kStage +
           (m != Mode::Zero ? (2 * static_cast<size_t>(c) + 2 * NT) * 4
                            : 0);
  }
};

// the MMA tile's width: BN, or 128 where ConvT2x pairs the two column
// phases of a 64-channel tile (below)
template <Mode M, int BN>
__host__ __device__ constexpr int mma_width() {
  return M == Mode::ConvT2x && BN == 64 ? 128 : BN;
}

template <Mode M, typename T, int BN>
__device__ __forceinline__ void conv_body(const Params& p) {
  // BN output channels per block; NW MMA columns
  constexpr int NW = mma_width<M, BN>();
  using L = Tiles<T, NW>;
  constexpr bool kTf32 = L::kTf32;
  constexpr bool kK1 = M == Mode::Reflect;
  constexpr bool kS2 = M == Mode::Stride2;
  constexpr bool kT2 = M == Mode::ConvT2x;
  // ConvT2x on 64-channel tiles (up2's Cout = 64) pairs the two column
  // phases of one row phase in a 128-column MMA tile, columns 0-63 px = 0
  // and 64-127 px = 1 of the same channels, so each staged A row feeds 128
  // products as at up1
  constexpr bool kPair = NW != BN;
  // Stride2 and ConvT2x stage 0 for a source pixel outside the image after
  // the prologue: their zero pad lies in the post-norm domain
  constexpr bool kMask = kS2 || kT2;
  constexpr bool kPro = M != Mode::Zero;  // norm prologue, bias, stats
  constexpr int kV = L::kVals, BK = L::kChunk;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 8 rows of 128 bytes: 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  float* s_norm = reinterpret_cast<float*>(smem + STAGES * L::kStage);
  float* s_red = s_norm + 2 * p.c;  // [row parts][sum, sum^2][NW]

  const int tid = threadIdx.x;
  const int H = p.h, W = p.w, C = p.c, Cout = p.cout;
  // the output grid: the input's, or half of it each way for Stride2;
  // ConvT2x walks the input grid, pixel (q, r) for output (2 q + py,
  // 2 r + px) of its block's phase
  const int Wo = kS2 ? W / 2 : W;
  const int P = (kS2 ? H / 2 : H) * Wo;
  const int tiles = (P + BM - 1) / BM;
  const int n = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * BM;
  const int n0 = blockIdx.y * BN;
  // ConvT2x's output phase (paired: the row phase, both column phases)
  const int phase = kT2 ? static_cast<int>(blockIdx.z) : 0;
  const int py = kPair ? phase : phase >> 1, px = phase & 1;
  const int K = 9 * C;
  // A chunks per channel block: 9 taps, ConvT2x's (1 + py)(1 + px), or
  // paired 2 (1 + py): each row tap at column shifts 0 and 1
  const int ntaps = kPair ? 2 * (1 + py) : kT2 ? (1 + py) * (1 + px) : 9;
  const int nchunks = ntaps * (C / BK);
  const size_t plane = static_cast<size_t>(H * W) * C;  // one sample of x

  const T* __restrict__ x = static_cast<const T*>(p.x) + n * plane;
  const T* __restrict__ skip = (kK1 && p.skip != nullptr)
                                   ? static_cast<const T*>(p.skip) + n * plane
                                   : nullptr;
  const T* __restrict__ whi = static_cast<const T*>(p.whi);
  const T* __restrict__ wlo = static_cast<const T*>(p.wlo);
  // the emitted input is written by the channel-tile-0 blocks only, at the
  // centre tap, where input pixel == output pixel: each element once
  T* __restrict__ xnew = (kK1 && p.xnew != nullptr && blockIdx.y == 0)
                             ? static_cast<T*>(p.xnew) + n * plane
                             : nullptr;
  const bool has_norm = kPro && p.norm != nullptr;
  const bool relu = p.relu != 0;

  if (has_norm) {
    for (int i = tid; i < 2 * C; i += NT) s_norm[i] = p.norm[n * 2 * C + i];
  }

  // staging role: 16-byte group g (channels kV g .. kV g + kV - 1 of a
  // chunk) of tile rows r0 + 32 i, for A (pixels) and B (output channels)
  const int g = tid & 7;
  const int r0 = tid >> 3;
  int oy[4], ox[4];
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    ok[i] = m < P;
    oy[i] = ok[i] ? m / Wo : 0;
    ox[i] = ok[i] ? m % Wo : 0;
  }

  // chunk kc: tap kc % ntaps of channel block kc / ntaps; tap9 is its
  // 3 ky + kx, the weight's K offset tap9 * C + c0. ConvT2x's phase taps:
  // row phase 0 ky = 1; row phase 1 ky = 0 (input row q + 1), then ky = 2
  // (row q); columns alike. Paired, chunk t is row tap t / 2 at column
  // shift t % 2, A's tap kx = 1 (column r; B's px = 1 rows take kx = 2
  // there) or kx = 0 (column r + 1; px = 1 alone)
  auto tap9 = [&](int kc) {
    if constexpr (kPair) {
      const int t = kc % ntaps;
      return 3 * (py ? 2 * (t >> 1) : 1) + ((t & 1) ? 0 : 1);
    } else if constexpr (kT2) {
      const int t = kc % ntaps;
      return 3 * (py ? 2 * (t >> px) : 1) + (px ? 2 * (t & 1) : 1);
    } else {
      return kc % 9;
    }
  };
  auto load_b = [&](int kc, int s) {
    const int tap = tap9(kc);
    const size_t k0 = tap * C + (kc / ntaps) * BK + kV * g;
#pragma unroll
    for (int i = 0; i < NW / 32; ++i) {
      const int r = r0 + 32 * i;
      size_t src = static_cast<size_t>(n0 + r) * K + k0;
      if constexpr (kPair) {  // B rows 64-127: px = 1's tap, same channels
        if (i >= 2) {
          src -= static_cast<size_t>(64) * K - (tap % 3 == 1 ? C : 0);
        } else if (tap % 3 == 0) {
          continue;  // column shift 1: no px = 0 rows
        }
      }
      cp_async16(sbase + L::b(s, 0) + swz(r, g), whi + src);
      if (kTf32) cp_async16(sbase + L::b(s, 1) + swz(r, g), wlo + src);
    }
  };

  // A of chunk kc, raw: each row's 16 bytes of x (and skip) in registers,
  // loaded a chunk before they are staged; Zero: zeros outside the image;
  // Stride2, ConvT2x: bit i of `inside` says whether row i's source pixel
  // is in the image, for stage_a to zero the others after the prologue
  uint4 xr[4], sr[4];
  unsigned inside = 0;
  auto load_a = [&](int kc) {
    const int tap = tap9(kc);
    const int ky = tap / 3, kx = tap % 3;
    const int c = (kc / ntaps) * BK + kV * g;
    if constexpr (kMask) inside = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ok[i]) {
        if constexpr (kK1) {
          const int iy = reflect1(oy[i] + ky - 1, H);
          const int ix = reflect1(ox[i] + kx - 1, W);
          const size_t off = (static_cast<size_t>(iy) * W + ix) * C + c;
          xr[i] = *reinterpret_cast<const uint4*>(x + off);
          if (skip != nullptr) {
            sr[i] = *reinterpret_cast<const uint4*>(skip + off);
          }
        } else if constexpr (kMask) {
          // ConvT2x: (q + [ky == 0], r + [kx == 0]), past the bottom or
          // right edge for the output padding
          const int iy = kS2 ? 2 * oy[i] + ky - 1 : oy[i] + (ky == 0);
          const int ix = kS2 ? 2 * ox[i] + kx - 1 : ox[i] + (kx == 0);
          if (static_cast<unsigned>(iy) < static_cast<unsigned>(H) &&
              static_cast<unsigned>(ix) < static_cast<unsigned>(W)) {
            xr[i] = *reinterpret_cast<const uint4*>(
                x + (static_cast<size_t>(iy) * W + ix) * C + c);
            inside |= 1u << i;
          }
        } else {
          const int iy = oy[i] + ky - 1, ix = ox[i] + kx - 1;
          xr[i] = make_uint4(0, 0, 0, 0);
          if (static_cast<unsigned>(iy) < static_cast<unsigned>(H) &&
              static_cast<unsigned>(ix) < static_cast<unsigned>(W)) {
            xr[i] = *reinterpret_cast<const uint4*>(
                x + (static_cast<size_t>(iy) * W + ix) * C + c);
          }
        }
      }
    }
  };

  // the prologue on the raw registers, then the MMA operands (hi [, lo])
  // into stage s; between(i) runs before row i (the caller's wgmmas go
  // there)
  auto stage_a = [&](int kc, int s, auto&& between) {
    const int tap = tap9(kc);
    const int c = (kc / ntaps) * BK + kV * g;
    float mean[kV], rstd[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      mean[j] = has_norm ? s_norm[c + j] : 0.f;
      rstd[j] = has_norm ? s_norm[C + c + j] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      between(i);
      uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
      // Stride2's and ConvT2x's halo stays zero in the post-norm domain
      if (kMask ? ((inside >> i) & 1u) != 0 : ok[i]) {
        float v[kV];
        unpack(xr[i], v);
        hi = xr[i];
        if (has_norm) {
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            const float t = (v[j] - mean[j]) * rstd[j];
            v[j] = relu ? fmaxf(t, 0.f) : t;
          }
          hi = pack(v);  // the cast to T (exact for f32), then the skip
          if (skip != nullptr) {
            float sv[kV];
            unpack(sr[i], sv);
            unpack(hi, v);
#pragma unroll
            for (int j = 0; j < kV; ++j) v[j] = sv[j] + v[j];
            hi = pack(v);
          }
        }
        if (xnew != nullptr && tap == 4) {
          *reinterpret_cast<uint4*>(
              xnew + (static_cast<size_t>(oy[i]) * W + ox[i]) * C + c) = hi;
        }
        if constexpr (kTf32) {  // hi = rna(v), lo = rna(v - hi)
          float h[kV], l[kV];
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            h[j] = tf32(v[j]);
            l[j] = tf32(v[j] - h[j]);
          }
          hi = pack(h);
          lo = pack(l);
        }
      }
      uint8_t* dst = smem + swz(r0 + 32 * i, g);
      *reinterpret_cast<uint4*>(dst + L::a(s, 0)) = hi;
      if (kTf32) *reinterpret_cast<uint4*>(dst + L::a(s, 1)) = lo;
    }
  };

  // f32 I/O: the tensor cores add into their f32 accumulator with
  // truncation, which over K = 9 C biases the sum by ~1e-5 of its scale;
  // so each chunk's products are summed apart (acc) and added to sum in
  // f32 with rounding to nearest, as an f32 FMA loop would
  float acc[NW / 2], sum[kTf32 ? NW / 2 : 1];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTf32 ? NW / 2 : 1); ++i) sum[i] = 0.f;

  // pipeline: in iteration kc the wgmmas of chunk kc (stage kc % 3) are
  // issued between the rows of chunk kc + 1's staging, B of chunk kc + 2 is
  // copied in, and A of chunk kc + 2 is loaded into the registers. Each
  // write goes to a stage whose last reader, chunk kc - 1 or kc - 2, has
  // been waited for before the barrier that ended the previous iteration.
  // ConvT2x may have one chunk (C = 64 bf16, phase 0); the other modes
  // have at least 9
  const bool second = !kT2 || nchunks > 1;
  __syncthreads();  // s_norm
  load_b(0, 0);
  cp_async_commit();
  if (second) load_b(1, 1);
  cp_async_commit();
  load_a(0);
  stage_a(0, 0, [](int) {});
  if (second) load_a(1);
  cp_async_wait<1>();  // B of chunk 0
  fence_async_smem();
  __syncthreads();

  const uint32_t wg_rows = (tid >> 7) * 64 * ROW;  // this warpgroup's A rows
  int s = 0;                                       // kc % 3
  for (int kc = 0; kc < nchunks; ++kc) {
    const uint32_t ahi = sbase + L::a(s, 0) + wg_rows;
    const uint32_t bhi = sbase + L::b(s, 0);
    // paired, column shift 1: px = 1's columns alone, the accumulator's
    // upper half by B's rows 64-127 (64-column wgmmas)
    const bool upper = kPair && ((kc % ntaps) & 1) != 0;
    auto mma = [&](int k) {  // k step k: 32 bytes along the rows
      if constexpr (kPair) {
        if (upper) {
          float(&up)[NW / 4] = *reinterpret_cast<float(*)[NW / 4]>(
              acc + NW / 4);
          const uint32_t bup = bhi + 64 * ROW;
          if constexpr (kTf32) {
            wgmma_tf32(up, desc(ahi + A_BYTES + 32 * k), desc(bup + 32 * k),
                       k > 0);
            wgmma_tf32(up, desc(ahi + 32 * k),
                       desc(bup + L::kBBytes + 32 * k));
            wgmma_tf32(up, desc(ahi + 32 * k), desc(bup + 32 * k));
          } else {
            wgmma_bf16(up, desc(ahi + 32 * k), desc(bup + 32 * k));
          }
          return;
        }
      }
      if constexpr (kTf32) {  // the chunk's sum starts from 0
        wgmma_tf32(acc, desc(ahi + A_BYTES + 32 * k), desc(bhi + 32 * k),
                   k > 0);
        wgmma_tf32(acc, desc(ahi + 32 * k), desc(bhi + L::kBBytes + 32 * k));
        wgmma_tf32(acc, desc(ahi + 32 * k), desc(bhi + 32 * k));
      } else {
        wgmma_bf16(acc, desc(ahi + 32 * k), desc(bhi + 32 * k));
      }
    };
    const int s1 = s == 2 ? 0 : s + 1;
    if (kc + 2 < nchunks) load_b(kc + 2, s1 == 2 ? 0 : s1 + 1);
    cp_async_commit();  // possibly empty: one group per iteration
    fence_acc(acc);
    wgmma_fence();
    if (kc + 1 < nchunks) {
      stage_a(kc + 1, s1, mma);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) mma(k);
    }
    wgmma_commit();
    fence_acc(acc);
    if (kc + 2 < nchunks) load_a(kc + 2);
    wgmma_wait_all();
    fence_acc(acc);
    if constexpr (kTf32) {  // an upper chunk leaves the lower half as it was
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) {
        if (!upper || i >= NW / 4) sum[i] += acc[i];
      }
    }
    cp_async_wait<1>();  // B of chunk kc + 1
    fence_async_smem();
    __syncthreads();
    s = s1;
  }
  cp_async_wait<0>();
  if constexpr (kTf32) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = sum[i];
  }

  // epilogue: thread (warp w, lane l) of the warpgroup holds rows
  // 16 w + l / 4 + {0, 8} and columns 8 j + 2 (l % 4) + {0, 1}; the rounded
  // tile goes through shared memory, to be stored in 16-byte row pieces and
  // (all modes but Zero) summed by columns. Paired, column col is channel
  // n0 + col % 64 of phase px = col / 64
  constexpr int LD = NW + EPAD;
  T* tile = reinterpret_cast<T*>(smem);
  {
    const int lane = tid & 31;
    const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const int ch = n0 + (kPair ? col % BN : col);
      float b0 = 0.f, b1 = 0.f;
      if constexpr (kPro) b0 = p.b[ch], b1 = p.b[ch + 1];
      store2(tile + row * LD + col, acc[4 * j] + b0, acc[4 * j + 1] + b1);
      store2(tile + (row + 8) * LD + col, acc[4 * j + 2] + b0,
             acc[4 * j + 3] + b1);
    }
  }
  __syncthreads();
  constexpr int kRowWords = NW / kV;
  constexpr int kHalfWords = BN / kV;  // paired: one phase's words
  T* out = static_cast<T*>(p.out) +
           static_cast<size_t>(n) * (kT2 ? 4 : 1) * P * Cout + n0;
  for (int idx = tid; idx < BM * kRowWords; idx += NT) {
    const int row = idx / kRowWords, wd = idx % kRowWords;
    const int m = m0 + row;
    if (m < P) {
      // the row's output pixel: m, or ConvT2x's (2 q + py, 2 r + px)
      size_t pix = m;
      int cw = wd;  // 16-byte word of the pixel's channels
      if constexpr (kT2) {
        const int q = m / W;
        const int pxw = kPair ? wd / kHalfWords : px;
        if constexpr (kPair) cw = wd % kHalfWords;
        pix = static_cast<size_t>(2 * q + py) * (2 * W) + 2 * (m - q * W) +
              pxw;
      }
      *reinterpret_cast<uint4*>(out + pix * Cout + cw * kV) =
          *reinterpret_cast<const uint4*>(tile + row * LD + wd * kV);
    }
  }
  if constexpr (kPro) {
    // column col over rows part * RP .. + RP, then the parts summed
    constexpr int kRowParts = NT / NW, RP = BM / kRowParts;
    {
      const int col = tid % NW, part = tid / NW;
      const int rows = min(RP, P - m0 - part * RP);
      float s0 = 0.f, q0 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float v = to_f(tile[(part * RP + r) * LD + col]);
        s0 += v;
        q0 += v * v;
      }
      s_red[(part * 2 + 0) * NW + col] = s0;
      s_red[(part * 2 + 1) * NW + col] = q0;
    }
    __syncthreads();
    for (int i = tid; i < 2 * NW; i += NT) {
      const int which = i / NW, col = i % NW;
      float t = 0.f;
#pragma unroll
      for (int part = 0; part < kRowParts; ++part) {
        t += s_red[(part * 2 + which) * NW + col];
      }
      atomicAdd(&p.stats[(n * 2 + which) * Cout + n0 +
                         (kPair ? col % BN : col)],
                t);
    }
  }
}

// each mode its own kernel name, so the SASS check and the profiler tell
// K1, K4, K3 and K2 apart
template <typename T, int BN>
__global__ void __launch_bounds__(NT, 1) k1_wgmma_kernel(Params p) {
  conv_body<Mode::Reflect, T, BN>(p);
}

template <typename T, int BN>
__global__ void __launch_bounds__(NT, 1) k4_wgmma_kernel(Params p) {
  conv_body<Mode::Zero, T, BN>(p);
}

// K3's K is short (9 to 36 chunks at the generator's C = 64, 128), so each
// block's fill and epilogue weigh more than in K1: bf16 128-wide tiles run
// two blocks per SM (registers capped at 128), one's loads and epilogue
// under the other's wgmmas (0.18 -> 0.12 ms at down1 on an H100)
template <typename T, int BN>
__global__ void __launch_bounds__(NT, (sizeof(T) == 2 && BN == 128) ? 2 : 1)
    k3_wgmma_kernel(Params p) {
  conv_body<Mode::Stride2, T, BN>(p);
}

// K2's K is shorter still (4 to 16 bf16 chunks at up1, by phase), so its
// bf16 tiles run two blocks per SM too (0.148 -> 0.100 ms at up1 on an
// H100; at up2 the paired tile then spills 4 bytes)
template <typename T, int BN>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1)
    k2_wgmma_kernel(Params p) {
  conv_body<Mode::ConvT2x, T, BN>(p);
}

template <Mode M, typename T, int BN>
int launch(const Params& p, cudaStream_t stream) {
  // only mode M's kernel is instantiated in the file that launches it
  auto* kernel = [] {
    if constexpr (M == Mode::Reflect) {
      return k1_wgmma_kernel<T, BN>;
    } else if constexpr (M == Mode::Zero) {
      return k4_wgmma_kernel<T, BN>;
    } else if constexpr (M == Mode::Stride2) {
      return k3_wgmma_kernel<T, BN>;
    } else {
      return k2_wgmma_kernel<T, BN>;
    }
  }();
  const size_t smem = Tiles<T, mma_width<M, BN>()>::smem_bytes(M, p.c);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // the grid M walks (ConvT2x: the input's, one output phase per z, or
  // paired one row phase)
  const int pixels = M == Mode::Stride2 ? (p.h / 2) * (p.w / 2) : p.h * p.w;
  const int tiles = (pixels + BM - 1) / BM;
  const int phases =
      M != Mode::ConvT2x ? 1 : (mma_width<M, BN>() != BN ? 2 : 4);
  dim3 grid(p.n * tiles, p.cout / BN, phases);
  kernel<<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16: 256-channel tiles where Cout allows; f32: 128, whose two
// accumulators fit in the registers. ConvT2x (Cout 128 at up1, 64 at up2):
// 128-channel tiles, or 64 with the column phases paired where Cout % 128
// != 0 (the other modes' wrappers take Cout % 128 == 0 only)
template <Mode M, typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if constexpr (M == Mode::ConvT2x) {
    return p.cout % 128 == 0 ? launch<M, T, 128>(p, stream)
                             : launch<M, T, 64>(p, stream);
  } else {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (p.cout % 256 == 0) return launch<M, T, 256>(p, stream);
    }
    return launch<M, T, 128>(p, stream);
  }
}

}  // namespace k1
}  // namespace ctk
