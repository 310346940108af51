// Backward kernels of the fused residual body (ops/fused_resblock_grad.py),
// compiled with K1 in fused_resblock.cu.
//
// K4 ctk_conv3x3_zero_corr replaces ops/fused_resblock_grad.py::
//   _corr3x3_zero (the Pallas kernel of conv3x3_input_grad): the interior of
//   dL/dx of a reflect-padded 3x3 conv, a zero-halo correlation of g with the
//   flipped, transposed kernel. It is K1's tensor-core implicit GEMM in its
//   Zero mode (conv_wgmma.cuh, k4_wgmma_kernel: wgmma, 3xTF32 with
//   per-chunk f32 sums for f32; a zero halo, no prologue, bias or stats);
//   the wrapper adds the reflect folds.
//
// K5 ctk_conv3x3_weight_grad replaces ops/fused_resblock_grad.py::
//   conv3x3_weight_grad (_wgrad_kernel): dW[kh][kw][c][o] = sum over every
//   pixel (n, y, x) of f(x)[n, r(y + kh - 1), r(x + kw - 1), c] * g[n, y, x, o],
//   r the reflect map and f the optional prologue normalize (f32) -> ReLU ->
//   round to the I/O dtype -> add skip -> round, so relu(IN(h1)) is rebuilt
//   as tiles are staged and never stored.
//
// What bounds K5 on the H100: at the main path's (1, 128, 128, 256) x 256 it
// is 19.33 GFLOP over ~36 MB of operands (f32), far above the ops-per-byte
// ridge: 0.020 ms at the bf16 dense peak (989 TFLOP/s) and 0.117 ms for the
// f32 route's three TF32 products (495 TFLOP/s). So every multiply-add runs
// on the tensor cores (wgmma, the helpers of wgmma.cuh that K1 uses):
//
// - GEMM: M = the C input channels of one tap (128 a block, 64 a
//   warpgroup), N = Cout (128, or 256 for bf16 where Cout allows), K = the
//   pixels, walked in chunks of one 128-byte operand row (32 f32 or 64 bf16
//   pixels). The contraction axis is strided in NHWC, and TF32 wgmma takes
//   only K-major operands, so:
// - B, g, is a K-major (Cout, N * hwp) copy that the wrapper makes per call
//   (bf16, or the TF32 hi/lo split for f32), each sample's H W pixels
//   zero-padded to hwp, a multiple of 64, so a chunk never spans two samples
//   (one norm row per chunk) and the ragged tail multiplies zeros; cp.async
//   brings it into the 128B swizzle two chunks ahead, as K1 brings its
//   weight.
// - A, the activations, is staged transposed by the threads: each thread
//   loads 4 channels (16 bytes f32, 8 bf16) of each of its 4 (f32) or 8
//   (bf16) consecutive pixels of the tap's reflect-shifted source, a chunk
//   ahead, applies the prologue in f32 in JAX's rounding order, and stores
//   one 16-byte group (those pixels) into each of 4 channel rows. The 8
//   lanes of one store phase write 8 distinct 16-byte groups of the swizzle
//   (bf16: one row's 8; f32: 4 each of two rows 4 apart): no bank
//   conflict. Each chunk's wgmmas are issued together, then run while the
//   threads stage the next chunk; the pixel coordinates advance a chunk at
//   a time (no division in the loop but at a sample's end).
// - f32 I/O is 3xTF32 as in K1: hi = rna(v), lo = rna(v - hi) for both
//   operands, A_lo B_hi + A_hi B_lo + A_hi B_hi per chunk into an
//   accumulator that starts from 0 (scale-d 0), added to a second register
//   accumulator in f32 with rounding to nearest: the tensor cores' own
//   accumulator truncates, and over K = 16,384 pixels that bias would pass
//   the f32 tolerance.
// - The TPU carried the sum across its sequential grid; Hopper blocks run in
//   any order, so the pixel axis is split over grid.z (the wrapper picks the
//   split that fills the SMs in the fewest waves) and each block adds its
//   f32 partial into the zeroed dW, two columns per atomicAdd.
//
// Limits (the wrapper raises for anything else): C % 128 == 0, Cout % 128 ==
// 0, H, W >= 2, H W C < 2^31, 16-byte aligned x, skip and norm; any N.
#pragma once

#include <cstdint>
#include <type_traits>

#include "element.cuh"
#include "wgmma.cuh"

namespace ctk {
namespace k5 {

constexpr int BM = 128;            // dW rows per block: channels of one tap
constexpr int NT = 256;            // two warpgroups, 64 rows each
constexpr int A_BYTES = BM * ROW;  // one A tile
constexpr int STAGES = 3;          // A and B tiles in shared memory

struct Params {
  const void* x;      // (N, H, W, C) conv input before the prologue, T
  const void* skip;   // (N, H, W, C) residual stream, T, or null
  const void* ghi;    // (Cout, N hwp) K-major g: bf16, or TF32 hi (f32 I/O)
  const void* glo;    // (Cout, N hwp) TF32 lo (f32 I/O), or null
  const float* norm;  // (N, 2, C) [mean, rstd], or null
  float* dw;          // (3, 3, C, Cout) f32, zeroed by the caller
  int n, h, w, c, cout, relu;
  int hwp;            // a sample's pixels in g's copy: H W rounded up to 64
  int per;            // K chunks per block along grid.z
};

template <typename T, int BN>
struct Tiles {
  static constexpr bool kTf32 = std::is_same<T, float>::value;
  static constexpr int kParts = kTf32 ? 2 : 1;       // hi [, lo]
  static constexpr int kChunk = ROW / sizeof(T);     // pixels per K chunk
  static constexpr int kPx = kChunk / 8;             // pixels per thread
  static constexpr int kBBytes = BN * ROW;
  static constexpr int kStage = kParts * (A_BYTES + kBBytes);
  // 4 channels of one pixel of raw input
  using Raw = typename std::conditional<kTf32, uint4, uint2>::type;
  // stage s: A hi [, A lo], B hi [, B lo]
  static __device__ __forceinline__ uint32_t a(int s, int part) {
    return s * kStage + part * A_BYTES;
  }
  static __device__ __forceinline__ uint32_t b(int s, int part) {
    return s * kStage + kParts * A_BYTES + part * kBBytes;
  }
  static constexpr int kSmem = 1024 + STAGES * kStage;  // + the alignment
};

#ifdef CTK_K5_PHASES
// tools/k5_phases.py's build: thread 0 of each block adds the clock64
// cycles of each phase of its main loop here (K5_PHASE(i) books the cycles
// since the previous mark to phase i)
__device__ unsigned long long phase_cycles[8];
#define K5_PHASE(i)                   \
  do {                                \
    const long long t_ = clock64();   \
    ph[i] += t_ - ph_t;               \
    ph_t = t_;                        \
  } while (0)
#else
#define K5_PHASE(i) \
  do {              \
  } while (0)
#endif

template <typename T, int BN>
__global__ void __launch_bounds__(NT, 1) wgrad_kernel(Params p) {
  using L = Tiles<T, BN>;
  using Raw = typename L::Raw;
  constexpr bool kTf32 = L::kTf32;
  constexpr int CH = L::kChunk, PX = L::kPx;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 8 rows of 128 bytes: 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);

  const int tid = threadIdx.x;
  const int H = p.h, W = p.w, C = p.c;
  const int HW = H * W;
  const int cblocks = C / BM;
  const int tap = blockIdx.x / cblocks;
  const int ky = tap / 3, kx = tap % 3;
  const int c0 = (blockIdx.x % cblocks) * BM;
  const int o0 = blockIdx.y * BN;
  const int cps = p.hwp / CH;          // chunks per sample
  const int kc0 = blockIdx.z * p.per;  // this block's first chunk
  const int nchunks = min(p.per, p.n * cps - kc0);
  const size_t ld = static_cast<size_t>(p.n) * p.hwp;  // a row of g's copy

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ skip = static_cast<const T*>(p.skip);
  const T* __restrict__ ghi = static_cast<const T*>(p.ghi);
  const T* __restrict__ glo = static_cast<const T*>(p.glo);
  const bool has_norm = p.norm != nullptr;
  const bool relu = p.relu != 0;
#ifdef CTK_K5_PHASES
  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}, ph_t = clock64();
#endif

  // A staging role: channels cc + j (A rows arow + j, j < 4) of the chunk's
  // pixels PX pg + i (i < PX), which are 16-byte group pg of those rows.
  // f32: 8 lanes load a pixel's 32 channels, one 128-byte line (a warp: 4
  // pixels a load; ~2 % faster than 64-byte halves, tools/k5_phases.py);
  // bf16: 4 lanes a pixel's 16 channels (a warp: 8 pixels a load)
  const int lane = tid & 31, warp = tid >> 5;
  const int pg = kTf32 ? 4 * (warp >> 2) + (lane & 3) : (lane & 7);
  const int arow =
      kTf32 ? 32 * (warp & 3) + 4 * (lane >> 2) : 16 * warp + 4 * (lane >> 3);
  const int cc = c0 + arow;
  // B role: 16-byte group bg of tile rows br0 + 32 i (output channels),
  // chunk kc at element kc CH of these rows
  const int bg = tid & 7, br0 = tid >> 3;
  const size_t boff = static_cast<size_t>(o0 + br0) * ld +
                      static_cast<size_t>(kc0) * CH + (16 / sizeof(T)) * bg;
  const size_t bstride = 32 * ld;

  auto load_b = [&](int kc, int s) {
    const size_t off = boff + static_cast<size_t>(kc) * CH;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const uint32_t dst = sbase + swz(br0 + 32 * i, bg);
      cp_async16(dst + L::b(s, 0), ghi + off + i * bstride);
      if (kTf32) cp_async16(dst + L::b(s, 1), glo + off + i * bstride);
    }
  };

  // the chunk load_a fetches next: sample ln, this thread's first pixel lp
  // of it at (ly, lx); advanced a chunk at a time, so the loop divides only
  // where a sample ends
  int ln = kc0 / cps;
  int lp = (kc0 - ln * cps) * CH + PX * pg;
  int ly = lp / W, lx = lp - ly * W;

  // A of the next chunk, raw: each pixel's 4 channels of x (and skip) in
  // registers, loaded a chunk before they are staged; an: its sample; bit i
  // of ok: pixel i lies in the image (the rest of hwp stages zeros)
  Raw xr[PX], sr[PX];
  uint32_t ok = 0;
  int an = 0;
  auto load_a = [&]() {
    const size_t base = static_cast<size_t>(ln) * HW * C + cc;
    const T* xs = x + base;
    const T* ss = skip != nullptr ? skip + base : nullptr;
    an = ln;
    ok = 0;
    int y = ly, xx = lx;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      if (lp + i < HW) {
        ok |= 1u << i;
        const int iy = reflect1(y + ky - 1, H);
        const int ix = reflect1(xx + kx - 1, W);
        const int off = (iy * W + ix) * C;  // H W C < 2^31
        xr[i] = *reinterpret_cast<const Raw*>(xs + off);
        if (ss != nullptr) sr[i] = *reinterpret_cast<const Raw*>(ss + off);
      }
      if (++xx == W) {
        xx = 0;
        ++y;
      }
    }
    lp += CH;
    if (lp >= p.hwp) {  // the next sample
      ++ln;
      lp = PX * pg;
      ly = lp / W;
      lx = lp - ly * W;
    } else {
      lx += CH;
      while (lx >= W) {
        lx -= W;
        ++ly;
      }
    }
  };

  // the prologue on the raw registers, then the MMA operands (hi [, lo])
  // into stage s, one 16-byte store per channel row
  auto stage_a = [&](int s) {
    float mean[4] = {0.f, 0.f, 0.f, 0.f}, rstd[4] = {1.f, 1.f, 1.f, 1.f};
    if (has_norm) {
      const float* nr = p.norm + static_cast<size_t>(an) * 2 * C + cc;
      const float4 m = *reinterpret_cast<const float4*>(nr);
      const float4 r = *reinterpret_cast<const float4*>(nr + C);
      mean[0] = m.x, mean[1] = m.y, mean[2] = m.z, mean[3] = m.w;
      rstd[0] = r.x, rstd[1] = r.y, rstd[2] = r.z, rstd[3] = r.w;
    }
    float hv[4][PX], lv[4][kTf32 ? PX : 1];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if ((ok >> i) & 1u) {
        unpack(xr[i], v);
        if (has_norm) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float t = (v[j] - mean[j]) * rstd[j];
            v[j] = round_to<T>(relu ? fmaxf(t, 0.f) : t);
          }
          if (skip != nullptr) {  // the cast to T, then the skip
            float sv[4];
            unpack(sr[i], sv);
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = round_to<T>(sv[j] + v[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kTf32) {  // hi = rna(v), lo = rna(v - hi)
          hv[j][i] = tf32(v[j]);
          lv[j][i] = tf32(v[j] - hv[j][i]);
        } else {
          hv[j][i] = v[j];
        }
      }
    }
    K5_PHASE(1);  // the loads' arrival, the prologue and the split
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t* dst = smem + swz(arow + j, pg);
      if constexpr (kTf32) {
        *reinterpret_cast<uint4*>(dst + L::a(s, 0)) = pack(hv[j]);
        *reinterpret_cast<uint4*>(dst + L::a(s, 1)) = pack(lv[j]);
      } else {
        *reinterpret_cast<uint4*>(dst + L::a(s, 0)) = pack(hv[j]);  // exact
      }
    }
    K5_PHASE(2);  // the shared-memory stores
  };

  // f32 I/O: each chunk's products are summed apart (acc, from 0) and added
  // to sum in f32 with rounding to nearest
  float acc[BN / 2], sum[kTf32 ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kTf32 ? BN / 2 : 1); ++i) sum[i] = 0.f;

  // pipeline: in iteration kc the wgmmas of chunk kc (stage kc % 3) are
  // issued first and run while the threads stage chunk kc + 1, then A of
  // chunk kc + 2 is loaded into the registers and its B copied in (in that
  // order: ~1.5 % faster than B first, tools/k5_phases.py). Each write goes
  // to a stage whose last reader, chunk kc - 1 or kc - 2, has been waited
  // for before the barrier that ended the previous iteration.
  load_b(0, 0);
  cp_async_commit();
  if (nchunks > 1) load_b(1, 1);
  cp_async_commit();
  load_a();
  stage_a(0);
  if (nchunks > 1) load_a();
  cp_async_wait<1>();  // B of chunk 0
  fence_async_smem();
  __syncthreads();
  K5_PHASE(6);  // the pipeline's fill

  const uint32_t wg_rows = (tid >> 7) * 64 * ROW;  // this warpgroup's A rows
  int s = 0;                                       // kc % 3
  for (int kc = 0; kc < nchunks; ++kc) {
    const uint32_t ahi = sbase + L::a(s, 0) + wg_rows;
    const uint32_t bhi = sbase + L::b(s, 0);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // k step k: 32 bytes along the rows
      if constexpr (kTf32) {  // the chunk's sum starts from 0
        wgmma_tf32(acc, desc(ahi + A_BYTES + 32 * k), desc(bhi + 32 * k),
                   k > 0);
        wgmma_tf32(acc, desc(ahi + 32 * k), desc(bhi + L::kBBytes + 32 * k));
        wgmma_tf32(acc, desc(ahi + 32 * k), desc(bhi + 32 * k));
      } else {
        wgmma_bf16(acc, desc(ahi + 32 * k), desc(bhi + 32 * k));
      }
    }
    wgmma_commit();
    fence_acc(acc);
    const int s1 = s == 2 ? 0 : s + 1;
    K5_PHASE(0);  // the wgmma issue
    if (kc + 1 < nchunks) stage_a(s1);
    if (kc + 2 < nchunks) {
      load_a();
      load_b(kc + 2, s1 == 2 ? 0 : s1 + 1);
    }
    cp_async_commit();  // possibly empty: one group per iteration
    K5_PHASE(3);  // the next chunk's A loads and B copies: their issue
    wgmma_wait_all();
    fence_acc(acc);
    K5_PHASE(4);  // waiting for the tensor cores
    if constexpr (kTf32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
    }
    cp_async_wait<1>();  // B of chunk kc + 1
    fence_async_smem();
    __syncthreads();
    K5_PHASE(5);  // the f32 sums, B's arrival, the barrier
    s = s1;
  }
  cp_async_wait<0>();
  if constexpr (kTf32) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i];
  }

  // epilogue: thread (warp w, lane l) of the warpgroup holds rows
  // 16 w + l / 4 + {0, 8} and columns 8 j + 2 (l % 4) + {0, 1}; each pair of
  // columns is one 8-byte atomicAdd into dW
  const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  float* dw = p.dw + (static_cast<size_t>(tap) * C + c0 + row) * p.cout + o0 +
              2 * (lane & 3);
  const size_t down8 = 8 * static_cast<size_t>(p.cout);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    atomicAdd(reinterpret_cast<float2*>(dw + 8 * j),
              make_float2(acc[4 * j], acc[4 * j + 1]));
    atomicAdd(reinterpret_cast<float2*>(dw + down8 + 8 * j),
              make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  }
#ifdef CTK_K5_PHASES
  K5_PHASE(7);  // the epilogue's atomics
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      atomicAdd(&phase_cycles[i], static_cast<unsigned long long>(ph[i]));
    }
  }
#endif
}

// the wrapper's B operand in one pass: g (N, H W, Cout) -> K-major (Cout,
// N hwp), hi = g (bf16) or rna(g) (f32) and, for f32, lo = rna(g - hi);
// pixels H W .. hwp - 1 are zeros. A 32 x 32 tile through shared memory, so
// g is read and the copy written along their contiguous axes.
template <typename T>
__global__ void __launch_bounds__(256)
    operands_kernel(const T* __restrict__ g, T* __restrict__ hi,
                    T* __restrict__ lo, int hw, int hwp, int cout) {
  __shared__ float tile[32][33];
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * 32, o0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int k = ty; k < 32; k += 8) {
    const int px = p0 + k;
    tile[k][tx] =
        px < hw ? to_f(g[(static_cast<size_t>(n) * hw + px) * cout + o0 + tx])
                : 0.f;
  }
  __syncthreads();
  const size_t ld = static_cast<size_t>(gridDim.z) * hwp;
#pragma unroll
  for (int k = ty; k < 32; k += 8) {
    const float v = tile[tx][k];
    const size_t dst =
        static_cast<size_t>(o0 + k) * ld + static_cast<size_t>(n) * hwp + p0 +
        tx;
    if constexpr (std::is_same<T, float>::value) {
      const float h = tf32(v);
      hi[dst] = h;
      lo[dst] = tf32(v - h);
    } else {
      hi[dst] = from_f<T>(v);
    }
  }
}

template <typename T, int BN>
int launch(const Params& p, int splits, cudaStream_t stream) {
  using L = Tiles<T, BN>;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(9 * (p.c / BM), p.cout / BN, splits);
  wgrad_kernel<T, BN><<<grid, NT, L::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k5
}  // namespace ctk

// bn: dW columns per block (128; 256 for bf16 where Cout allows), per: K
// chunks per block, splits: blocks along the pixel axis (ops/
// fused_resblock_grad.py::k5_plan)
extern "C" int ctk_conv3x3_weight_grad(
    const void* x, const void* skip, const void* ghi, const void* glo,
    const void* norm, void* dw, int n, int h, int wd, int c, int cout,
    int hwp, int relu, int bn, int per, int splits, int bf16, void* stream) {
  ctk::k5::Params p{x, skip, ghi, glo, static_cast<const float*>(norm),
                    static_cast<float*>(dw), n, h, wd, c, cout, relu, hwp,
                    per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && bn == 256) return ctk::k5::launch<__nv_bfloat16, 256>(p, splits, s);
  if (bf16 && bn == 128) return ctk::k5::launch<__nv_bfloat16, 128>(p, splits, s);
  if (!bf16 && bn == 128) return ctk::k5::launch<float, 128>(p, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g (N, H W, Cout) -> K5's B operand (Cout, N hwp): hi [, lo for f32]
// (ops/fused_resblock_grad.py::k5_operands); hwp % 32 == 0, cout % 32 == 0
extern "C" int ctk_k5_operands(const void* g, void* hi, void* lo, int n,
                               int hw, int hwp, int cout, int bf16,
                               void* stream) {
  dim3 grid(hwp / 32, cout / 32, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    ctk::k5::operands_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(hi),
        nullptr, hw, hwp, cout);
  } else {
    ctk::k5::operands_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(g), static_cast<float*>(hi),
        static_cast<float*>(lo), hw, hwp, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef CTK_K5_PHASES
// copy K5's phase cycles (summed since the last reset) to out[8], then zero
// them
extern "C" int ctk_k5_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ctk::k5::phase_cycles,
                                       8 * sizeof(unsigned long long));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(ctk::k5::phase_cycles, zero,
                                             sizeof(zero)));
}
#endif
