// K7 (k7_wgmma_kernel): reflect-padded 3x3 conv with int8 operands and
// int32 accumulation, a fused f32 dequant and the output's [sum, sum^2].
// Replaces the Pallas TPU kernel ctagan_tpu/ops/fused_s8.py::
// conv3x3_reflect_s8 (its pallas_call at :159; the int8 serving path's
// residual body, 18 launches per generator forward).
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
// atomics. The int32 sums are exact in any order (at most 9 C 128^2 in
// magnitude, inside int32 for C <= 14,563), so the output equals the plain
// version's bit for bit.
//
// What bounds it on the H100: operations. At the body's (N, 128, 128, 256)
// -> 256, K = 9 * 256, each sample is ~19.3 G int8 multiply-adds x 2 against
// 1,979 TOPS on the int8 tensor cores, with ~17 MB moved per sample. So every
// multiply-add runs on the tensor cores, as an implicit GEMM:
//
// - M = an 8 x 16 tile of output pixels of one sample (two warpgroups of 64
//   rows; a tile never crosses samples, so the stats atomics go to one n),
//   N = BN output channels (256 where Cout allows, else 128), K = 9 C
//   walked in chunks of one tap x 128 int8 channels, taps inner: one
//   128-byte row per operand row, so the 128B swizzle and descriptor of
//   wgmma.cuh apply as they do for K1's bf16 chunks, and a chunk is four
//   wgmma.m64n{BN}k32.s32.s8.s8 steps with the int32 accumulator in
//   registers. No second accumulator: integer sums do not truncate.
// - B, the weight, is a K-major (Cout, 9 C) int8 copy that the wrapper makes
//   per call (ops/fused_s8.py::k7_weight), brought in by cp.async.
// - A, mode (i): each (row, 16-byte group) of a chunk is 16 int8 channels of
//   the tap's reflect-indexed source pixel, so A goes by cp.async straight
//   into the swizzled tile, as B does, and the threads stage nothing.
//   Mode (ii): the quantization is a function of (pixel, channel) alone, so
//   the threads quantize the tile's 10 x 18 halo once per 128-channel block
//   into shared memory (the int8 image exists only there) and copy each
//   tap's A tile out of it, while the tensor cores run the previous chunk.
//   Quantizing per tap, as the TPU kernel's slab layout does not need to,
//   did the same work nine times over: 0.145 ms against 0.047 for mode (i)
//   at N = 2 on an H100, with the threads' ~880 instructions per chunk the
//   limit (two warps per scheduler hide little of their latency).
// - Pipeline: four shared-memory stages (mode (ii) three, beside its halo);
//   the copies run S - 2 chunks ahead, and one chunk's wgmmas stay in
//   flight across the barrier that ends it (wgmma.wait_group 1), so the
//   tensor cores are fed while the block waits.
// - Epilogue: dequant and rounding, through shared memory to 16-byte row
//   stores, then column sums of the rounded values, one atomicAdd per
//   column per block.
//
// Limits (the wrapper raises for anything else): C % 128 == 0, C <= 2048
// (the norm's shared memory), Cout % 128 == 0, 16-byte aligned tensors,
// H, W >= 2; any N, H, W beyond that (the ragged tile masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "element.cuh"
#include "wgmma.cuh"

namespace ctk {
namespace s8 {

constexpr int BM = 128;            // output pixels per block, 64 per warpgroup
constexpr int NT = 256;            // two warpgroups
constexpr int BK = ROW;            // int8 channels per K chunk: a 128-byte row
constexpr int A_BYTES = BM * ROW;  // one A tile
constexpr int EPAD = 8;            // epilogue tile row padding, elements
constexpr int TY = 8, TX = 16;     // a tile: 8 x 16 output pixels
constexpr int HX = TX + 2;         // its halo: (TY + 2) x (TX + 2) pixels
constexpr int HALO = (TY + 2) * HX;
static_assert(TY * TX == BM, "a tile is the GEMM's M rows");

struct Params {
  const void* x;        // (N, H, W, C): int8 (mode i) or InT raw (mode ii)
  const int8_t* wk;     // (Cout, 9 C) K-major weight, K = (ky, kx, c)
  const float* scale;   // (Cout,) combined dequant scale
  const float* b;       // (Cout,) bias
  const float* norm;    // (N, 2, C) [mean, rstd] (mode ii), else null
  void* out;            // (N, H, W, Cout), OutT
  float* stats;         // (N, 2, Cout) [sum, sum^2], zeroed by the caller
  int n, h, w, c, cout;
  float qmul;           // 127 / act_clip (mode ii)
};

template <typename InT, int BN>
struct Tiles {
  static constexpr bool kRaw = !std::is_same<InT, int8_t>::value;
  // A and B tiles in shared memory (mode (ii) makes room for the halo)
  static constexpr int kStages = kRaw ? 3 : 4;
  static constexpr int kAhead = kStages - 2;  // chunks copied ahead
  static constexpr int kStage = A_BYTES + BN * ROW;  // A, then B
  // + 1024 for the alignment; mode (ii) the quantized halo and the (2, C)
  // norm; the epilogue's column sums
  static size_t smem_bytes(int c) {
    return 1024 + kStages * kStage +
           (kRaw ? HALO * ROW + 2 * static_cast<size_t>(c) * 4 : 0) +
           2 * NT * 4;
  }
};

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// the dequant, one rounding per operation in the plain version's order
__device__ __forceinline__ float dequant(int acc, float scale, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), b);
}

// the mode (ii) input q = clamp(rint(max((v - mean) rstd, 0) qmul), 0, 127)
// in the low byte: for a product >= 0, min(., 127) before the rounding is
// the same clamp, and adding 1.5 * 2^23 (whose ulp is 1) rounds to nearest
// even and leaves the integer in the low mantissa bits, with no conversion
// instruction
__device__ __forceinline__ uint32_t quantize(float v, float mean, float rstd,
                                             float qmul) {
  const float f = __fmul_rn(__fsub_rn(v, mean), rstd);
  const float t = fminf(__fmul_rn(fmaxf(f, 0.f), qmul), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.f));
}

// 16 raw values (kU 16-byte words of f32 or bf16) as f32
__device__ __forceinline__ void unpack16(const uint4 (&u)[4],
                                         float (&v)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float t[4];
    unpack(u[k], t);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * k + j] = t[j];
  }
}

__device__ __forceinline__ void unpack16(const uint4 (&u)[2],
                                         float (&v)[16]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float t[8];
    unpack(u[k], t);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[8 * k + j] = t[j];
  }
}

// InT: int8_t (mode i), float or __nv_bfloat16 (mode ii); OutT: float or
// bf16; BN: output channels per block (256 or 128)
template <typename InT, typename OutT, int BN>
__global__ void __launch_bounds__(NT, 1) k7_wgmma_kernel(Params p) {
  using L = Tiles<InT, BN>;
  constexpr bool kRaw = L::kRaw;
  constexpr int S = L::kStages, D = L::kAhead;
  // 16-byte words of input per 16-channel group: 1 int8, 2 bf16, 4 f32
  constexpr int kU = static_cast<int>(sizeof(InT));
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 8 rows of 128 bytes: 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  uint8_t* halo = smem + S * L::kStage;  // mode (ii): HALO rows of 128 bytes
  float* s_norm = reinterpret_cast<float*>(halo + (kRaw ? HALO * ROW : 0));
  float* s_red = s_norm + (kRaw ? 2 * p.c : 0);  // [row parts][sum, sum^2][BN]

  const int tid = threadIdx.x;
  const int H = p.h, W = p.w, C = p.c, Cout = p.cout;
  const int P = H * W;
  // block (n, tile): tile row r is output pixel (y0 + r / TX, x0 + r % TX)
  const int tiles_x = (W + TX - 1) / TX;
  const int tiles = tiles_x * ((H + TY - 1) / TY);
  const int n = blockIdx.x / tiles;
  const int y0 = (blockIdx.x % tiles) / tiles_x * TY;
  const int x0 = (blockIdx.x % tiles) % tiles_x * TX;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;
  const int nchunks = 9 * (C / BK);  // >= 9
  const InT* __restrict__ x =
      static_cast<const InT*>(p.x) + static_cast<size_t>(n) * P * C;
  const int8_t* __restrict__ wk = p.wk;

  if constexpr (kRaw) {
    for (int i = tid; i < 2 * C; i += NT) {
      s_norm[i] = p.norm[static_cast<size_t>(n) * 2 * C + i];
    }
  }

  // staging role: 16-byte group g (int8 channels 16 g .. 16 g + 15 of a
  // chunk) of tile rows r0 + 32 i, for A (pixels) and B (output channels);
  // a row past the image reads the image's last row or column, and its
  // output is dropped
  const int g = tid & 7;
  const int r0 = tid >> 3;
  int oy[4], ox[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    oy[i] = min(y0 + (r0 + 32 * i) / TX, H - 1);
    ox[i] = min(x0 + (r0 + 32 * i) % TX, W - 1);
  }
  // chunk kc: tap kc % 9 of channel block kc / 9; the element offset of
  // row i's group in this sample's x
  auto src = [&](int kc, int i) {
    const int tap = kc % 9;
    const int iy = reflect1(oy[i] + tap / 3 - 1, H);
    const int ix = reflect1(ox[i] + tap % 3 - 1, W);
    return (static_cast<size_t>(iy) * W + ix) * C + (kc / 9) * BK + 16 * g;
  };
  // B of chunk kc, and in mode (i) A, by cp.async into stage s
  auto copy = [&](int kc, int s) {
    const uint32_t st = sbase + s * L::kStage;
    const size_t k0 = static_cast<size_t>(kc % 9) * C + (kc / 9) * BK + 16 * g;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int r = r0 + 32 * i;
      cp_async16(st + A_BYTES + swz(r, g),
                 wk + static_cast<size_t>(n0 + r) * K + k0);
    }
    if constexpr (!kRaw) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cp_async16(st + swz(r0 + 32 * i, g), x + src(kc, i));
      }
    }
  };

  // mode (ii): the tile's halo of quantized input for one channel block,
  // built once and read by its nine taps. Halo pixel hp = (hy, hx) holds
  // source pixel (y0 + hy - 1, x0 + hx - 1), reflected (and, past a ragged
  // edge, clamped: only dropped outputs read those); its 16-byte groups are
  // swizzled by hp % 8, so a warp's reads of four pixels hit every bank
  auto halo_at = [&](int hp) {
    return halo + hp * ROW + ((g ^ (hp & 7)) << 4);
  };
  auto build_halo = [&](int cb) {
    if constexpr (kRaw) {
      const int c = cb * BK + 16 * g;
      const float4* mean = reinterpret_cast<const float4*>(s_norm + c);
      const float4* rstd = reinterpret_cast<const float4*>(s_norm + C + c);
#pragma unroll 2
      for (int hp = r0; hp < HALO; hp += NT / 8) {
        const int hy = hp / HX, hx = hp % HX;
        const int iy = max(min(reflect1(y0 + hy - 1, H), H - 1), 0);
        const int ix = max(min(reflect1(x0 + hx - 1, W), W - 1), 0);
        const uint4* src4 = reinterpret_cast<const uint4*>(
            x + (static_cast<size_t>(iy) * W + ix) * C + c);
        uint4 raw[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) raw[u] = src4[u];
        float v[16];
        unpack16(raw, v);
        uint32_t q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 m = mean[k], r = rstd[k];
          const uint32_t u0 = quantize(v[4 * k], m.x, r.x, p.qmul);
          const uint32_t u1 = quantize(v[4 * k + 1], m.y, r.y, p.qmul);
          const uint32_t u2 = quantize(v[4 * k + 2], m.z, r.z, p.qmul);
          const uint32_t u3 = quantize(v[4 * k + 3], m.w, r.w, p.qmul);
          // the four low bytes, in order
          q[k] = __byte_perm(__byte_perm(u0, u1, 0x0040),
                             __byte_perm(u2, u3, 0x0040), 0x5410);
        }
        *reinterpret_cast<uint4*>(halo_at(hp)) =
            make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
  };
  // chunk kc's A tile from the halo into stage s: row r at tap (ky, kx) is
  // halo pixel (r / TX + ky, r % TX + kx)
  auto stage_a = [&](int kc, int s) {
    if constexpr (kRaw) {
      const int tap = kc % 9;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 32 * i;
        const int hp = (r / TX + tap / 3) * HX + r % TX + tap % 3;
        *reinterpret_cast<uint4*>(smem + s * L::kStage + swz(r, g)) =
            *reinterpret_cast<const uint4*>(halo_at(hp));
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  // pipeline: chunk kc lives in stage kc % S. Iteration kc waits for its
  // copies (one cp.async group per chunk), then copies chunk kc + D into
  // the stage of chunk kc + D - S, whose wgmmas both warpgroups have waited
  // for before the barrier; issues chunk kc's wgmmas; in mode (ii) builds
  // the next channel block's halo where chunk kc + 1 starts one (the last
  // tap of the halo's previous block was staged in iteration kc - 1) and
  // stages chunk kc + 1's A into its stage (last read by chunk kc + 1 - S);
  // and leaves chunk kc's wgmmas in flight (S >= 3 keeps them off the
  // stage being written)
  __syncthreads();  // s_norm
#pragma unroll
  for (int j = 0; j < D; ++j) {
    copy(j, j);
    cp_async_commit();
  }
  if constexpr (kRaw) {
    build_halo(0);
    __syncthreads();
    stage_a(0, 0);
  }
  const uint32_t wg_rows = (tid >> 7) * 64 * ROW;  // this warpgroup's A rows
  for (int kc = 0; kc < nchunks; ++kc) {
    const int s = kc % S;
    cp_async_wait<D - 1>();  // chunk kc's copies
    fence_async_smem();      // and the threads' stores of its A, for wgmma
    __syncthreads();
    if (kc + D < nchunks) copy(kc + D, (kc + D) % S);
    cp_async_commit();  // possibly empty: one group per iteration
    const uint32_t a = sbase + s * L::kStage + wg_rows;
    const uint32_t b = sbase + s * L::kStage + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // k32 step k: 32 bytes along the rows
      wgmma_s8(acc, desc(a + 32 * k), desc(b + 32 * k));
    }
    wgmma_commit();
    fence_acc(acc);
    if constexpr (kRaw) {
      if (kc + 1 < nchunks) {
        if ((kc + 1) % 9 == 0) {
          build_halo((kc + 1) / 9);
          __syncthreads();
        }
        stage_a(kc + 1, (kc + 1) % S);
      }
    }
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // both warpgroups' wgmmas are done with the stages

  // epilogue: thread (warp w, lane l) of the warpgroup holds rows
  // 16 w + l / 4 + {0, 8} and columns 8 j + 2 (l % 4) + {0, 1}; the rounded
  // tile goes through shared memory, to be stored in 16-byte row pieces and
  // summed by columns
  constexpr int LD = BN + EPAD;
  static_assert(BM * LD * sizeof(OutT) <= S * L::kStage, "tile");
  OutT* tile = reinterpret_cast<OutT*>(smem);
  {
    const int lane = tid & 31;
    const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float s0 = p.scale[n0 + col], s1 = p.scale[n0 + col + 1];
      const float b0 = p.b[n0 + col], b1 = p.b[n0 + col + 1];
      store2(tile + row * LD + col, dequant(acc[4 * j], s0, b0),
             dequant(acc[4 * j + 1], s1, b1));
      store2(tile + (row + 8) * LD + col, dequant(acc[4 * j + 2], s0, b0),
             dequant(acc[4 * j + 3], s1, b1));
    }
  }
  __syncthreads();
  constexpr int kV = 16 / sizeof(OutT);
  constexpr int kRowWords = BN / kV;
  OutT* out = static_cast<OutT*>(p.out) + static_cast<size_t>(n) * P * Cout +
              n0;
  // tile row r's pixel is in the image (a ragged tile's others are dropped)
  auto inside = [&](int r) {
    return y0 + r / TX < H && x0 + r % TX < W;
  };
  for (int idx = tid; idx < BM * kRowWords; idx += NT) {
    const int row = idx / kRowWords, wd = idx % kRowWords;
    if (inside(row)) {
      const size_t m = static_cast<size_t>(y0 + row / TX) * W + x0 + row % TX;
      *reinterpret_cast<uint4*>(out + m * Cout + wd * kV) =
          *reinterpret_cast<const uint4*>(tile + row * LD + wd * kV);
    }
  }
  // column col over rows part * RP .. + RP, then the parts summed
  constexpr int kRowParts = NT / BN, RP = BM / kRowParts;
  {
    const int col = tid % BN, part = tid / BN;
    float s0 = 0.f, q0 = 0.f;
    for (int r = part * RP; r < (part + 1) * RP; ++r) {
      if (!inside(r)) continue;
      const float v = to_f(tile[r * LD + col]);
      s0 += v;
      q0 += v * v;
    }
    s_red[(part * 2 + 0) * BN + col] = s0;
    s_red[(part * 2 + 1) * BN + col] = q0;
  }
  __syncthreads();
  for (int i = tid; i < 2 * BN; i += NT) {
    const int which = i / BN, col = i % BN;
    float t = 0.f;
#pragma unroll
    for (int part = 0; part < kRowParts; ++part) {
      t += s_red[(part * 2 + which) * BN + col];
    }
    atomicAdd(&p.stats[(n * 2 + which) * Cout + n0 + col], t);
  }
}

template <typename InT, typename OutT, int BN>
int launch(const Params& p, cudaStream_t stream) {
  auto* kernel = k7_wgmma_kernel<InT, OutT, BN>;
  const size_t smem = Tiles<InT, BN>::smem_bytes(p.c);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((p.h + TY - 1) / TY) * ((p.w + TX - 1) / TX);
  dim3 grid(p.n * tiles, p.cout / BN);
  kernel<<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 256-channel tiles where Cout allows: each staged A row feeds more products
template <typename InT, typename OutT>
int dispatch(const Params& p, cudaStream_t stream) {
  return p.cout % 256 == 0 ? launch<InT, OutT, 256>(p, stream)
                           : launch<InT, OutT, 128>(p, stream);
}

template <typename InT>
int dispatch_out(const Params& p, int out_bf16, cudaStream_t stream) {
  return out_bf16 ? dispatch<InT, __nv_bfloat16>(p, stream)
                  : dispatch<InT, float>(p, stream);
}

}  // namespace s8
}  // namespace ctk

// w: the K-major (Cout, 9 C) int8 weight; in_kind: 0 int8 (mode i), 1 f32
// raw, 2 bf16 raw (mode ii)
extern "C" int ctk_conv3x3_reflect_s8(
    const void* x, const void* w, const void* scale, const void* b,
    const void* norm, void* out, void* stats, int n, int h, int wd, int c,
    int cout, int in_kind, int out_bf16, float qmul, void* stream) {
  using namespace ctk::s8;
  Params p{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
           static_cast<const float*>(b), static_cast<const float*>(norm), out,
           static_cast<float*>(stats), n, h, wd, c, cout, qmul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == 0) return dispatch_out<int8_t>(p, out_bf16, s);
  if (in_kind == 1) return dispatch_out<float>(p, out_bf16, s);
  return dispatch_out<__nv_bfloat16>(p, out_bf16, s);
}
