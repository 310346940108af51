// K2: ConvTranspose2d(k3, s2, p1, op1) in phase form + output [sum, sum^2]
// over all four phases, with the previous InstanceNorm (+ReLU) folded into
// the input read; writes the spatial (N, 2H, 2W, Cout) tensor directly.
// Replaces ctagan_tpu/ops/fused_convt.py::convt2x_stats (its pallas_call at
// :183). It is the tensor-core body of conv_wgmma.cuh in its ConvT2x mode
// (k2_wgmma_kernel): one output phase per blockIdx.z, M = the H W input
// positions of one sample, N = Cout, K = the phase's 1, 2, 2 or 4 taps x C;
// f32 as 3xTF32 with per-chunk f32 sums, bf16 on bf16 operands. At the
// generator's up1, N=2 128^2 x 256 -> 256^2 x 128, it is 19.33 GFLOP:
// 0.117 ms for three TF32 products, 0.020 ms for bf16 ones (its 50 MB of
// bf16 x and out take 0.015 ms).
#include "conv_wgmma.cuh"

// x (N, H, W, C); w_hi [, w_lo] the K-major (cout, 9 C) weight of the
// (C, cout, 3, 3) kernel_t (ops/fused_resblock.py::k1_weight of kernel_t
// permuted to (3, 3, C, cout)); out (N, 2H, 2W, cout)
extern "C" int ctk_convt2x_stats(
    const void* x, const void* whi, const void* wlo, const void* b,
    const void* norm, void* out, void* stats, int n, int h, int wd, int c,
    int cout, int relu, int bf16, void* stream) {
  ctk::k1::Params p{x, nullptr, whi, wlo, static_cast<const float*>(b),
                    static_cast<const float*>(norm), out,
                    static_cast<float*>(stats), nullptr, n, h, wd, c, cout,
                    relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using ctk::k1::Mode;
  return bf16 ? ctk::k1::dispatch<Mode::ConvT2x, __nv_bfloat16>(p, s)
              : ctk::k1::dispatch<Mode::ConvT2x, float>(p, s);
}
