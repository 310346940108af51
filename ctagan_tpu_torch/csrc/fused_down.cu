// K3: stride-2 3x3 conv, zero pad 1 in the post-norm domain, + output
// [sum, sum^2], with the previous InstanceNorm (+ReLU) folded into the input
// read. Replaces ctagan_tpu/ops/fused_down.py::conv3x3_s2_zero_stats (its
// pallas_call at :168). It is the tensor-core body of conv_wgmma.cuh in its
// Stride2 mode (k3_wgmma_kernel): M = the (H/2)(W/2) output pixels of one
// sample, N = Cout, K = 9 C; f32 as 3xTF32 with per-chunk f32 sums, bf16
// on bf16 operands. At the generator's down1, N=2 512^2 x 64 -> 128, it is
// 19.33 GFLOP: 0.117 ms for three TF32 products; in bf16 the 100 MB of x
// and out bound it at 0.030 ms.
#include "conv_wgmma.cuh"

// x (N, H, W, C), H and W even; w_hi [, w_lo] the K-major (cout, 9 C)
// weight (ops/fused_resblock.py::k1_weight); out (N, H/2, W/2, cout)
extern "C" int ctk_conv3x3_s2_zero_stats(
    const void* x, const void* whi, const void* wlo, const void* b,
    const void* norm, void* out, void* stats, int n, int h, int wd, int c,
    int cout, int relu, int bf16, void* stream) {
  ctk::k1::Params p{x, nullptr, whi, wlo, static_cast<const float*>(b),
                    static_cast<const float*>(norm), out,
                    static_cast<float*>(stats), nullptr, n, h, wd, c, cout,
                    relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using ctk::k1::Mode;
  return bf16 ? ctk::k1::dispatch<Mode::Stride2, __nv_bfloat16>(p, s)
              : ctk::k1::dispatch<Mode::Stride2, float>(p, s);
}
