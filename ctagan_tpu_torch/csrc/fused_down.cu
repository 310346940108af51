// K3: stride-2 3x3 conv, zero pad 1 in the post-norm domain, + output
// [sum, sum^2], with the previous InstanceNorm (+ReLU) folded into the input
// read. Replaces ops/fused_down.py::conv3x3_s2_zero_stats.
#include "conv_stats.cuh"

extern "C" int ctk_conv3x3_s2_zero_stats(
    const void* x, const void* w, const void* b, const void* norm, void* out,
    void* stats, int n, int h, int wd, int c, int cout, int relu, int bf16,
    void* stream) {
  ctk::Params p{x, w, static_cast<const float*>(b),
                static_cast<const float*>(norm), out,
                static_cast<float*>(stats), n, h, wd, c, cout,
                h / 2, wd / 2, relu};
  return ctk::launch<ctk::ZERO_S2>(p, bf16, stream);
}
