// K2: ConvTranspose2d(k3, s2, p1, op1) in phase form + output [sum, sum^2]
// over all four phases, with the previous InstanceNorm (+ReLU) folded into the
// input read. Writes the spatial (N, 2H, 2W, Cout) tensor directly.
// Replaces ops/fused_convt.py::convt2x_stats.
#include "conv_stats.cuh"

extern "C" int ctk_convt2x_stats(
    const void* x, const void* w, const void* b, const void* norm, void* out,
    void* stats, int n, int h, int wd, int c, int cout, int relu, int bf16,
    void* stream) {
  ctk::Params p{x, w, static_cast<const float*>(b),
                static_cast<const float*>(norm), out,
                static_cast<float*>(stats), n, h, wd, c, cout,
                2 * h, 2 * wd, relu};
  return ctk::launch<ctk::CONVT_S2>(p, bf16, stream);
}
