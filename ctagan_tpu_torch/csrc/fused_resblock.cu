// K1: reflect-padded 3x3 conv + output [sum, sum^2], with the previous
// InstanceNorm (+ReLU) and the previous block's skip-add folded into the
// input read. Replaces ops/fused_resblock.py::conv3x3_reflect_stats.
#include "conv_stats.cuh"

extern "C" int ctk_conv3x3_reflect_stats(
    const void* x, const void* skip, const void* w, const void* b,
    const void* norm, void* out, void* stats, void* xnew, int n, int h,
    int wd, int c, int cout, int relu, int bf16, void* stream) {
  ctk::Params p{x, skip, w, static_cast<const float*>(b),
                static_cast<const float*>(norm), out,
                static_cast<float*>(stats), xnew, n, h, wd, c, cout, h, wd,
                relu};
  return ctk::launch<ctk::REFLECT_S1>(p, bf16, stream);
}

extern "C" const char* ctk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
