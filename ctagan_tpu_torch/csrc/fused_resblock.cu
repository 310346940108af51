// K1 ctk_conv3x3_reflect_stats (k1_wgmma_kernel) replaces ctagan_tpu/ops/
// fused_resblock.py::conv3x3_reflect_stats (its pallas_call at :251): the
// reflect-padded 3x3 conv + output [sum, sum^2], with the previous
// InstanceNorm (+ReLU) and the previous block's skip-add folded into the
// input read, on Hopper's tensor cores. Its body, shared with K4 and K3,
// and its design are in conv_wgmma.cuh; K5 (fused_resblock_grad.cuh)
// builds in this file too.
//
// K4 ctk_conv3x3_zero_corr (k4_wgmma_kernel) replaces ctagan_tpu/ops/
// fused_resblock_grad.py::_corr3x3_zero (its pallas_call at :115, reached
// through conv3x3_input_grad): the interior of dL/dx of the reflect conv,
// a zero-halo 3x3 correlation of g (N, H, W, Cout_f) with the flipped,
// in/out-swapped kernel, K-major (C_f, 9 Cout_f) as B: the body in its
// Zero mode. At the training body's (1, 128, 128, 256) -> 256 it is 19.33
// GFLOP: 0.117 ms for three TF32 products, 0.020 ms in bf16, on 256 (f32)
// or 128 (bf16) blocks. The wrapper adds the reflect folds in f32 after it.
#include "conv_wgmma.cuh"
#include "fused_resblock_grad.cuh"

extern "C" int ctk_conv3x3_reflect_stats(
    const void* x, const void* skip, const void* whi, const void* wlo,
    const void* b, const void* norm, void* out, void* stats, void* xnew,
    int n, int h, int wd, int c, int cout, int relu, int bf16, void* stream) {
  ctk::k1::Params p{x, skip, whi, wlo, static_cast<const float*>(b),
                    static_cast<const float*>(norm), out,
                    static_cast<float*>(stats), xnew, n, h, wd, c, cout, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using ctk::k1::Mode;
  return bf16 ? ctk::k1::dispatch<Mode::Reflect, __nv_bfloat16>(p, s)
              : ctk::k1::dispatch<Mode::Reflect, float>(p, s);
}

// K4: g (N, H, W, C) with C = the forward conv's Cout; w_hi [, w_lo] the
// K-major (cout, 9 C) flipped kernel (ops/fused_resblock_grad.py::
// k4_weight), cout = the forward conv's C; out (N, H, W, cout)
extern "C" int ctk_conv3x3_zero_corr(const void* g, const void* whi,
                                     const void* wlo, void* out, int n,
                                     int h, int wd, int c, int cout, int bf16,
                                     void* stream) {
  ctk::k1::Params p{g, nullptr, whi, wlo, nullptr, nullptr, out, nullptr,
                    nullptr, n, h, wd, c, cout, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using ctk::k1::Mode;
  return bf16 ? ctk::k1::dispatch<Mode::Zero, __nv_bfloat16>(p, s)
              : ctk::k1::dispatch<Mode::Zero, float>(p, s);
}

extern "C" const char* ctk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
