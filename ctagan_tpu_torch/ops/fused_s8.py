"""Int8 fused residual body: reflect 3×3 conv, int8 operands (K7).

Replaces ``ctagan_tpu/ops/fused_s8.py::conv3x3_reflect_s8`` (a Pallas TPU
kernel) with the CUDA kernel ``csrc/fused_s8.cu`` (``k7_wgmma_kernel``), and
ports the ``fused_residual_chain_s8`` orchestration and the ``s8_chain_ok``
gate around it. The int8 serving path (``ops/quantize.py``) runs the
residual body through it: per block one plain pass (trunk max-abs,
quantize) and two K7 launches.

What bounds it on the H100: operations (~19.3 G int8 multiply-adds per
sample per conv at (N, 128, 128, 256) → 256). The kernel is an implicit
GEMM on the int8 tensor cores (``wgmma`` s8 × s8 → s32) over a K-major copy
of the weight (:func:`k7_weight`); in mode (ii) the threads quantize each
output tile's halo once per channel block into shared memory and stage the
taps' activation tiles from it. The int32 sums are exact in any
order, and the dequant is one rounding per operation in a fixed order, so
the kernel's output equals :func:`conv3x3_reflect_s8_plain`'s exactly; only
the statistics, summed with atomics, differ in their last bits.

On a CUDA tensor the wrapper launches the kernel or raises
(:func:`check_k7_kernel_limits`); on a CPU tensor it runs
:func:`conv3x3_reflect_s8_plain`, which is also the kernel's oracle on the
card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ctagan_tpu_torch.models.layers import channel_stats, reflect_pad
from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops._common import DTYPES, check_bias, same_device, stream_ptr
from ctagan_tpu_torch.ops.fused_resblock import _stats_to_norm


def im2col(xp: torch.Tensor, stride: int, ho: int, wo: int) -> torch.Tensor:
    """(N, Hp, Wp, C) padded input -> (N·Ho·Wo, 9·C) 3×3 patches, taps in
    (kh, kw) order and channels inner: the rows of an HWIO kernel's
    (9·C, O) reshape."""
    n, _, _, c = xp.shape
    taps = [xp[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, dim=3).reshape(n * ho * wo, 9 * c)


def int8_matmul(a: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) × (K, N) → int32 (``torch._int_mm``), with the
    weight passed column-major: cuBLAS's int8 GEMM on the H100 took 0.062
    ms that way against 0.320 ms row-major at 32768 × 2304 × 256."""
    return torch._int_mm(a, w_mat.t().contiguous().t())


def _check_args(x, w_q, w_scale, b, x_scale, norm, out_dtype):
    fn = "conv3x3_reflect_s8"
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{fn}: x must be a contiguous (N, H, W, C) tensor")
    n, h, wd, c = x.shape
    if h < 2 or wd < 2:
        raise ValueError(f"{fn}: reflect pad needs H, W >= 2, got {h}x{wd}")
    if norm is None:
        if x.dtype != torch.int8 or x_scale is None:
            raise ValueError(f"{fn}: mode (i) takes an int8 x and x_scale")
    else:
        if x.dtype not in DTYPES or x_scale is not None:
            raise ValueError(f"{fn}: mode (ii) takes a raw f32/bf16 x, a "
                             "norm and no x_scale")
        if tuple(norm.shape) != (n, 2, c):
            raise ValueError(f"{fn}: norm must be (N, 2, C), got "
                             f"{tuple(norm.shape)}")
    if (w_q.dtype != torch.int8 or w_q.dim() != 4
            or tuple(w_q.shape[:3]) != (3, 3, c)):
        raise ValueError(f"{fn}: w_q must be int8 (3, 3, {c}, Cout), got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    cout = w_q.shape[3]
    if tuple(w_scale.shape) != (cout,):
        raise ValueError(f"{fn}: w_scale must be ({cout},)")
    check_bias(fn, b, cout)
    if out_dtype not in DTYPES:
        raise ValueError(f"{fn}: out_dtype must be one of {DTYPES}")


def _combined_scale(w_scale, x_scale, act_clip):
    """w_scale · act_scale in f32, as JAX folds it: act_clip / 127 in mode
    (ii), x_scale in mode (i)."""
    act_scale = act_clip / 127.0 if x_scale is None else x_scale
    return (w_scale.float() * act_scale).contiguous()


def conv3x3_reflect_s8_plain(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    b: torch.Tensor, x_scale=None, norm: Optional[torch.Tensor] = None,
    act_clip: float = 8.0, out_dtype: torch.dtype = torch.bfloat16,
):
    """Plain PyTorch version of :func:`conv3x3_reflect_s8`: the mode (ii)
    quantization, a reflect pad, an im2col and an exact int8 × int8 → int32
    product (``torch._int_mm``), then the f32 dequant with the kernel's
    operations in the kernel's order, and stats of the rounded output."""
    _check_args(x, w_q, w_scale, b, x_scale, norm, out_dtype)
    n, h, wd, c = x.shape
    cout = w_q.shape[3]
    if norm is not None:
        nf = norm.float()
        a = torch.clamp_min((x.float() - nf[:, 0, None, None, :])
                            * nf[:, 1, None, None, :], 0.0)
        x = torch.clamp(torch.round(a * (127.0 / act_clip)), 0.0,
                        127.0).to(torch.int8)
    cols = im2col(reflect_pad(x, 1), 1, h, wd)
    acc = int8_matmul(cols, w_q.reshape(9 * c, cout))
    out = acc.float() * _combined_scale(w_scale, x_scale, act_clip)
    out = (out + b.float()).to(out_dtype).reshape(n, h, wd, cout)
    return out, channel_stats(out)


# the kernel's tiles: K chunks of one tap × 128 int8 channels (one 128-byte
# row), 128- or 256-channel output tiles; its shared memory holds the (2, C)
# norm beside the operand stages
K7_CHUNK, K7_COUT_TILE, K7_MAX_C = 128, 128, 2048


def check_k7_kernel_limits(x: torch.Tensor, w_q: torch.Tensor) -> None:
    """Raise ValueError for what the CUDA kernel cannot take: C % 128,
    Cout % 128, C > 2048, H or W < 2, or x or w_q not on a 16-byte boundary
    (the kernel's copies are 16 bytes). Runs on any device."""
    fn = "conv3x3_reflect_s8"
    _, h, wd, c = x.shape
    cout = w_q.shape[3]
    if c % K7_CHUNK or cout % K7_COUT_TILE or c > K7_MAX_C:
        raise ValueError(
            f"{fn}: the CUDA kernel needs C % {K7_CHUNK} == 0, C <= "
            f"{K7_MAX_C} and Cout % {K7_COUT_TILE} == 0, got C={c}, "
            f"Cout={cout}")
    if h < 2 or wd < 2:
        raise ValueError(f"{fn}: reflect pad needs H, W >= 2, got {h}x{wd}")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError(f"{fn}: the CUDA kernel needs 16-byte aligned x and "
                         "w_q")


def k7_weight(w_q: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand: the (3, 3, C, Cout) int8 weight as a K-major
    (Cout, 9·C) matrix, column (3·ky + kx)·C + c of row o = w_q[ky, kx, c,
    o] (``wgmma`` takes 8-bit operands K-major only)."""
    c, cout = w_q.shape[2], w_q.shape[3]
    return w_q.reshape(9 * c, cout).t().contiguous()


def _k7_kernel(x, wk, scale, b, norm, act_clip, out_dtype):
    """Launch K7 on x, its B operand (:func:`k7_weight` of w_q) and the
    combined f32 (Cout,) scale; returns ((N, H, W, Cout) ``out_dtype``,
    (N, 2, Cout) f32 [sum, sum²])."""
    n, h, wd, c = x.shape
    cout = wk.shape[0]
    bk = b.float().contiguous()
    nk = norm.float().contiguous() if norm is not None else None
    out = torch.empty((n, h, wd, cout), dtype=out_dtype, device=x.device)
    stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    in_kind = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}[x.dtype]
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_conv3x3_reflect_s8", x.data_ptr(), wk.data_ptr(),
            scale.data_ptr(), bk.data_ptr(),
            nk.data_ptr() if nk is not None else None, out.data_ptr(),
            stats.data_ptr(), n, h, wd, c, cout, in_kind,
            int(out_dtype == torch.bfloat16), 127.0 / act_clip,
            stream_ptr(x),
        )
    conv3x3_reflect_s8.launches += 1
    return out, stats


def conv3x3_reflect_s8(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    b: torch.Tensor, x_scale=None, norm: Optional[torch.Tensor] = None,
    act_clip: float = 8.0, out_dtype: torch.dtype = torch.bfloat16,
):
    """Reflect-padded 3×3 conv with int8 operands and int32 accumulation,
    plus the output's per-(sample, channel) statistics.

    Mode (i): ``x`` int8 (N, H, W, C) and ``x_scale`` its scalar scale (the
    pre-quantized trunk). Mode (ii): ``x`` f32/bf16 raw conv output and
    ``norm`` (N, 2, C) [mean, rstd]: the input is q = clamp(round(relu((x −
    mean)·rstd)·127/act_clip), 0, 127), the static scale of a unit-variance
    activation. ``w_q``: (3, 3, C, Cout) int8; ``w_scale``, ``b``: (Cout,).
    Returns (out (N, H, W, Cout) ``out_dtype`` = float(acc)·(w_scale ·
    act_scale) + b, stats (N, 2, Cout) f32 [sum, sum²] of the rounded out).
    """
    if not x.is_cuda:
        return conv3x3_reflect_s8_plain(x, w_q, w_scale, b, x_scale, norm,
                                        act_clip, out_dtype)
    _check_args(x, w_q, w_scale, b, x_scale, norm, out_dtype)
    same_device("conv3x3_reflect_s8", x, w_q, w_scale, b, norm)
    check_k7_kernel_limits(x, w_q)
    return _k7_kernel(x, k7_weight(w_q),
                      _combined_scale(w_scale, x_scale, act_clip), b, norm,
                      act_clip, out_dtype)


conv3x3_reflect_s8.launches = 0


def s8_chain_ok(shape) -> bool:
    if len(shape) != 4:
        return False
    _, h, wdim, c = shape
    return wdim % 128 == 0 and h % 2 == 0 and h >= 4 and c % 128 == 0


def fused_residual_chain_s8(x, qblocks, eps: float = 1e-5,
                            act_clip: float = 8.0):
    """The int8 residual body: per block, one plain pass (epilogue, trunk
    max-abs, quantize) and two K7 launches.

    ``qblocks``: list of (q1, s1, b1, q2, s2, b2): per-channel int8 weights
    (3, 3, C, Cout), scales and biases of both convs (``ops/quantize.py``
    layout). The trunk stays f32; its scale is max(max|x|, 1e-12) / 127 and
    it is quantized by a division, as JAX does."""
    hw = float(x.shape[1] * x.shape[2])
    x = x.float()
    for q1, s1, b1, q2, s2, b2 in qblocks:
        x_scale = torch.clamp_min(x.abs().amax(), 1e-12) / 127.0
        x_s8 = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
        h1, st1 = conv3x3_reflect_s8(x_s8, q1, s1, b1, x_scale=x_scale,
                                     act_clip=act_clip)
        h2, st2 = conv3x3_reflect_s8(h1, q2, s2, b2,
                                     norm=_stats_to_norm(st1, hw, eps),
                                     act_clip=act_clip)
        n2 = _stats_to_norm(st2, hw, eps)
        x = x + (h2.float() - n2[:, 0, None, None, :]) * n2[:, 1, None, None, :]
    return x
