"""Fused residual body: reflect 3×3 conv + InstanceNorm statistics (K1).

Replaces ``ctagan_tpu/ops/fused_resblock.py::conv3x3_reflect_stats`` (a
Pallas TPU kernel) with the CUDA kernel ``csrc/fused_resblock.cu`` (its
body, shared with K4 and K3, in ``csrc/conv_wgmma.cuh``).

What bounds it on the H100: the residual body is 18 of these convs at
(N, 128, 128, 256) → 256, K = 9·256: ~19.3 GFLOP per sample each, well
above the card's ops-per-byte ridge, so it is bound by arithmetic. The
kernel is an implicit GEMM on the tensor cores (``wgmma``: bf16 or TF32
operands, f32 accumulator) that keeps the norm plumbing off device memory:
the previous InstanceNorm's (mean, rstd), the ReLU and the previous
block's skip-add are applied as the threads stage the activation tiles in
shared memory, and the output's [sum, sum²] is reduced in the epilogue, so
no standalone normalize pass reads or writes the activation. f32 I/O is
3xTF32: each operand is split into TF32 hi + lo (:func:`split_tf32`), the
three products lo·hi + hi·lo + hi·hi of each K chunk are summed on the
tensor cores, and the chunk sums are added in f32 with rounding to nearest
(the tensor cores' own accumulator truncates): an f32-grade result. One
TF32 pass (~3e-4 of the output's scale at K = 2304) misses the f32
tolerance of 1e-4; split-bf16 products, or one tensor-core accumulator over
all of K (~1e-5), meet it but leave the generator's gradients over twice as
far from float64 as the plain route's.

On a CUDA tensor the wrapper launches the kernel or raises
(:func:`check_k1_kernel_limits`); on a CPU tensor it runs
:func:`conv3x3_reflect_stats_plain`, the same function in plain PyTorch,
which is also the kernel's oracle on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import reflect_pad
from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops._common import (
    DTYPES,
    PLAIN_DTYPES,
    acc_dtype,
    apply_norm,
    check_bias,
    check_input,
    round_with_stats,
    same_device,
    stream_ptr,
)


def _check_args(x, w, b, norm, skip, emit_input, dtypes=DTYPES):
    check_input("conv3x3_reflect_stats", x, dtypes=dtypes)
    n, h, wd, c = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, Cout), got {tuple(w.shape)}")
    check_bias("conv3x3_reflect_stats", b, w.shape[3])
    if h < 2 or wd < 2:
        raise ValueError(f"reflect pad needs H, W >= 2, got {h}x{wd}")
    if skip is not None:
        if norm is None:
            raise ValueError("skip requires norm")
        if skip.shape != x.shape:
            raise ValueError("skip must match x's shape")
    if emit_input and (norm is None or skip is not None):
        raise ValueError("emit_input requires norm and no skip")


# the kernel's tiles: 128-byte K chunks (64 bf16 or 32 f32 channels),
# 128- or 256-channel output tiles; its shared memory holds the (2, C) norm
# beside the operand stages
K1_CHUNK, K1_COUT_TILE, K1_MAX_C = 64, 128, 2048


def check_k1_kernel_limits(x: torch.Tensor, cout: int,
                           norm: Optional[torch.Tensor] = None,
                           *tensors: Optional[torch.Tensor],
                           fn: str = "conv3x3_reflect_stats",
                           cout_tile: int = K1_COUT_TILE) -> None:
    """Raise ValueError for what the CUDA kernel cannot take: C % 64,
    Cout % 128, C > 2048, a norm that is not (N, 2, C), or x (or one of
    ``tensors``) not on a 16-byte boundary (the kernel's loads and stores
    are 16 bytes). Runs on any device. ``fn`` names the caller in the
    message (K3 and K2 run the same body); ``cout_tile`` is the narrowest
    output tile the caller's mode has (K2's is 64)."""
    c = x.shape[3]
    if c % K1_CHUNK or cout % cout_tile or c > K1_MAX_C:
        raise ValueError(
            f"{fn}: the CUDA kernel needs C % {K1_CHUNK} == 0, C <= "
            f"{K1_MAX_C} and Cout % {cout_tile} == 0, got C={c}, "
            f"Cout={cout}")
    if norm is not None and tuple(norm.shape) != (x.shape[0], 2, c):
        raise ValueError(f"{fn}: norm must be (N, 2, C), got "
                         f"{tuple(norm.shape)}")
    for t in (x,) + tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{fn}: the CUDA kernel needs 16-byte aligned "
                             "tensors")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10-bit mantissa, to nearest, ties away
    from zero), kept in f32: the kernel's ``cvt.rna.tf32.f32``."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """f32 → (hi, lo), TF32 values in f32 with hi = tf32(t) and
    lo = tf32(t − hi), so hi + lo is t to within 2⁻²¹ of |t|: the kernel's
    f32 route multiplies the parts on the TF32 tensor cores (3xTF32)."""
    hi = round_tf32(t)
    return hi, round_tf32(t.float() - hi)


def k1_weight(w: torch.Tensor, dtype: torch.dtype):
    """The kernel's B operand: the (3, 3, C, Cout) weight as a K-major
    (Cout, 9·C) matrix, K = (tap, channel): bf16 for bf16 I/O (w, None),
    the :func:`split_tf32` (hi, lo) for f32."""
    wt = w.permute(3, 0, 1, 2).reshape(w.shape[3], -1)
    if dtype == torch.bfloat16:
        return wt.to(torch.bfloat16).contiguous(), None
    return split_tf32(wt)


def conv3x3_reflect_stats_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    norm: Optional[torch.Tensor] = None, relu: bool = False,
    skip: Optional[torch.Tensor] = None, emit_input: bool = False,
):
    """Plain PyTorch version of :func:`conv3x3_reflect_stats`: the same
    prologue, an f32 conv of the dtype-rounded operands (f64 for f64
    input), and stats of the dtype-rounded output."""
    _check_args(x, w, b, norm, skip, emit_input, PLAIN_DTYPES)
    dt = x.dtype
    ad = acc_dtype(dt)
    xs = apply_norm(x, norm, relu)
    if skip is not None:
        xs = skip.to(dt) + xs  # normalize, cast, then add (JAX order)
    y = F.conv2d(
        reflect_pad(xs, 1).to(ad).permute(0, 3, 1, 2),
        w.to(dt).to(ad).permute(3, 2, 0, 1), b.to(ad),
    )
    out, stats = round_with_stats(y, dt)
    if skip is not None or emit_input:
        return out, stats, xs.contiguous()
    return out, stats


def conv3x3_reflect_stats(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    norm: Optional[torch.Tensor] = None, relu: bool = False,
    skip: Optional[torch.Tensor] = None, emit_input: bool = False,
):
    """Reflect-padded 3×3 conv + per-(sample, channel) output statistics.

    x: (N, H, W, C) f32 or bf16, contiguous; w: (3, 3, C, Cout); b: (Cout,).
    ``norm``: optional (N, 2, C) f32 [mean, rstd] applied (with optional
    ``relu``) to the input as it is read. ``skip``: optional (N, H, W, C)
    residual stream (requires ``norm``): the conv input is x_new = skip +
    cast(norm(x)), returned as a third output. ``emit_input`` (requires
    ``norm``, no skip): return the normalized conv input as the third output.
    Returns (out (N, H, W, Cout) in x.dtype, stats (N, 2, Cout) f32
    [sum, sum²] of the rounded output[, x_new]).
    """
    if not x.is_cuda:
        return conv3x3_reflect_stats_plain(x, w, b, norm, relu, skip,
                                           emit_input)
    _check_args(x, w, b, norm, skip, emit_input)
    same_device("conv3x3_reflect_stats", x, w, b, norm, skip)
    n, h, wd, c = x.shape
    cout = w.shape[3]
    dt = x.dtype
    if skip is not None:
        check_input("conv3x3_reflect_stats skip", skip)
        skip = skip.to(dt)
    check_k1_kernel_limits(x, cout, norm, skip)
    whi, wlo = k1_weight(w, dt)
    bk = b.float().contiguous()
    nk = norm.float().contiguous() if norm is not None else None
    out = torch.empty((n, h, wd, cout), dtype=dt, device=x.device)
    stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    xnew = (torch.empty_like(x) if (skip is not None or emit_input)
            else None)
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_conv3x3_reflect_stats",
            x.data_ptr(), skip.data_ptr() if skip is not None else None,
            whi.data_ptr(), wlo.data_ptr() if wlo is not None else None,
            bk.data_ptr(),
            nk.data_ptr() if nk is not None else None,
            out.data_ptr(), stats.data_ptr(),
            xnew.data_ptr() if xnew is not None else None,
            n, h, wd, c, cout, int(bool(relu and norm is not None)),
            int(dt == torch.bfloat16), stream_ptr(x),
        )
    conv3x3_reflect_stats.launches += 1
    if xnew is not None:
        return out, stats, xnew
    return out, stats


conv3x3_reflect_stats.launches = 0


def _stats_to_norm(stats: torch.Tensor, count: float,
                   eps: float) -> torch.Tensor:
    """(N, 2, C) [sum, sum²] -> (N, 2, C) [mean, rstd]; the clamped one-pass
    variance of models.layers.instance_norm."""
    mean = stats[:, 0] / count
    var = torch.clamp(stats[:, 1] / count - mean * mean, min=0.0)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def fused_residual_block(x, k1, b1, k2, b2, eps: float = 1e-5):
    """x + IN(conv2(relu(IN(conv1(x))))) through two K1 launches; only the
    final skip-add runs as plain tensor ops."""
    hw = float(x.shape[1] * x.shape[2])
    h1, s1 = conv3x3_reflect_stats(x, k1, b1)
    h2, s2 = conv3x3_reflect_stats(h1, k2, b2,
                                   norm=_stats_to_norm(s1, hw, eps),
                                   relu=True)
    return x + apply_norm(h2, _stats_to_norm(s2, hw, eps))


def fused_residual_chain(x, block_params, eps: float = 1e-5,
                         in_norm=None, in_relu: bool = False):
    """The generator's residual body as a chain of K1 launches.

    ``block_params``: list of (k1, b1, k2, b2) per block, kernels in
    (3, 3, C, Cout). Block i's epilogue x_{i+1} = x_i + norm(h2_i) folds into
    block i+1's first conv (the ``skip`` stream), which emits x_{i+1}; only
    the last block's epilogue runs as plain tensor ops. ``in_norm`` /
    ``in_relu``: the upstream stage's raw output + (N, 2, C) [mean, rstd],
    folded into block 0's first conv, which emits the block input x_0.
    """
    if not block_params:
        return apply_norm(x, in_norm, in_relu)
    hw = float(x.shape[1] * x.shape[2])
    h2 = s2 = None
    for i, (k1, b1, k2, b2) in enumerate(block_params):
        if i == 0:
            if in_norm is not None:
                h1, s1, x = conv3x3_reflect_stats(
                    x, k1, b1, norm=in_norm, relu=in_relu, emit_input=True)
            else:
                h1, s1 = conv3x3_reflect_stats(x, k1, b1)
        else:
            h1, s1, x = conv3x3_reflect_stats(
                h2, k1, b1, norm=_stats_to_norm(s2, hw, eps), skip=x)
        h2, s2 = conv3x3_reflect_stats(
            h1, k2, b2, norm=_stats_to_norm(s1, hw, eps), relu=True)
    return x + apply_norm(h2, _stats_to_norm(s2, hw, eps))
