"""Fused residual body: reflect 3×3 conv + InstanceNorm statistics (K1).

Replaces ``ctagan_tpu/ops/fused_resblock.py::conv3x3_reflect_stats`` (a
Pallas TPU kernel) with the CUDA kernel ``csrc/fused_resblock.cu``.

What bounds it on the H100: the residual body is 18 of these convs at
(N, 128, 128, 256) → 256, K = 9·256: ~19.3 GFLOP per sample each, well
above the card's ops-per-byte ridge, so it is bound by arithmetic. The
design keeps the norm plumbing off device memory instead: the previous
InstanceNorm's (mean, rstd), the ReLU and the previous block's skip-add are
applied as input tiles are staged in shared memory, and the output's
[sum, sum²] is reduced in the epilogue, so no standalone normalize pass
reads or writes the activation. This first version accumulates with f32
CUDA-core FMAs (no tensor cores), which caps it far below the bf16 peak:
``wgmma`` and TMA are later work.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`conv3x3_reflect_stats_plain`, the same function in plain
PyTorch, which is also the kernel's oracle on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import reflect_pad
from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops._common import (
    apply_norm,
    check_bias,
    check_input,
    check_kernel_shapes,
    round_with_stats,
    same_device,
    stream_ptr,
)


def _check_args(x, w, b, norm, skip, emit_input):
    check_input("conv3x3_reflect_stats", x)
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


def conv3x3_reflect_stats_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    norm: Optional[torch.Tensor] = None, relu: bool = False,
    skip: Optional[torch.Tensor] = None, emit_input: bool = False,
):
    """Plain PyTorch version of :func:`conv3x3_reflect_stats`: the same
    prologue, an f32 conv of the dtype-rounded operands, and stats of the
    dtype-rounded output."""
    _check_args(x, w, b, norm, skip, emit_input)
    dt = x.dtype
    xs = apply_norm(x, norm, relu)
    if skip is not None:
        xs = skip.to(dt) + xs  # normalize, cast, then add (JAX order)
    y = F.conv2d(
        reflect_pad(xs, 1).float().permute(0, 3, 1, 2),
        w.to(dt).float().permute(3, 2, 0, 1), b.float(),
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
    check_kernel_shapes("conv3x3_reflect_stats", x, c, cout, norm)
    dt = x.dtype
    if skip is not None:
        check_input("conv3x3_reflect_stats skip", skip)
        skip = skip.to(dt)
    wk = w.to(dt).contiguous()
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
            wk.data_ptr(), bk.data_ptr(),
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
