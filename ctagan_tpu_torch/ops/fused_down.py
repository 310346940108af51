"""Fused stride-2 3×3 conv (zero pad 1) + InstanceNorm statistics (K3).

Replaces ``ctagan_tpu/ops/fused_down.py::conv3x3_s2_zero_stats`` (a Pallas
TPU kernel) with the CUDA kernel ``csrc/fused_down.cu``: the generator's two
downsampling stages, 64 → 128 and 128 → 256 channels.

What bounds it on the H100: arithmetic in f32 (19.33 GFLOP at the serving
path's N=2 down1, 0.117 ms for three TF32 products), bytes in bf16 (x and
the output, 0.030 ms). The kernel is K1's tensor-core implicit GEMM
(``csrc/conv_wgmma.cuh``, ``wgmma``) in its stride-2 mode: M = the output
pixels of one sample, N = Cout, K = 9·C; the B operand is the K-major
(Cout, 9·C) weight (:func:`~ctagan_tpu_torch.ops.fused_resblock.k1_weight`,
bf16 or the TF32 hi/lo pair); f32 is 3xTF32 with per-chunk sums added in
f32, K1's grade. The previous InstanceNorm + ReLU are applied as the
threads stage the activations, the zero pad in the post-norm domain (a
source pixel outside the image stages 0, not the norm of 0), and the
output's [sum, sum²] is reduced in the epilogue, so the normalized
activation is never written to device memory. The TPU version's packed
(H/2, 2, W/2, 2C) view and [zero|kw0|kw1|kw2] weight existed for the MXU's
lane tiling and are not carried over: the kernel indexes the stride-2 taps
directly.

On a CUDA tensor the wrapper launches the kernel or raises
(:func:`check_k3_kernel_limits`); on a CPU tensor it runs
:func:`conv3x3_s2_zero_stats_plain`, which is also the kernel's oracle on
the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops._common import (
    apply_norm,
    check_bias,
    check_input,
    round_with_stats,
    same_device,
    stream_ptr,
)
from ctagan_tpu_torch.ops.fused_resblock import (
    check_k1_kernel_limits,
    k1_weight,
)


def _check_args(x, w, b):
    check_input("conv3x3_s2_zero_stats", x)
    n, h, wd, c = x.shape
    if h % 2 or wd % 2:
        raise ValueError(f"H and W must be even, got {h}x{wd}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, Cout), got {tuple(w.shape)}")
    check_bias("conv3x3_s2_zero_stats", b, w.shape[3])


def conv3x3_s2_zero_stats_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    norm: Optional[torch.Tensor] = None, relu: bool = False,
):
    """Plain PyTorch version of :func:`conv3x3_s2_zero_stats`."""
    _check_args(x, w, b)
    dt = x.dtype
    xs = apply_norm(x, norm, relu)
    y = F.conv2d(
        xs.float().permute(0, 3, 1, 2), w.to(dt).float().permute(3, 2, 0, 1),
        b.float(), stride=2, padding=1,
    )
    return round_with_stats(y, dt)


def check_k3_kernel_limits(x: torch.Tensor, cout: int,
                           norm: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError for what the CUDA kernel cannot take: K1's limits
    (C % 64, C <= 2048, Cout % 128, a (N, 2, C) norm, x on a 16-byte
    boundary) and H, W even and >= 2. Runs on any device."""
    h, wd = x.shape[1], x.shape[2]
    if h % 2 or wd % 2 or h < 2 or wd < 2:
        raise ValueError(f"conv3x3_s2_zero_stats: the CUDA kernel needs even "
                         f"H, W >= 2, got {h}x{wd}")
    check_k1_kernel_limits(x, cout, norm, fn="conv3x3_s2_zero_stats")


def _k3_kernel(x, whi, wlo, b, norm, relu):
    """Launch K3 on x and its B operand (:func:`k1_weight` of w); returns
    ((N, H/2, W/2, Cout) in x.dtype, (N, 2, Cout) f32 [sum, sum²])."""
    n, h, wd, c = x.shape
    cout = whi.shape[0]
    bk = b.float().contiguous()
    nk = norm.float().contiguous() if norm is not None else None
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=x.dtype,
                      device=x.device)
    stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_conv3x3_s2_zero_stats",
            x.data_ptr(), whi.data_ptr(),
            wlo.data_ptr() if wlo is not None else None, bk.data_ptr(),
            nk.data_ptr() if nk is not None else None,
            out.data_ptr(), stats.data_ptr(),
            n, h, wd, c, cout, int(bool(relu and norm is not None)),
            int(x.dtype == torch.bfloat16), stream_ptr(x),
        )
    conv3x3_s2_zero_stats.launches += 1
    return out, stats


def conv3x3_s2_zero_stats(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    norm: Optional[torch.Tensor] = None, relu: bool = False,
):
    """Stride-2 3×3 conv (zero pad 1) + per-(sample, channel) output stats.

    x: (N, H, W, C) f32 or bf16, contiguous, H and W even; w: (3, 3, C,
    Cout); b: (Cout,). ``norm``: optional (N, 2, C) f32 [mean, rstd]
    (+``relu``) applied to the input as it is read. Returns ((N, H/2, W/2,
    Cout) in x.dtype, (N, 2, Cout) f32 [sum, sum²]).
    """
    if not x.is_cuda:
        return conv3x3_s2_zero_stats_plain(x, w, b, norm, relu)
    _check_args(x, w, b)
    same_device("conv3x3_s2_zero_stats", x, w, b, norm)
    check_k3_kernel_limits(x, w.shape[3], norm)
    whi, wlo = k1_weight(w, x.dtype)
    return _k3_kernel(x, whi, wlo, b, norm, relu)


conv3x3_s2_zero_stats.launches = 0
