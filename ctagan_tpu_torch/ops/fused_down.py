"""Fused stride-2 3×3 conv (zero pad 1) + InstanceNorm statistics (K3).

Replaces ``ctagan_tpu/ops/fused_down.py::conv3x3_s2_zero_stats`` (a Pallas
TPU kernel) with the CUDA kernel ``csrc/fused_down.cu``: the generator's two
downsampling stages, 64 → 128 and 128 → 256 channels.

What bounds it on the H100: arithmetic (~4.8 GFLOP per 512² sample per
stage, K = 9·C), with the input read once per tap from L2. The design folds
the previous InstanceNorm + ReLU into the input read, applies the zero pad
in the post-norm domain (the conv's input is the normalized activation) and
reduces the output's [sum, sum²] in the epilogue, so the normalized
activation is never written to device memory. The TPU version's packed
(H/2, 2, W/2, 2C) view and [zero|kw0|kw1|kw2] weight existed for the MXU's
lane tiling and are not carried over: the CUDA kernel indexes the stride-2
taps directly. f32 CUDA-core FMAs in this first version.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`conv3x3_s2_zero_stats_plain`.
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
    check_kernel_shapes,
    round_with_stats,
    same_device,
    stream_ptr,
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
    n, h, wd, c = x.shape
    cout = w.shape[3]
    check_kernel_shapes("conv3x3_s2_zero_stats", x, c, cout, norm)
    dt = x.dtype
    wk = w.to(dt).contiguous()
    bk = b.float().contiguous()
    nk = norm.float().contiguous() if norm is not None else None
    out = torch.empty((n, h // 2, wd // 2, cout), dtype=dt, device=x.device)
    stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_conv3x3_s2_zero_stats",
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(),
            nk.data_ptr() if nk is not None else None,
            out.data_ptr(), stats.data_ptr(),
            n, h, wd, c, cout, int(bool(relu and norm is not None)),
            int(dt == torch.bfloat16), stream_ptr(x),
        )
    conv3x3_s2_zero_stats.launches += 1
    return out, stats


conv3x3_s2_zero_stats.launches = 0
