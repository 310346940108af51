"""Fused 2× transposed conv (k3 s2 p1 op1) + InstanceNorm statistics (K2).

Replaces ``ctagan_tpu/ops/fused_convt.py::convt2x_stats`` (a Pallas TPU
kernel) with the CUDA kernel ``csrc/fused_convt.cu``: the generator's two
upsampling stages, 256 → 128 and 128 → 64 channels.

The transposed conv runs in phase form, with no dilated buffer: output
(2q+py, 2r+px) takes 1, 2, 2 or 4 taps of the input around (q, r), and the
input row/column q+1 past the bottom/right edge is the output-padding zero
(applied after the norm). What bounds it on the H100: arithmetic (~19 GFLOP
per 512² sample per stage) and, at up2, the 64-channel output writes. Each
block computes one phase of one tile, so its tap loop is uniform, and it
writes the spatial (N, 2H, 2W, Cout) tensor directly: the TPU kernel's
phase-blocked layout existed only because Mosaic could not interleave.
The previous InstanceNorm + ReLU fold into the input read, and the output's
[sum, sum²] over all four phases is reduced in the epilogue. f32 CUDA-core
FMAs in this first version.

The weight is PyTorch's ConvTranspose2d layout (C, Cout, kh, kw); the JAX
function takes (kh, kw, Cout, C). On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs :func:`convt2x_stats_plain`.
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


def _check_args(x, kernel_t, bias):
    check_input("convt2x_stats", x)
    c = x.shape[3]
    if kernel_t.dim() != 4 or kernel_t.shape[0] != c or tuple(
            kernel_t.shape[2:]) != (3, 3):
        raise ValueError(
            f"kernel_t must be (C={c}, Cout, 3, 3), got {tuple(kernel_t.shape)}"
        )
    check_bias("convt2x_stats", bias, kernel_t.shape[1])


def phase_deblock(pb: torch.Tensor, cout: int) -> torch.Tensor:
    """(N, H, W, 4·Cout) phase-blocked (the JAX kernel's output) ->
    (N, 2H, 2W, Cout): out[n, 2q+py, 2r+px, co] = pb[n, q, r,
    (2py+px)·Cout + co]."""
    n, h, w, _ = pb.shape
    y = pb.reshape(n, h, w, 2, 2, cout)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)


def convt2x_stats_plain(
    x: torch.Tensor, kernel_t: torch.Tensor, bias: torch.Tensor,
    norm: Optional[torch.Tensor] = None, relu: bool = False,
):
    """Plain PyTorch version of :func:`convt2x_stats`."""
    _check_args(x, kernel_t, bias)
    dt = x.dtype
    xs = apply_norm(x, norm, relu)
    y = F.conv_transpose2d(
        xs.float().permute(0, 3, 1, 2), kernel_t.to(dt).float(), bias.float(),
        stride=2, padding=1, output_padding=1,
    )
    return round_with_stats(y, dt)


def convt2x_stats(
    x: torch.Tensor, kernel_t: torch.Tensor, bias: torch.Tensor,
    norm: Optional[torch.Tensor] = None, relu: bool = False,
):
    """2× transposed conv (k3 s2 p1 op1) + output statistics.

    x: (N, H, W, C) f32 or bf16, contiguous; kernel_t: (C, Cout, 3, 3);
    bias: (Cout,). ``norm``/``relu``: the previous stage's (N, 2, C)
    [mean, rstd] (+ReLU) applied to the input as it is read. Returns
    ((N, 2H, 2W, Cout) in x.dtype, (N, 2, Cout) f32 [sum, sum²]).
    """
    if not x.is_cuda:
        return convt2x_stats_plain(x, kernel_t, bias, norm, relu)
    _check_args(x, kernel_t, bias)
    same_device("convt2x_stats", x, kernel_t, bias, norm)
    n, h, wd, c = x.shape
    cout = kernel_t.shape[1]
    check_kernel_shapes("convt2x_stats", x, c, cout, norm)
    dt = x.dtype
    # (C, Cout, kh, kw) -> (kh, kw, C, Cout), the kernels' weight layout
    wk = kernel_t.to(dt).permute(2, 3, 0, 1).contiguous()
    bk = bias.float().contiguous()
    nk = norm.float().contiguous() if norm is not None else None
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=dt, device=x.device)
    stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_convt2x_stats",
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(),
            nk.data_ptr() if nk is not None else None,
            out.data_ptr(), stats.data_ptr(),
            n, h, wd, c, cout, int(bool(relu and norm is not None)),
            int(dt == torch.bfloat16), stream_ptr(x),
        )
    convt2x_stats.launches += 1
    return out, stats


convt2x_stats.launches = 0
