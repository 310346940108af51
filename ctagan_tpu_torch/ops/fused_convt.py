"""Fused 2× transposed conv (k3 s2 p1 op1) + InstanceNorm statistics (K2).

Replaces ``ctagan_tpu/ops/fused_convt.py::convt2x_stats`` (a Pallas TPU
kernel) with the CUDA kernel ``csrc/fused_convt.cu``: the generator's two
upsampling stages, 256 → 128 and 128 → 64 channels.

The transposed conv runs in phase form, with no dilated buffer: output
(2q+py, 2r+px) takes 1, 2, 2 or 4 taps of the input around (q, r), and the
input row/column q+1 past the bottom/right edge is the output-padding zero
(applied after the norm). What bounds it on the H100: arithmetic, 19.33
GFLOP per N=2 call at either stage, 0.117 ms for three TF32 products in
f32 and 0.020 ms in bf16. The kernel is K1's tensor-core implicit GEMM
(``csrc/conv_wgmma.cuh``, ``wgmma``) in its phase mode: one output phase
per block, M = 128 input positions of one sample, N = Cout, K = the
phase's taps × C (at up2's Cout = 64 a block pairs the two column phases
of its row phase in one 128-column tile); the B operand is the K-major
(Cout, 9·C) weight (:func:`k2_weight`, bf16 or the TF32 hi/lo pair), f32
is 3xTF32 with per-chunk sums added in f32, K1's grade. The previous
InstanceNorm + ReLU are applied as the threads stage the activations, the
edge zero in the post-norm domain, and the output's [sum, sum²] over all
four phases is reduced in the epilogue. Each block writes its rows to their pixels of the
spatial (N, 2H, 2W, Cout) tensor: the TPU kernel's phase-blocked layout
existed only because Mosaic could not interleave.

The weight is PyTorch's ConvTranspose2d layout (C, Cout, kh, kw), which
needs no flip in phase form; the JAX function takes flax's (kh, kw, Cout,
C) and flips it. On a CUDA tensor the wrapper launches the kernel or
raises (:func:`check_k2_kernel_limits`); on a CPU tensor it runs
:func:`convt2x_stats_plain`, which is also the kernel's oracle on the card.
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


def check_k2_kernel_limits(x: torch.Tensor, cout: int,
                           norm: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError for what the CUDA kernel cannot take: C % 64,
    C <= 2048 (the norm is staged in shared memory), Cout % 64, a norm that
    is not (N, 2, C), or x not on a 16-byte boundary. Runs on any device."""
    check_k1_kernel_limits(x, cout, norm, fn="convt2x_stats", cout_tile=64)


def k2_weight(kernel_t: torch.Tensor, dtype: torch.dtype):
    """The kernel's B operand: :func:`k1_weight` of the (C, Cout, 3, 3)
    kernel_t as (3, 3, C, Cout), unflipped, so entry (o, (3 ky + kx)·C + c)
    is kernel_t[c, o, ky, kx]: bf16 (w, None), or the TF32 (hi, lo) for
    f32."""
    return k1_weight(kernel_t.permute(2, 3, 0, 1), dtype)


def _k2_kernel(x, whi, wlo, b, norm, relu):
    """Launch K2 on x and its B operand (:func:`k2_weight`); returns
    ((N, 2H, 2W, Cout) in x.dtype, (N, 2, Cout) f32 [sum, sum²])."""
    n, h, wd, c = x.shape
    cout = whi.shape[0]
    bk = b.float().contiguous()
    nk = norm.float().contiguous() if norm is not None else None
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=x.dtype,
                      device=x.device)
    stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_convt2x_stats",
            x.data_ptr(), whi.data_ptr(),
            wlo.data_ptr() if wlo is not None else None, bk.data_ptr(),
            nk.data_ptr() if nk is not None else None,
            out.data_ptr(), stats.data_ptr(),
            n, h, wd, c, cout, int(bool(relu and norm is not None)),
            int(x.dtype == torch.bfloat16), stream_ptr(x),
        )
    convt2x_stats.launches += 1
    return out, stats


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
    check_k2_kernel_limits(x, kernel_t.shape[1], norm)
    whi, wlo = k2_weight(kernel_t, x.dtype)
    return _k2_kernel(x, whi, wlo, bias, norm, relu)


convt2x_stats.launches = 0
