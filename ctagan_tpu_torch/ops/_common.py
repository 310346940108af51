"""Argument checks and plain-version helpers shared by the kernel wrappers."""
from __future__ import annotations

from typing import Optional

import torch

from ctagan_tpu_torch.models.layers import acc_dtype, channel_stats

DTYPES = (torch.float32, torch.bfloat16)
# the plain versions also take float64, for gradient checks
PLAIN_DTYPES = DTYPES + (torch.float64,)


def check_input(name: str, x: torch.Tensor, ndim: int = 4,
                dtypes=DTYPES) -> None:
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} is not one of {dtypes}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def check_bias(fn: str, b: torch.Tensor, cout: int) -> None:
    """A (Cout,) bias, on both the plain and the kernel path (the kernel
    reads Cout entries)."""
    if tuple(b.shape) != (cout,):
        raise ValueError(f"{fn}: bias must be ({cout},), got {tuple(b.shape)}")


def same_device(fn: str, x: torch.Tensor, *others) -> None:
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{fn}: tensors on {x.device} and {t.device}")


def apply_norm(x: torch.Tensor, norm: Optional[torch.Tensor],
               relu: bool = False) -> torch.Tensor:
    """cast((x − mean)·rstd [, relu]) computed in f32 (f64 for f64 input)
    and rounded back to x.dtype, with ``norm`` (N, 2, C) [mean, rstd]: the
    kernels' input prologue and the residual/up-path epilogues. No norm: x
    unchanged."""
    if norm is None:
        return x
    ad = acc_dtype(x.dtype)
    nf = norm.to(ad)
    xn = (x.to(ad) - nf[:, 0, None, None, :]) * nf[:, 1, None, None, :]
    if relu:
        xn = torch.relu(xn)
    return xn.to(x.dtype)


def round_with_stats(out_f32: torch.Tensor, dtype: torch.dtype):
    """Round an f32 (f64) NCHW conv result to ``dtype`` as NHWC, and return
    it with the f32 (f64) (N, 2, C) [sum, sum²] of the rounded values."""
    out = out_f32.permute(0, 2, 3, 1).to(dtype).contiguous()
    return out, channel_stats(out)


def stream_ptr(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
