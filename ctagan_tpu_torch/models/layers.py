"""NHWC layer library of the port: the plain PyTorch path.

Counterpart of ``ctagan_tpu/models/layers.py``. Every module takes and returns
channels-last ``(N, H, W, C)`` tensors, as the JAX package does, and stores
its parameters in PyTorch's own layouts (``Conv2d`` weight ``(O, I, kh, kw)``,
``ConvTranspose2d`` weight ``(I, O, kh, kw)``) so reference ``.pth`` state
dicts load unchanged. ``dtype`` casts a conv's input and parameters (the
JAX ``dtype=`` compute type); InstanceNorm statistics are always f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d for NHWC input."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2, C) f32 [sum, sum²] over H, W."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over H, W with the JAX package's one-pass
    clamped f32 statistics, var = max(E[x²] − E[x]², 0), cast back to
    x.dtype (``F.instance_norm`` takes two passes and rounds differently)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    m2 = (xf * xf).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


class ReflectPad(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return reflect_pad(x, self.pad)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class ConvTorch(nn.Module):
    """Conv2d with PyTorch's default init and integer zero padding, NHWC."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # kaiming_uniform(a=sqrt(5)) and the bias rule both give
        # U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = I·kh·kw
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, gen)
        _uniform_(self.bias, bound, gen)

    def hwio(self) -> torch.Tensor:
        """The weight in the kernels' (kh, kw, I, O) layout."""
        return self.weight.permute(2, 3, 1, 0).contiguous()

    def forward(self, x):
        y = F.conv2d(
            _cast(x, self.dtype).permute(0, 3, 1, 2),
            _cast(self.weight, self.dtype), _cast(self.bias, self.dtype),
            stride=self.stride, padding=self.padding,
        )
        return y.permute(0, 2, 3, 1).contiguous()


class ConvTransposeTorch(nn.Module):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1), NHWC: doubles H, W
    (``ctagan_tpu/models/layers.py::ConvTransposeTorch``)."""

    def __init__(self, cin: int, cout: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # torch counts fan_in of a transposed conv as O·kh·kw
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, gen)
        _uniform_(self.bias, bound, gen)

    def forward(self, x):
        y = F.conv_transpose2d(
            _cast(x, self.dtype).permute(0, 3, 1, 2),
            _cast(self.weight, self.dtype), _cast(self.bias, self.dtype),
            stride=2, padding=1, output_padding=1,
        )
        return y.permute(0, 2, 3, 1).contiguous()


class ResidualBlock(nn.Module):
    """x + IN(conv(pad(relu(IN(conv(pad(x))))))); the reference's
    ``conv_block`` Sequential indices (convs at 1 and 5). ``pad_mode``
    'reflect' (reference) or 'zero' (the pad folds into the conv)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 pad_mode: str = "reflect"):
        super().__init__()
        zero = pad_mode == "zero"

        def pad_conv():
            return [nn.Identity() if zero else ReflectPad(1),
                    ConvTorch(features, features, 3, padding=int(zero),
                              dtype=dtype)]

        self.conv_block = nn.Sequential(
            *pad_conv(), InstanceNorm(), nn.ReLU(), *pad_conv(),
            InstanceNorm(),
        )

    def forward(self, x):
        return x + self.conv_block(x)
