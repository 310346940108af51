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


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The statistics / accumulation type: f32 for f32 and bf16, f64 for f64
    (so gradient checks in float64 see no f32 rounding)."""
    return torch.promote_types(dtype, torch.float32)


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2, C) f32 [sum, sum²] over H, W."""
    xf = x.to(acc_dtype(x.dtype))
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1)


# When True, instance_norm runs the fused InstanceNorm kernel K6
# (ops.pallas_kernels.instance_norm_pallas) where JAX's gate admits the shape
# (H % 16 == 0 and W >= 128), as ``ctagan_tpu/models/layers.py``'s switch of
# the same name. K6 has no backward: an input that requires grad raises.
USE_PALLAS_INSTANCE_NORM = False


def pallas_norm_applies(x: torch.Tensor) -> bool:
    """Whether instance_norm takes K6 for ``x``: the switch and JAX's gate."""
    return (USE_PALLAS_INSTANCE_NORM and x.shape[1] % 16 == 0
            and x.shape[2] >= 128)


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  activation: Optional[str] = None) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over H, W with the JAX package's one-pass
    clamped f32 statistics, var = max(E[x²] − E[x]², 0), cast back to
    x.dtype (``F.instance_norm`` takes two passes and rounds differently),
    then ``activation`` (None or ``"relu"``). With the switch
    :data:`USE_PALLAS_INSTANCE_NORM` on, a shape JAX's gate admits goes
    through :func:`~ctagan_tpu_torch.ops.pallas_kernels.instance_norm_pallas`
    (K6) with the activation fused."""
    if activation not in (None, "relu"):
        raise ValueError(f"activation must be None or 'relu', got "
                         f"{activation!r}")
    if pallas_norm_applies(x):
        from ctagan_tpu_torch.ops.pallas_kernels import instance_norm_pallas

        return instance_norm_pallas(x, eps=eps, activation=activation)
    xf = x.to(acc_dtype(x.dtype))
    mean = xf.mean(dim=(1, 2), keepdim=True)
    m2 = (xf * xf).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return torch.relu(out) if activation == "relu" else out


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


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping max pool (torch MaxPool2d(window)) as a reshape + axis
    max, as ``ctagan_tpu/models/layers.py::max_pool``: tied maxima share the
    gradient (``amax``), where ``F.max_pool2d`` routes it to one of them."""
    n, h, w, c = x.shape
    if h % window or w % window:
        x = x[:, : h - h % window, : w - w % window]
        h, w = x.shape[1], x.shape[2]
    xr = x.reshape(n, h // window, window, w // window, window, c)
    return xr.amax(dim=(2, 4))


def global_avg_pool_logit(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d over the full spatial extent -> (N, C)."""
    return x.mean(dim=(1, 2))


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


class _RegConv2d(ConvTorch):
    """The registration net's conv: kaiming-normal (fan_in, gain² =
    2 / (1 + slope²)) or near-zero N(0, 1e-5) weights, zero bias."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0,
                 slope: float = 0.0, zero_init: bool = False, dtype=None):
        super().__init__(cin, cout, kernel_size, stride, padding, dtype)
        self.slope, self.zero_init = slope, zero_init

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        std = 1e-5 if self.zero_init else math.sqrt(
            2.0 / (1.0 + self.slope ** 2) / fan_in)
        _normal_(self.weight, std, gen)
        with torch.no_grad():
            self.bias.zero_()


class RegResnetBlock(nn.Module):
    """``ctagan_tpu/models/layers.py::RegResnetBlock``: reflect 3×3 conv + IN
    + ReLU + reflect 3×3 conv + IN, additive skip; kaiming init, zero bias.
    ``conv_block`` indices 1 and 5 as the reference's."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_block = nn.Sequential(
            ReflectPad(1), _RegConv2d(features, features, 3, dtype=dtype),
            InstanceNorm(), nn.ReLU(),
            ReflectPad(1), _RegConv2d(features, features, 3, dtype=dtype),
            InstanceNorm(),
        )

    def forward(self, x):
        return x + self.conv_block(x)


class RegResnetStack(nn.Module):
    """``model``: a Sequential of RegResnetBlocks (the reference's
    ``ResnetTransformer`` key layout, ``<name>.model.<i>.conv_block``)."""

    def __init__(self, features: int, n_blocks: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model = nn.Sequential(*[RegResnetBlock(features, dtype)
                                     for _ in range(n_blocks)])

    def forward(self, x):
        return self.model(x)


class RegConv(nn.Module):
    """``ctagan_tpu/models/layers.py::RegConv``: conv (no norm) -> activation
    -> optional single resnet block; kaiming init, zero bias. Keys
    ``conv2d`` and ``resnet_block.model.0`` as the reference's. The TPU
    routes ``taps`` and ``im2col`` are not ported (ROADMAP queue 1)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1,
                 activation: Optional[str] = "leaky_relu",
                 use_resnet: bool = False, zero_init: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if activation not in ("leaky_relu", None):
            raise ValueError(f"RegConv activation {activation!r}: the "
                             "RegNet uses 'leaky_relu' or None")
        slope = 0.2 if activation == "leaky_relu" else 0.0
        self.activation = activation
        self.conv2d = _RegConv2d(cin, features, kernel_size, stride, padding,
                                 slope=slope, zero_init=zero_init, dtype=dtype)
        self.resnet_block = (RegResnetStack(features, 1, dtype)
                             if use_resnet else None)

    def forward(self, x):
        x = self.conv2d(x)
        if self.activation == "leaky_relu":
            x = leaky_relu(x, 0.2)
        if self.resnet_block is not None:
            x = self.resnet_block(x)
        return x
