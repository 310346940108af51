"""The 3-D model family of the port (``ctagan_tpu/models/volumetric.py``):
patch-based volume-to-volume synthesis for the P3d trainer.

- :func:`instance_norm3d`: InstanceNorm3d(affine=False) with JAX's two-pass
  variance (``jnp.var``, unlike the 2-D one-pass clamped form) and f32
  statistics for bf16 activations (f64 for f64).
- :class:`Generator3D`: c3s1 head (3, 7, 7), two stride-(ds, 2, 2) downs,
  ``n_residual_blocks`` 3-D residual blocks, two transposed-conv ups and a
  (3, 7, 7) tail + tanh. Every conv pads with zeros (flax ``nn.Conv``
  padding); there is no reflection anywhere in the family.
- :class:`Discriminator3D`: a 3-D PatchGAN, its map averaged to a scalar
  logit (N, 1).

The public tensors are NDHWC ``(N, D, H, W, C)``, as in JAX. Inside, the
input is laid out NCDHW in ``channels_last_3d`` strides (NDHWC memory),
and so are the conv weights, so every ``F.conv3d`` / ``F.conv_transpose3d``
and norm works on channels-last memory (cuDNN's NDHWC kernels on the card),
and one permute at the end returns NDHWC. The 3-D convs are
cuDNN's: JAX computes them outside any Pallas kernel, so no hand kernel is
on this path. ``dtype`` casts a conv's input and parameters, as the JAX
modules' ``dtype``. Parameter names: ``head``, ``down.{0,1}``,
``body.{i}.conv{1,2}``, ``up.{0,1}``, ``tail`` (G) and ``convs.{0..4}``
(D), each with ``weight`` in torch's layout and ``bias``
(``models/convert.py`` maps JAX's trees onto them).

The depth plan's context (``models/layers.py::sp_scope``, set by
``parallel/volume.py``): while it is set, the D axis of every tensor is a
slab of a larger volume. :func:`instance_norm3d` then asks it for the
statistics over the whole volume (``norm3d``); with a context that
exchanges slices (training) every conv asks it for the slices its window
reaches beyond the slab (``conv3d``, ``conv_transpose3d``) and D's logit
for the mean over the whole volume (``pool_logit3d``). Under the sharded
inference's context (which exchanges nothing) ``Generator3D`` refuses a
depth stride, as JAX's does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ctagan_tpu_torch.models.layers import (
    _cast,
    _uniform_,
    acc_dtype,
    sp_context,
    sp_rows,
)

EPS = 1e-5


def instance_norm3d(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Per-(sample, channel) normalisation over (D, H, W) of an NCDHW
    tensor: two passes (mean, then the mean of squared deviations), the
    statistics in f32 for f32/bf16 input and f64 for f64, cast back; under
    the depth plan's context over the whole volume of the slabs."""
    ctx = sp_context()
    if ctx is not None:
        return ctx.norm3d(x, eps)
    xf = x.to(acc_dtype(x.dtype))
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=(2, 3, 4), keepdim=True)
    return (d * torch.rsqrt(var + eps)).to(x.dtype)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


class Conv3dTorch(nn.Module):
    """Conv3d on NCDHW with zero padding and PyTorch's default init."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), stride=1,
                 padding=1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.padding = _triple(stride), _triple(padding)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, *_triple(kernel)))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        x, w = _cast(x, self.dtype), _cl(_cast(self.weight, self.dtype))
        b, ctx = _cast(self.bias, self.dtype), sp_rows()
        if ctx is not None:  # a slab: the slices beyond it from its neighbours
            return ctx.conv3d(x, w, b, self.stride, self.padding)
        return F.conv3d(x, w, b, stride=self.stride, padding=self.padding)


class ConvTranspose3dTorch(nn.Module):
    """The up path's 3×3×3 transposed conv, stride (ds, 2, 2), on NCDHW:
    flax's ``ConvTranspose(transpose_kernel=True)`` with padding
    [(1, ds), (1, 2), (1, 2)] is torch's ``padding=1, output_padding=(ds −
    1, 1, 1)``, which doubles H and W and multiplies D by ds."""

    def __init__(self, cin: int, cout: int, depth_stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = (depth_stride, 2, 2)
        self.output_padding = (depth_stride - 1, 1, 1)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        x, w = _cast(x, self.dtype), _cl(_cast(self.weight, self.dtype))
        b, ctx = _cast(self.bias, self.dtype), sp_rows()
        if ctx is not None:
            return ctx.conv_transpose3d(x, w, b, self.stride,
                                        self.output_padding)
        return F.conv_transpose3d(x, w, b, stride=self.stride, padding=1,
                                  output_padding=self.output_padding)


def _reset(module: nn.Module, seed: int) -> nn.Module:
    """Seeded PyTorch-default init of every conv, in module order: U(±1 /
    sqrt(fan_in)) for weight and bias, fan_in = weight[0].numel() (a
    transposed conv's is Cout·k³, as torch counts it)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (Conv3dTorch, ConvTranspose3dTorch)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            _uniform_(m.weight, bound, gen)
            _uniform_(m.bias, bound, gen)
    return module


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """NDHWC -> NCDHW in ``channels_last_3d`` strides, copied (a few MB at
    the net's input): with one channel several stride patterns pass for
    both layouts, and the layout picks the convs' algorithms, and so their
    bf16 roundings, so the copy fixes it whatever the caller's strides."""
    return x.permute(0, 4, 1, 2, 3).clone(
        memory_format=torch.channels_last_3d)


def _cl(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous(memory_format=torch.channels_last_3d)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


class ResidualBlock3D(nn.Module):
    """x + IN(conv2(relu(IN(conv1(x))))), 3×3×3 zero-padded convs."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv3dTorch(features, features, dtype=dtype)
        self.conv2 = Conv3dTorch(features, features, dtype=dtype)

    def forward(self, x):
        h = torch.relu(instance_norm3d(self.conv1(x)))
        return x + instance_norm3d(self.conv2(h))


class Generator3D(nn.Module):
    """NDHWC volume-to-volume generator, (N, D, H, W, input_nc) ->
    (N, D, H, W, output_nc) in [-1, 1]. ``depth_strides`` sets the depth
    stride of the two downs (mirrored by the ups): (1, 1) keeps the depth
    (config ``depth_downsample`` 1), (1, 2) and (2, 2) halve or quarter it
    in the body (2 and 4)."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 n_residual_blocks: int = 6, base_features: int = 32,
                 depth_strides: Sequence[int] = (1, 1),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = base_features
        self.depth_strides = tuple(depth_strides)
        self.head = Conv3dTorch(input_nc, f, (3, 7, 7), padding=(1, 3, 3),
                                dtype=dtype)
        self.down = nn.ModuleList(
            Conv3dTorch(f * cin, f * cout, stride=(ds, 2, 2), dtype=dtype)
            for (cin, cout), ds in zip(((1, 2), (2, 4)), self.depth_strides))
        self.body = nn.ModuleList(ResidualBlock3D(4 * f, dtype=dtype)
                                  for _ in range(n_residual_blocks))
        self.up = nn.ModuleList(
            ConvTranspose3dTorch(f * cin, f * cout, ds, dtype=dtype)
            for (cin, cout), ds in zip(((4, 2), (2, 1)),
                                       self.depth_strides[::-1]))
        self.tail = Conv3dTorch(f, output_nc, (3, 7, 7), padding=(1, 3, 3),
                                dtype=dtype)

    def reset_parameters(self, seed: int) -> "Generator3D":
        """Seeded PyTorch-default init of every conv, in module order."""
        return _reset(self, seed)

    def forward(self, x: torch.Tensor, fused_body=None) -> torch.Tensor:
        """``fused_body`` is accepted for the trainers' eval call and
        ignored: no kernel route exists in 3-D (JAX's ``g_eval`` keeps the
        training model for this family)."""
        ctx = sp_context()
        if ctx is not None and not ctx.exchanges \
                and self.depth_strides != (1, 1):
            raise ValueError(
                "depth-halo sharding requires depth_strides=(1, 1)")
        h = torch.relu(instance_norm3d(self.head(_ncdhw(x))))
        for conv in self.down:
            h = torch.relu(instance_norm3d(conv(h)))
        for blk in self.body:
            h = blk(h)
        for conv in self.up:
            h = torch.relu(instance_norm3d(conv(h)))
        return _ndhwc(torch.tanh(self.tail(h)))


class Discriminator3D(nn.Module):
    """3-D PatchGAN on NDHWC input -> (N, 1) logit: (3, 4, 4) convs, stride
    (1, 2, 2) ×3 then 1, LeakyReLU 0.2, InstanceNorm after all but the
    first, and the last map's mean over (D, H, W) (under the depth plan's
    training context over the whole volume)."""

    def __init__(self, input_nc: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        chans = (input_nc, 32, 64, 128, 256, 1)
        strides = (2, 2, 2, 1, 1)
        self.convs = nn.ModuleList(
            Conv3dTorch(cin, cout, (3, 4, 4), stride=(1, s, s), padding=1,
                        dtype=dtype)
            for cin, cout, s in zip(chans[:-1], chans[1:], strides))

    def reset_parameters(self, seed: int) -> "Discriminator3D":
        return _reset(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.convs[0](_ncdhw(x)), 0.2)
        for conv in self.convs[1:4]:
            h = F.leaky_relu(instance_norm3d(conv(h)), 0.2)
        h = self.convs[4](h)
        ctx = sp_rows()
        return h.mean(dim=(2, 3, 4)) if ctx is None else ctx.pool_logit3d(h)
