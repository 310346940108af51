"""Fused InstanceNorm (+activation) kernel (K6), a CUDA kernel.

The module keeps the name of its counterpart,
``ctagan_tpu/ops/pallas_kernels.py``, whose ``instance_norm_pallas`` is a
Pallas TPU kernel; here :func:`instance_norm_pallas` launches the CUDA kernel
``csrc/instance_norm.cu``: per-channel f32 [sum, sum²] over (H, W) by blocks
with atomics, then a normalize-and-activate pass, two launches on the
caller's stream. What bounds it on the H100 is bytes (two reads of the
activation and one write).

As in the JAX package it has no backward: the wrapper raises for an input
that requires grad while autograd records. ``models.layers.instance_norm``
runs it when ``models.layers.USE_PALLAS_INSTANCE_NORM`` is set.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`instance_norm_pallas_plain`, which is also the kernel's
oracle on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops._common import check_input, stream_ptr

ACTIVATIONS = {None: 0, "relu": 1, "leaky_relu": 2}
MAX_CHANNELS = 4096  # the normalize pass keeps 2·C floats in shared memory


def _check_args(x, activation):
    check_input("instance_norm_pallas", x)
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {list(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("instance_norm_pallas has no backward (as in the "
                           "JAX package): its input must not require grad")


def instance_norm_pallas_plain(x: torch.Tensor, eps: float = 1e-5,
                               activation: Optional[str] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`instance_norm_pallas`: f32 one-pass
    statistics with the TPU kernel's unclamped variance
    ``s2 / hw − mean²`` (``models.layers.instance_norm`` clamps it at 0)."""
    _check_args(x, activation)
    n, h, w, c = x.shape
    hw = float(h * w)
    xf = x.float()
    mean = xf.sum(dim=(1, 2)) / hw
    var = (xf * xf).sum(dim=(1, 2)) / hw - mean * mean
    inv = torch.rsqrt(var + eps)
    out = (xf - mean[:, None, None, :]) * inv[:, None, None, :]
    if activation == "relu":
        out = torch.relu(out)
    elif activation == "leaky_relu":
        out = torch.where(out >= 0.0, out, 0.2 * out)
    return out.to(x.dtype)


def instance_norm_pallas(x: torch.Tensor, eps: float = 1e-5,
                         activation: Optional[str] = None) -> torch.Tensor:
    """InstanceNorm(affine=False) over H, W of an NHWC f32 or bf16 tensor,
    with ``activation`` None, ``"relu"`` or ``"leaky_relu"`` (slope 0.2);
    f32 statistics, output in x's dtype."""
    if not x.is_cuda:
        return instance_norm_pallas_plain(x, eps, activation)
    _check_args(x, activation)
    n, h, w, c = x.shape
    if c > MAX_CHANNELS or h * w * c >= 2 ** 31:
        raise ValueError(f"instance_norm_pallas: the CUDA kernel needs C <= "
                         f"{MAX_CHANNELS} and H·W·C < 2^31, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    stats = torch.zeros((n, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_instance_norm", x.data_ptr(), out.data_ptr(),
            stats.data_ptr(), n, h, w, c, ACTIVATIONS[activation],
            int(x.dtype == torch.bfloat16), float(eps), stream_ptr(x),
        )
    instance_norm_pallas.launches += 1
    return out


instance_norm_pallas.launches = 0
