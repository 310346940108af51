"""Resize of the port (``ctagan_tpu/ops/resize.py``), NHWC."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import sp_rows


def interpolate_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` on NHWC: the
    half-pixel convention of ``jax.image.resize(method='linear')``; identity
    at the same size. Under sp training ``x`` and ``size`` are a strip's,
    and the resize is ``parallel/spatial.py::halo_resize``."""
    if (x.shape[1], x.shape[2]) == tuple(size):
        return x
    sp = sp_rows()
    if sp is not None:
        return sp.resize(x, size)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
