"""Dense 2-D warp and flow smoothness of the port (``ctagan_tpu/ops/warp.py``).

``warp2d`` is the reference's spatial transformer itself:
``F.grid_sample(align_corners=True, padding_mode='border')`` at the pixel
grid plus the flow. With align_corners the normalisation round-trips to
pixel units, and border padding clamps the sample point to [0, S−1], the
JAX package's gather formulation. The TPU variants (``warp2d_local``,
``warp2d_adaptive``, ``warp2d_dense``) are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def warp2d(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``src`` (N, H, W, C) by a flow (N, H, W, 2) whose channel 0
    displaces rows (y) and channel 1 columns (x). Differentiable in both."""
    n, h, w, _ = flow.shape
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    gy = (yy + flow[..., 0]) * (2.0 / (h - 1)) - 1.0
    gx = (xx + flow[..., 1]) * (2.0 / (w - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)  # grid_sample wants (x, y)
    out = F.grid_sample(src.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def smoothing_loss(flow: torch.Tensor) -> torch.Tensor:
    """mean(dx²) + mean(dy²) of the flow's forward differences."""
    dy = flow[:, 1:] - flow[:, :-1]
    dx = flow[:, :, 1:] - flow[:, :, :-1]
    return (dx * dx).mean() + (dy * dy).mean()
