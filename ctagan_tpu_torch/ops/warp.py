"""Dense 2-D warp and flow smoothness of the port (``ctagan_tpu/ops/warp.py``).

``warp2d`` is the reference's spatial transformer itself:
``F.grid_sample(align_corners=True, padding_mode='border')`` at the pixel
grid plus the flow. With align_corners the normalisation round-trips to
pixel units, and border padding clamps the sample point to [0, S−1], the
JAX package's gather formulation.

``warp2d_local`` (config ``warp_max_disp``) is the JAX function of that
name: the same warp of the flow clipped to [−R, R] per component. JAX
computes it as a sum of shifted images, a TPU lowering that avoids a
gather; here it is the clip and ``grid_sample``, whose gradient with
respect to the flow is zero where the clip saturates, as JAX's is. The
other TPU variants (``warp2d_adaptive``, ``warp2d_dense``) are exact
lowerings of ``warp2d`` and are not ported.

Under sp training (``parallel/spatial.py``) the flow is this rank's strip:
the moving image is gathered whole (``dist.gather_whole``, whose backward
reduce-scatters its gradient), the strip's sample points are its global
rows over the whole image's H − 1, and the output is the strip's rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import sp_rows


def warp2d(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``src`` (N, H, W, C) by a flow (N, H, W, 2) whose channel 0
    displaces rows (y) and channel 1 columns (x). Differentiable in both.
    The sample points and the result are at least f32, as the JAX
    package's f32 pixel grid makes them: a bf16 grid would be whole pixels
    off past row 256."""
    n, h, w, _ = flow.shape
    dt = torch.promote_types(torch.promote_types(flow.dtype, src.dtype),
                             torch.float32)
    flow = flow.to(dt)
    top, rows = 0, h
    sp = sp_rows()
    if sp is not None:  # this strip's rows sample the whole moving image
        src = sp.gather(src)
        top, rows = sp.mesh.index * h, sp.rows(flow)
    yy = torch.arange(top, top + h, dtype=dt,
                      device=flow.device)[None, :, None]
    xx = torch.arange(w, dtype=dt, device=flow.device)[None, None, :]
    gy = (yy + flow[..., 0]) * (2.0 / (rows - 1)) - 1.0
    gx = (xx + flow[..., 1]) * (2.0 / (w - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)  # grid_sample wants (x, y)
    out = F.grid_sample(src.to(dt).permute(0, 3, 1, 2), grid,
                        mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def warp2d_local(src: torch.Tensor, flow: torch.Tensor,
                 max_displacement: int = 4) -> torch.Tensor:
    """:func:`warp2d` of the flow clipped to [−max_displacement,
    max_displacement] per component."""
    r = float(max_displacement)
    return warp2d(src, flow.clamp(-r, r))


def smoothing_loss(flow: torch.Tensor) -> torch.Tensor:
    """mean(dx²) + mean(dy²) of the flow's forward differences; under sp
    training this rank's part of it (the sp context's ``smoothing``: dy
    reads the first row of the rank below)."""
    sp = sp_rows()
    if sp is not None:
        return sp.smoothing(flow)
    dy = flow[:, 1:] - flow[:, :-1]
    dx = flow[:, :, 1:] - flow[:, :, :-1]
    return (dx * dx).mean() + (dy * dy).mean()
