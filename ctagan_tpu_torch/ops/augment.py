"""Batched random affine augmentation of the port (``ctagan_tpu/ops/augment.py``).

The parameters follow ``torchvision.transforms.RandomAffine(degrees=level,
translate=[.02·level]·2, scale=[1 − .02·level, 1 + .02·level], fill=−1)``:
angle ~ U(−level, level) degrees, translation ~ U(−W·t, W·t) × U(−H·t, H·t)
rounded to whole pixels, scale ~ U(1 − s, 1 + s). Draws come from an
explicit ``torch.Generator``; JAX's keys give other numbers, so parity tests
inject the parameters. The warp maps each output pixel back about the
centre, samples the nearest source pixel and fills −1 outside the source.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def sample_affine_params(gen: torch.Generator, batch: int, noise_level,
                         height: int, width: int
                         ) -> Tuple[torch.Tensor, ...]:
    """Per-sample (angle_deg, ty, tx, scale), f32 on the CPU."""
    deg = float(noise_level)
    t = 0.02 * float(noise_level)
    s = 0.02 * float(noise_level)

    def uniform(lo, hi):
        return torch.rand(batch, generator=gen) * (hi - lo) + lo

    angle = uniform(-deg, deg)
    tx = torch.round(uniform(-width * t, width * t))
    ty = torch.round(uniform(-height * t, height * t))
    scale = uniform(1.0 - s, 1.0 + s)
    return angle, ty, tx, scale


def affine_warp(img: torch.Tensor, angle_deg, ty, tx, scale,
                fill: float = -1.0) -> torch.Tensor:
    """Per-sample rotate + translate + scale about the centre of an NHWC
    batch, nearest sampling; out-of-source pixels get ``fill``."""
    n, h, w, c = img.shape
    dev = img.device

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dev)[:, None, None]

    theta = col(angle_deg) * (math.pi / 180.0)
    cos = torch.cos(theta) / col(scale)
    sin = torch.sin(theta) / col(scale)
    cyc, cxc = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - cyc
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - cxc
    # inverse map: untranslate, rotate by −theta, unscale
    yyt = yy - col(ty)
    xxt = xx - col(tx)
    src_y = cos * yyt - sin * xxt + cyc
    src_x = sin * yyt + cos * xxt + cxc
    iy = torch.round(src_y).clamp(0, h - 1).long()
    ix = torch.round(src_x).clamp(0, w - 1).long()
    flat = img.reshape(n, h * w, c)
    idx = (iy * w + ix).reshape(n, h * w, 1).expand(n, h * w, c)
    out = torch.gather(flat, 1, idx).reshape(n, h, w, c)
    inside = ((src_y >= -0.5) & (src_y <= h - 0.5) & (src_x >= -0.5)
              & (src_x <= w - 0.5))
    return torch.where(inside[..., None], out, fill)

