"""Losses of the port's HD stage-1 step (``ctagan_tpu/ops/losses.py``; the
flow smoothness term is ``ops/warp.py::smoothing_loss``)."""
from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def l1(pred: torch.Tensor, target) -> torch.Tensor:
    return (pred - target).abs().mean()
