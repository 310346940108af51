"""Scalar-logit discriminator of the port
(``ctagan_tpu/models/discriminator.py::Discriminator``): a PatchGAN of four
4×4 conv stages and a 1-channel head, globally average-pooled to one logit
per image (LSGAN on a scalar). NHWC input; the ``model.{0,2,5,8,11}`` key
names of the reference's Sequential, so its state dict loads with
``strict=True``. ``NLayerDiscriminator`` and ``MultiScaleDiscriminator``
come with HD stage 2."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ctagan_tpu_torch.models.layers import (
    ConvTorch,
    InstanceNorm,
    global_avg_pool_logit,
)


class Discriminator(nn.Module):
    def __init__(self, input_nc: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def conv(cin, cout, stride):
            return ConvTorch(cin, cout, 4, stride=stride, padding=1,
                             dtype=dtype)

        def lrelu():
            return nn.LeakyReLU(0.2)

        self.model = nn.Sequential(
            conv(input_nc, 64, 2), lrelu(),
            conv(64, 128, 2), InstanceNorm(), lrelu(),
            conv(128, 256, 2), InstanceNorm(), lrelu(),
            conv(256, 512, 1), InstanceNorm(), lrelu(),
            conv(512, 1, 1),
        )

    def reset_parameters(self, seed: int) -> "Discriminator":
        """Seeded PyTorch-default init of every conv, in module order."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, ConvTorch):
                m.reset_parameters(gen)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, input_nc) -> (N, 1) logits."""
        return global_avg_pool_logit(self.model(x))
