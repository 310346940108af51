"""Discriminators of the port (``ctagan_tpu/models/discriminator.py``), on
NHWC input, each with the reference's key names so its state dict loads
with ``strict=True``:

- ``Discriminator``: the scalar-logit PatchGAN of HD stage 1, four 4×4 conv
  stages and a 1-channel head globally average-pooled to one logit per
  image (``model.{0,2,5,8,11}``);
- ``NLayerDiscriminator``: the pix2pixHD PatchGAN of HD stage 2, one
  ``model{n}`` Sequential per stage (conv first, so ``model{n}.0``), which
  returns every stage's output with ``get_interm_feat``;
- ``MultiScaleDiscriminator``: ``num_d`` NLayer discriminators
  (``scale{i}.``) over an image pyramid whose transition is a center crop
  to S/2 (the reference's live path) or ``avg_pool_same``.

Their convs run on cuDNN: the JAX package computes them outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ctagan_tpu_torch.models.layers import (
    ConvTorch,
    InstanceNorm,
    avg_pool_same,
    center_crop,
    global_avg_pool_logit,
    image_rows,
)


class _SeededConvs(nn.Module):
    def reset_parameters(self, seed: int):
        """Seeded PyTorch-default init of every conv, in module order."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, ConvTorch):
                m.reset_parameters(gen)
        return self


def _conv(cin, cout, stride, dtype):
    return ConvTorch(cin, cout, 4, stride=stride, padding=1, dtype=dtype)


def _lrelu():
    return nn.LeakyReLU(0.2)


class Discriminator(_SeededConvs):
    def __init__(self, input_nc: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model = nn.Sequential(
            _conv(input_nc, 64, 2, dtype), _lrelu(),
            _conv(64, 128, 2, dtype), InstanceNorm(), _lrelu(),
            _conv(128, 256, 2, dtype), InstanceNorm(), _lrelu(),
            _conv(256, 512, 1, dtype), InstanceNorm(), _lrelu(),
            _conv(512, 1, 1, dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, input_nc) -> (N, 1) logits."""
        return global_avg_pool_logit(self.model(x))


class NLayerDiscriminator(_SeededConvs):
    """``n_layers`` stride-2 stages (the first without a norm), one stride-1
    stage and a 1-channel stride-1 head, every conv 4×4 with pad 1, widths
    ``ndf`` doubling up to 512, InstanceNorm and LeakyReLU(0.2)."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 get_interm_feat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers, self.get_interm_feat = n_layers, get_interm_feat
        stages = [[_conv(input_nc, ndf, 2, dtype), _lrelu()]]
        nf = ndf
        for _ in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            stages.append([_conv(prev, nf, 2, dtype), InstanceNorm(),
                           _lrelu()])
        prev, nf = nf, min(nf * 2, 512)
        stages.append([_conv(prev, nf, 1, dtype), InstanceNorm(), _lrelu()])
        stages.append([_conv(nf, 1, 1, dtype)])
        for n, layers in enumerate(stages):
            setattr(self, f"model{n}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor):
        """(N, H, W, input_nc) -> the list of the n_layers + 2 stage outputs
        with ``get_interm_feat``, else the last one (N, h, w, 1)."""
        feats: List[torch.Tensor] = []
        for n in range(self.n_layers + 2):
            x = getattr(self, f"model{n}")(x)
            feats.append(x)
        return feats if self.get_interm_feat else x


class MultiScaleDiscriminator(_SeededConvs):
    """``num_d`` NLayer discriminators over a pyramid. Scale i feeds
    ``scale{num_d - 1 - i}`` (the reference's indexing), and each scale
    after the first sees the previous input center-cropped to half its
    height (``pyramid='center_crop'``) or average-pooled (``'avg_pool'``).
    Returns a list over scales of feature lists."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 num_d: int = 1, pyramid: str = "center_crop",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if pyramid not in ("center_crop", "avg_pool"):
            raise ValueError(f"pyramid must be 'center_crop' or 'avg_pool', "
                             f"got {pyramid!r}")
        self.num_d, self.pyramid = num_d, pyramid
        for i in range(num_d):
            setattr(self, f"scale{i}", NLayerDiscriminator(
                input_nc, ndf, n_layers, get_interm_feat=True, dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for i in range(self.num_d):
            results.append(getattr(self, f"scale{self.num_d - 1 - i}")(x))
            if i != self.num_d - 1:
                x = (center_crop(x, int(image_rows(x) / 2))
                     if self.pyramid == "center_crop" else avg_pool_same(x))
        return results
