"""RegNet of the port (``ctagan_tpu/models/reg.py``): the registration
ResUNet that predicts a dense 2-D flow.

- input: concat(img_a, img_b) on channels;
- 7 down levels ndf=[32,64,64,64,64,64,64], each a 3×3 conv (leaky 0.2, no
  norm) + one resnet block, a max pool 2 and the pre-pool skip;
- bottleneck: 1×1 conv 64 → 128, 3 resnet blocks, 1×1 conv 128 → 64;
- 7 up stages nuf=[64,64,64,64,64,64,32]: bilinear resize to the skip's size
  (align_corners=False), concat [up, skip], 3×3 conv;
- refine: 1 resnet block + 1×1 conv; output: 3×3 conv → 2 channels with
  near-zero init, so the first flow is ~0.

NHWC in and out; the flow is (N, H, W, 2) with channel 0 the row (y)
displacement. Submodules carry the reference's ``offset_map.*`` key names
(``ctagan_tpu/models/torch_export.py::regnet_state_dict``), so its state
dict loads with ``strict=True``. The TPU options ``fuse_up``, ``tap_convs``
and ``im2col_levels`` are not ported: cuDNN covers those shapes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ctagan_tpu_torch.models.layers import (
    RegConv,
    RegResnetStack,
    _RegConv2d,
    max_pool,
)
from ctagan_tpu_torch.ops.resize import interpolate_bilinear

NDF = (32, 64, 64, 64, 64, 64, 64)
NUF = (64, 64, 64, 64, 64, 64, 32)


class _Down(nn.Module):
    def __init__(self, cin, features, dtype):
        super().__init__()
        self.conv_0 = RegConv(cin, features, 3, 1, 1, use_resnet=True,
                              dtype=dtype)

    def forward(self, x):
        return self.conv_0(x)


class _OffsetMap(nn.Module):
    def __init__(self, cin: int, resnet_nblocks: int, dtype):
        super().__init__()
        prev = cin
        for i, nf in enumerate(NDF):
            setattr(self, f"down_{i + 1}", _Down(prev, nf, dtype))
            prev = nf
        self.c1 = RegConv(NDF[-1], 2 * NDF[-1], 1, 1, 0, dtype=dtype)
        self.t = RegResnetStack(2 * NDF[-1], resnet_nblocks, dtype)
        self.c2 = RegConv(2 * NDF[-1], NDF[-1], 1, 1, 0, dtype=dtype)
        prev = NDF[-1]
        for i, nf in enumerate(NUF):
            level = len(NDF) - i
            setattr(self, f"up_{level}",
                    RegConv(prev + NDF[level - 1], nf, 3, 1, 1, dtype=dtype))
            prev = nf
        self.refine = nn.Sequential(
            RegResnetStack(NUF[-1], 1, dtype),
            RegConv(NUF[-1], NUF[-1], 1, 1, 0, dtype=dtype))
        self.output = RegConv(NUF[-1], 2, 3, 1, 1, activation=None,
                              zero_init=True, dtype=dtype)

    def forward(self, x):
        skips = []
        for i in range(len(NDF)):
            x = getattr(self, f"down_{i + 1}")(x)
            skips.append(x)
            x = max_pool(x, 2)
        x = self.c2(self.t(self.c1(x)))
        for i in range(len(NUF)):
            skip = skips[len(NDF) - 1 - i]
            x = interpolate_bilinear(x, (skip.shape[1], skip.shape[2]))
            x = torch.cat([x, skip], dim=-1)
            x = getattr(self, f"up_{len(NDF) - i}")(x)
        return self.output(self.refine(x))


class RegNet(nn.Module):
    def __init__(self, in_channels_a: int = 1, in_channels_b: int = 1,
                 resnet_nblocks: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.offset_map = _OffsetMap(in_channels_a + in_channels_b,
                                     resnet_nblocks, dtype)

    def reset_parameters(self, seed: int) -> "RegNet":
        """Seeded kaiming-normal init of every conv (near-zero for the flow
        head), zero biases, in module order."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, _RegConv2d):
                m.reset_parameters(gen)
        return self

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor):
        """(N, H, W, Ca), (N, H, W, Cb) -> flow (N, H, W, 2), channel 0 = y."""
        return self.offset_map(torch.cat([img_a, img_b], dim=-1))
