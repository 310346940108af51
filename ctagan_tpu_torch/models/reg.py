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

Under sp training (``parallel/spatial.py``) the input is a strip of equal
rows, halved by each pool. Where a strip gets too short for a level
(:func:`whole_from`), that level and every deeper one run on the whole
image, gathered from the strips (``dist.gather_whole``), with the sp
context suspended, so that their norms and pads are one process's; the up
path keeps this rank's strip again at the first up level whose skip is a
strip. Each rank's gradient through the whole levels is its own loss
part's: the gather's reduce-scatter and the step's sum over the block add
the parts up.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch import nn

from ctagan_tpu_torch.models.layers import (
    RegConv,
    RegResnetStack,
    _RegConv2d,
    max_pool,
    sp_rows,
    sp_scope,
)
from ctagan_tpu_torch.ops.resize import interpolate_bilinear

NDF = (32, 64, 64, 64, 64, 64, 64)
NUF = (64, 64, 64, 64, 64, 64, 32)
# the sp rule's levels: the down levels 1-7, then the bottleneck, and the
# cut of a run that gathers none
BOTTLENECK = len(NDF) + 1
WHOLE_NONE = len(NDF) + 2


def whole_from(rows: int) -> int:
    """The first level that the sp plan runs whole, from a strip's
    ``rows`` alone (equal on every rank, so every rank picks the same
    levels without a collective): the first down level whose input strip
    is under 2 rows (a reflect fill at a true border reads the row after
    the edge row) or odd (its pool would crop a row that one process
    keeps), else the bottleneck if its input strip is under 2 rows, else
    :data:`WHOLE_NONE`. From that level on the levels run on the whole
    image, every rank alike; the up path returns to strips at the first up
    level whose skip is a strip."""
    for level in range(1, BOTTLENECK):
        if rows < 2 or rows % 2:
            return level
        rows //= 2
    return BOTTLENECK if rows < 2 else WHOLE_NONE


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
        sp = sp_rows()
        cut = WHOLE_NONE if sp is None else whole_from(x.shape[1])

        def at(level):  # the layers of a level, whole or on the strip
            return sp_scope(None) if level >= cut else nullcontext()

        skips = []
        for i in range(len(NDF)):
            if i + 1 == cut:
                x = sp.gather(x)
            with at(i + 1):
                x = getattr(self, f"down_{i + 1}")(x)
                skips.append(x)
                x = max_pool(x, 2)
        if cut == BOTTLENECK:
            x = sp.gather(x)
        with at(BOTTLENECK):
            x = self.c2(self.t(self.c1(x)))
        for i in range(len(NUF)):
            level = len(NDF) - i
            skip = skips[level - 1]
            if level + 1 == cut:  # back to strips: this rank's rows
                with sp_scope(None):
                    x = interpolate_bilinear(x, (sp.rows(skip),
                                                 skip.shape[2]))
                x = sp.keep(x)
            with at(level):
                x = interpolate_bilinear(x, (skip.shape[1], skip.shape[2]))
                x = torch.cat([x, skip], dim=-1)
                x = getattr(self, f"up_{level}")(x)
        if cut == 1:  # every level whole, the head too
            with sp_scope(None):
                x = self.output(self.refine(x))
            return sp.keep(x)
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
