"""Halo-exchanged spatially sharded inference of the port
(``ctagan_tpu/parallel/halo.py``): one large slice across the ranks of an
sp block.

:func:`infer_spatial_sharded` cuts the H axis of one (H, W) image into one
strip a rank. Each rank takes ``halo`` ghost rows from the rank above and
from the rank below (one exchange, ``dist.neighbour_rows``); at the image's
true top and bottom the ghost rows are the symmetric extension of its own
strip (``np.pad(..., 'symmetric')``). The generator then runs on the
strip and its ghost rows as it would on a whole image, every conv local,
under the context of ``models/layers.py::sp_scope`` that makes each
InstanceNorm's statistics the whole extended image's (JAX's
``spatial_axis`` form): the ghost rows weigh 0 except the outer halos of
the first and last rank, the sums and the count are summed over the
block, and the variance takes two passes (the mean first, then the
centred second moment, no clamp). With ``halo`` at least the network's
receptive field, every rank's rows equal the unsharded generator's on the
symmetric-extended image, cropped back, seams and borders included.

At a level ``div`` times coarser than the input (the downs, the body, the
first up) the ghost rows are ``halo // div``, as JAX passes them. The
generator takes its layer route under the context (JAX's gate leaves the
fused body off under ``spatial_axis``), so it launches no kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ctagan_tpu_torch.models.layers import acc_dtype, sp_scope
from ctagan_tpu_torch.parallel import dist
from ctagan_tpu_torch.parallel.spatial import SpMesh, make_sp_mesh


class _HaloNorm:
    """The inference context: the layers run as they are on the strip and
    its ghost rows; InstanceNorm's statistics are the extended image's
    (:meth:`norm`, NHWC, the rows along H), or the extended volume's
    (:meth:`norm3d`, the 3-D family's NCDHW, the slices along D:
    ``parallel/volume.py``). ``rows`` is the strip's or the slab's extent
    with its ghosts, at the input's level."""

    exchanges = False

    def __init__(self, mesh: SpMesh, halo: int, rows: int):
        self.mesh, self.halo, self.rows = mesh, halo, rows

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mesh.n == 1 else dist.all_reduce_sum_(
            t, self.mesh.group)

    def _masked(self, x: torch.Tensor, eps: float, dim: int,
                dims: Tuple[int, ...]) -> torch.Tensor:
        """Normalised over ``dims``, the ghost rows along ``dim`` weighing 0
        except the outer halos of the first and last rank, the sums and
        the count over the block, the variance in two passes."""
        xf = x.to(acc_dtype(x.dtype))
        h = xf.shape[dim]
        ghost = self.halo * h // self.rows  # halo // div at this level
        weight = xf.new_ones(h)
        if self.mesh.index != 0:
            weight[:ghost] = 0
        if self.mesh.index != self.mesh.n - 1:
            weight[h - ghost:] = 0
        shape = [1] * xf.dim()
        shape[dim] = h
        weight = weight.view(shape)
        per = math.prod(xf.shape[k] for k in dims if k != dim)
        s = self._sum(torch.cat([(xf * weight).sum(dim=dims).reshape(-1),
                                 (weight.sum() * per).reshape(1)]))
        count = s[-1]
        keep = [1 if k in dims else e for k, e in enumerate(xf.shape)]
        mean = (s[:-1] / count).view(keep)
        s2 = self._sum((((xf - mean) ** 2) * weight).sum(dim=dims))
        var = s2.view(keep) / count
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)

    def norm(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return self._masked(x, eps, 1, (1, 2))

    def norm3d(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return self._masked(x, eps, 2, (2, 3, 4))


def _validate(h: int, n: int, halo: int) -> int:
    """JAX's checks; the strip's rows."""
    if halo % 4 != 0:
        raise ValueError("halo must be divisible by 4 (generator stride)")
    if h % (4 * n) != 0:
        raise ValueError(f"H={h} must divide into {n} stride-aligned strips")
    strip = h // n
    if halo > strip:
        raise ValueError(f"halo {halo} exceeds strip height {strip}")
    return strip


@torch.no_grad()
def infer_spatial_sharded(generator: nn.Module, image,
                          mesh: Optional[SpMesh] = None,
                          halo: int = 96) -> np.ndarray:
    """``generator`` over ``image`` (H, W) with H split over ``mesh``'s sp
    block (default: every rank of the process group, or one process
    without a group): every rank of the block holds ``image`` and returns
    the whole (H, W) result as a numpy array. ``halo`` must divide by 4
    (the generator's stride) and be at most H / n; H must divide into n
    strips of a multiple of 4 rows. The image is cast to the generator's
    parameter dtype on its device."""
    mesh = mesh or make_sp_mesh(1, dist.world())
    n, r = mesh.n, mesh.index
    h, w = image.shape
    strip = _validate(h, n, halo)
    p = next(generator.parameters())
    img = torch.as_tensor(np.ascontiguousarray(image)).to(p.device, p.dtype)
    x = img[r * strip:(r + 1) * strip].reshape(1, strip, w, 1)
    above = below = None
    if n > 1:
        # one exchange: halo rows up, halo rows down (one hop each)
        above, below, _ = dist.neighbour_rows(x[:, :halo], x[:, -halo:],
                                              mesh.group)
    # the symmetric extension at the true borders
    top = x[:, :halo].flip(1) if r == 0 else above
    bottom = x[:, -halo:].flip(1) if r == n - 1 else below
    xg = torch.cat([top, x, bottom], dim=1)
    with sp_scope(_HaloNorm(mesh, halo, strip + 2 * halo)):
        out = generator(xg)
    part = out[0, halo:halo + strip, :, 0].contiguous()
    if n == 1:
        return part.cpu().numpy()
    flat = part.new_empty(n * part.numel())
    dist.all_gather_into(flat, part.reshape(-1), mesh.group)
    return flat.view(h, w).cpu().numpy()
