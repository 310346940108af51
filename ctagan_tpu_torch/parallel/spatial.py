"""Spatial (sp) parallelism of the port's training
(``ctagan_tpu/parallel/spatial.py``): the rows of every activation split
over the ranks of a block.

Under ``mesh: {sp: N}`` (or the hybrid ``{dp: M, sp: N}``) the N ranks of
an sp block (``dist.mesh_groups``: N consecutive ranks, the dp columns
spaced by N) hold the same state, read the same rows of the global batch
(their dp column's) and each trains on a strip of H / N rows of every
image. JAX gets this from GSPMD: the batch is placed with H sharded and
the plain step is jitted, so the partitioner inserts each conv's halo and
turns each norm and loss reduction into a sum over the axis. torch has no
partitioner, so the port writes those by hand, under the context the
layers read (``models/layers.py::sp_scope``):

- each conv takes the rows its window reaches beyond the strip from the
  neighbouring ranks (:func:`halo_rows`, an autograd ``Function``: the
  ghost rows' gradient goes back to their owner), and at the image's true
  top and bottom a reflect fill (after ``ReflectPad``) or a zero fill (a
  zero-padded conv). An output row belongs to the rank that holds its
  anchor row ``stride · i``: the 3×3 stride-2 conv takes one row from
  above, the transposed conv one from below, D's 4×4 stride-2 convs one
  from each side and its two 4×4 stride-1 convs one from above and two
  from below; those two shrink the map by a row each, so the last rank
  owns fewer rows after them;
- InstanceNorm sums its partial E[x] and E[x²] over the block with
  ``dist.SumOverGroup`` and takes the one-pass clamped variance of the
  plain norm, as GSPMD partitions it;
- D's pooled logit is a ``SumOverGroup`` of the owned rows' sums over the
  global count; ``ops/losses.py``'s ``l1`` and ``mse`` give each rank its
  part of the loss, and the parts sum over the block to one process's
  loss;
- the layers that read across the seam (RegGAN, HD and CycleGAN): the
  half-pixel bilinear resize takes a row from each neighbour with an edge
  fill and crops (:func:`halo_resize`; a downsampling by 2 or 4 is
  local), stage 2's avg-pool pyramid a row from above, the flow's
  smoothness loss a row from below; the warp, stage 2's centre crop, the
  ResUNet's deepest levels and CycleGAN's pools read the whole image,
  gathered from the strips (``dist.gather_whole``, whose backward
  reduce-scatters). Every exchange differentiates twice (the R1
  penalty).

So every rank's backward is of its part of one loss, and a parameter's
gradient on a rank is the part its rows contribute: ``train/steps.py``
sums it over the block and averages it over the dp column, and the
logged losses likewise. The state stays replicated (:func:`shard_state_sp`
records the mesh on the state, as ``state.tp`` records tp's), and the
weights stay bit-identical on every rank.

A strip shorter than the rows a layer needs from a neighbour raises
``ValueError`` on every rank (exchanges are one hop). The step runs the
layer route: JAX's gate leaves its kernels off under a spatial axis, so
the sp step launches no kernel.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import acc_dtype, sp_scope
from ctagan_tpu_torch.parallel import dist


@dataclass(frozen=True)
class SpMesh:
    """A rank's place in a ``dp`` × ``n`` mesh (``dist.mesh_groups``): the
    ``n`` ranks of its sp block (``group``) split the rows, ``index`` is
    its strip; ``column`` is its place in its dp column (``dp_group``, None
    when ``dp`` is 1), the rows of the global batch it and its block
    read. ``axis`` is JAX's name of the split axis (``"spatial"``, or
    ``"depth"`` for the depth plan's mesh, ``parallel/volume.py``), which
    its messages name."""

    n: int
    index: int
    group: object
    dp: int = 1
    column: int = 0
    dp_group: Optional[object] = None
    axis: str = "spatial"

    def __deepcopy__(self, memo):  # process groups are handles, shared
        return self


def make_sp_mesh(dp: int, sp: int) -> SpMesh:
    """This rank's mesh in the process group (or, without a group and with
    ``dp`` × ``sp`` = 1, a mesh of one); every rank calls it, in the same
    order."""
    if not dist.initialized() and dp * sp == 1:
        return SpMesh(1, 0, None)
    group, column = dist.mesh_groups(dp, sp)
    return SpMesh(sp, dist.rank() % sp, group, dp, dist.column_rank(sp),
                  column)


def strip(x: torch.Tensor, mesh: SpMesh, dim: int = 1) -> torch.Tensor:
    """This rank's strip of ``x`` along ``dim`` (H of an NHWC tensor): the
    ``index``-th of ``n`` equal blocks."""
    h = x.shape[dim]
    if h % mesh.n:
        raise ValueError(
            f"spatial parallelism needs H divisible by the spatial mesh "
            f"extent: H={h} but sp={mesh.n}")
    m = h // mesh.n
    return x.narrow(dim, mesh.index * m, m)


def shard_state_sp(state, mesh: SpMesh):
    """The sp plan's state: replicated as it is (sp splits the
    activations, not the state); ``state.sp`` records the mesh."""
    state.sp = mesh
    return state


# -- the rows a window reaches beyond the strip ------------------------------

def _zeros(x: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """Zeros of ``x``'s shape with ``rows`` rows along ``dim``."""
    shape = list(x.shape)
    shape[dim] = rows
    return x.new_zeros(shape)


def _fill(x: torch.Tensor, rows: int, top: bool, fill: str,
          dim: int) -> torch.Tensor:
    """``rows`` rows beyond the image's true top (or bottom) along ``dim``:
    zeros, the reflection of ``x``'s rows about its edge row
    (ReflectionPad2d), or the edge row repeated (a replicate pad: the clamp
    of a resize's sample points)."""
    h = x.shape[dim]
    if fill == "zero":
        return _zeros(x, rows, dim)
    if fill == "edge":
        shape = list(x.shape)
        shape[dim] = rows
        return x.narrow(dim, 0 if top else h - 1, 1).expand(shape)
    return x.narrow(dim, 1 if top else h - 1 - rows, rows).flip(dim)


def _fold(gx: torch.Tensor, g: torch.Tensor, top: bool, fill: str,
          dim: int) -> None:
    """The fill's gradient ``g`` added back to the rows it copies, in
    place (nothing for a zero fill)."""
    h, rows = gx.shape[dim], g.shape[dim]
    if fill == "edge":
        gx.narrow(dim, 0 if top else h - 1, 1).add_(
            g.sum(dim=dim, keepdim=True))
    elif fill == "reflect":
        gx.narrow(dim, 1 if top else h - 1 - rows, rows).add_(g.flip(dim))


def _check(counts, mesh: SpMesh, top: int, below: int, bottom: int,
           stride: int, fill: str) -> None:
    """Every rank's rows (``counts``, alike on every rank) against what the
    layer needs: a rank sends its first ``below`` and its last ``top``
    rows to its neighbours, a reflect fill reads one row more than it
    fills, and a strided conv's strips start on its stride."""
    need = max(top, below)
    short = [q for q, h in enumerate(counts) if h < need]
    if fill == "reflect":
        short += [0] * (counts[0] < top + 1) \
            + [mesh.n - 1] * (counts[-1] < bottom + 1)
    if short:
        raise ValueError(
            f"sp: a strip of {min(counts[q] for q in short)} rows is shorter "
            f"than the rows a layer needs from a neighbour (top {top}, "
            f"bottom {max(below, bottom)}; strips by rank {counts}): the "
            f"exchange is one hop; use fewer sp ranks or larger images")
    if any(h % stride for h in counts[:-1]):
        raise ValueError(f"sp: strips of {counts[:-1]} rows do not start on "
                         f"the stride {stride} of a conv")


def _halo(x, mesh, top, below, bottom, stride, fill, dim):
    """:class:`_HaloRows`' forward."""
    first, last = mesh.index == 0, mesh.index == mesh.n - 1
    h = x.shape[dim]
    above = under = None
    if mesh.n > 1:
        # each rank's row count rides on the exchange: every rank checks
        # every strip, so all of them raise together
        tag = x.new_full((1,), float(h))
        send_up = x.narrow(dim, 0, below) if h >= below else _zeros(
            x, below, dim)
        send_down = x.narrow(dim, h - top, top) if h >= top else _zeros(
            x, top, dim)
        above, under, tags = dist.neighbour_rows(send_up, send_down,
                                                 mesh.group, tag)
        _check([int(t) for t in tags], mesh, top, below, bottom, stride,
               fill)
    else:
        _check([h], mesh, top, below, bottom, stride, fill)
    parts = [_fill(x, top, True, fill, dim) if first else above, x,
             _fill(x, bottom, False, fill, dim) if last else under]
    return torch.cat(parts, dim=dim)


def _halo_adjoint(g, mesh, top, below, bottom, fill, dim):
    """:class:`_HaloRows`' backward: the ghost rows' gradient goes back to
    the rank that owns them and is added to its rows, and a fill's is
    folded back onto the rows it copies."""
    first, last = mesh.index == 0, mesh.index == mesh.n - 1
    h = g.shape[dim] - top - (bottom if last else below)
    g_top, gx = g.narrow(dim, 0, top), g.narrow(dim, top, h).clone()
    g_bot = g.narrow(dim, top + h, g.shape[dim] - top - h)
    if mesh.n > 1:
        # the ghost rows' gradient to their owners: the top rows' to the
        # rank above (its last rows), the bottom rows' to the rank below
        # (its first rows); the ends send zeros of the same shape
        up = g_top if not first else torch.zeros_like(g_top)
        down = g_bot if not last else _zeros(g, below, dim)
        prev_bottom, next_top, _ = dist.neighbour_rows(up, down, mesh.group)
        if prev_bottom is not None:  # the rank above's bottom ghosts
            gx.narrow(dim, 0, below).add_(prev_bottom)
        if next_top is not None:  # the rank below's top ghosts
            gx.narrow(dim, h - top, top).add_(next_top)
    if first:
        _fold(gx, g_top, True, fill, dim)
    if last:
        _fold(gx, g_bot, False, fill, dim)
    return gx


class _HaloRows(torch.autograd.Function):
    """``x``, this rank's strip of rows along ``dim`` (H of an NHWC
    tensor), with ``top`` rows above it and the rows below it: ``below``
    from the next rank, or at the last rank ``bottom`` rows of fill (zero,
    reflect or edge, as at the first rank's top). Backward:
    :class:`_HaloAdjoint`, whose backward is this Function again, so the
    exchange differentiates twice (the R1 penalty)."""

    @staticmethod
    def forward(ctx, x, mesh, top, below, bottom, stride, fill, dim):
        ctx.args = (mesh, top, below, bottom, stride, fill, dim)
        return _halo(x, mesh, top, below, bottom, stride, fill, dim)

    @staticmethod
    def backward(ctx, g):
        return (_HaloAdjoint.apply(g, *ctx.args),) + (None,) * 7


class _HaloAdjoint(torch.autograd.Function):
    """The adjoint of :class:`_HaloRows` (:func:`_halo_adjoint`); its
    backward is :class:`_HaloRows`."""

    @staticmethod
    def forward(ctx, g, mesh, top, below, bottom, stride, fill, dim):
        ctx.args = (mesh, top, below, bottom, stride, fill, dim)
        return _halo_adjoint(g, mesh, top, below, bottom, fill, dim)

    @staticmethod
    def backward(ctx, gg):
        return (_HaloRows.apply(gg, *ctx.args),) + (None,) * 7


def halo_rows(x: torch.Tensor, mesh: SpMesh, top: int, below: int,
              bottom: int, stride: int = 1, fill: str = "zero",
              dim: int = 1) -> torch.Tensor:
    """:class:`_HaloRows`: ``x`` with the rows a window reaches beyond this
    rank's strip along ``dim`` (H of an NHWC tensor; the 3-D family's D of
    an NCDHW one, ``parallel/volume.py``); ``fill`` ("zero", "reflect" or
    "edge") at the image's true borders."""
    return _HaloRows.apply(x, mesh, top, below, bottom, stride, fill, dim)


def _power_of_two(f: int) -> bool:
    return f >= 1 and f & (f - 1) == 0


def halo_resize(x: torch.Tensor, mesh: SpMesh, size) -> torch.Tensor:
    """The half-pixel bilinear resize (``F.interpolate(mode='bilinear',
    align_corners=False)``, ``jax.image.resize(method='linear')``) of this
    rank's strip ``x`` (NHWC, equal strips) to ``size`` (the strip's rows,
    the whole W): this rank's rows of the whole image's resize.

    - up by a power-of-two factor f: the strip with one row from each
      neighbour (the edge row repeated at the true borders, the clamp of
      the sample points), resized to f times its rows, its middle f·h rows
      kept; with an exact factor and half-pixel centres those are one
      process's rows;
    - down by 2 or 4: local, as each output row reads the rows f·i + f/2
      − 1 and f·i + f/2 of its strip, when the strip's first global row
      divides by f (checked: it raises otherwise);
    - the same rows: W alone, local."""
    h, (oh, ow) = x.shape[1], (int(size[0]), int(size[1]))
    y = x.permute(0, 3, 1, 2)
    if oh > h:
        f = oh // h
        if f * h != oh or not _power_of_two(f):
            raise ValueError(f"sp: a resize of a strip of {h} rows to {oh} "
                             f"needs a power-of-two factor")
        y = halo_rows(x, mesh, 1, 1, 1, fill="edge").permute(0, 3, 1, 2)
        y = F.interpolate(y, size=(f * (h + 2), ow), mode="bilinear",
                          align_corners=False, antialias=False)
        y = y[:, :, f:f + oh]
    else:
        f = h // oh
        if f * oh != h or f not in (1, 2, 4) or (mesh.index * h) % f:
            raise ValueError(
                f"sp: a strip of {h} rows from row {mesh.index * h} cannot "
                f"be resized to {oh} locally: the downsampling factor must "
                f"be 2 or 4 and divide the strip's first row")
        y = F.interpolate(y, size=(oh, ow), mode="bilinear",
                          align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def _last_bottom(h: int, k: int, s: int, p: int) -> int:
    """The fill rows below the last rank's strip of ``h`` rows for a conv
    (kernel ``k``, stride ``s``, padding ``p``): its owned outputs (their
    anchors ``s·i`` in the strip, at most the image's last output) reach
    that far below it. In the strip's own coordinates: its first row's
    index divides by ``s``."""
    owned = min(-(-h // s), (h + 2 * p - k) // s + 1)
    return max(s * (owned - 1) - p + k - h, 0)


def halo_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], mesh: SpMesh, stride: int = 1,
              padding: int = 0, reflect: int = 0, transposed: bool = False
              ) -> torch.Tensor:
    """A conv of this rank's strip ``x`` (NHWC) over the sp block: this
    rank's rows of the conv of the whole image.

    - ``reflect`` = p > 0: ``ReflectPad(p)`` then the conv without padding
      (p rows from each neighbour, a reflect fill at the true borders);
    - ``padding`` = p > 0: the zero-padded conv (``padding`` p), which
      takes p rows from above and k − s − p from below, zeros at the true
      borders;
    - ``transposed``: ``ConvTranspose2d(k=3, s=2, p=1,
      output_padding=1)`` (``weight`` (I, O, 3, 3)), which takes one row
      from below, zero at the true bottom;
    - neither: a local conv (a 1×1, or the rows came with a
      :func:`halo_rows` of their own).
    ``weight`` is torch's (O, I, kh, kw), ``x`` already in its dtype."""
    if transposed:
        h = x.shape[1]
        ext = halo_rows(x, mesh, 0, 1, 1)
        y = F.conv_transpose2d(ext.permute(0, 3, 1, 2), weight, bias,
                               stride=2, padding=1, output_padding=1)
        return y[:, :, :2 * h].permute(0, 2, 3, 1).contiguous()
    k = weight.shape[2]
    if reflect:
        if stride != 1 or k != 2 * reflect + 1:
            raise ValueError(f"sp: a reflect-padded conv must keep H "
                             f"(kernel {k}, stride {stride}, pad {reflect})")
        ext = _pad_w(halo_rows(x, mesh, reflect, reflect, reflect,
                               fill="reflect"), reflect)
        pad = (0, 0)
    elif padding:
        below = k - stride - padding
        ext = halo_rows(x, mesh, padding, below,
                        _last_bottom(x.shape[1], k, stride, padding),
                        stride=stride)
        pad = (0, padding)
    else:
        ext, pad = x, (0, 0)
    y = F.conv2d(ext.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def _operands(module, x: torch.Tensor):
    """A conv module's input, weight and bias in its compute dtype."""
    dtype = module.dtype
    if dtype is None:
        return x, module.weight, module.bias
    return x.to(dtype), module.weight.to(dtype), module.bias.to(dtype)


def _pad_w(x: torch.Tensor, p: int) -> torch.Tensor:
    """ReflectionPad of W alone (NHWC)."""
    y = F.pad(x.permute(0, 3, 1, 2), (p, p, 0, 0), mode="reflect")
    return y.permute(0, 2, 3, 1)


class _Training:
    """The sp training context (``models/layers.py::sp_scope``): what each
    layer does to a strip under GSPMD's partitioning of the plain step."""

    exchanges = True

    def __init__(self, mesh: SpMesh):
        self.mesh = mesh

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mesh.n == 1 else dist.sum_over_group(
            t, self.mesh.group)

    def _count(self, x: torch.Tensor, per: int, dtype) -> torch.Tensor:
        """This rank's ``per``-element rows of ``x`` as one element of
        ``dtype``: appended to a buffer that is summed over the block."""
        return torch.full((1,), float(x.shape[1] * per), dtype=dtype,
                          device=x.device)

    def norm(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """The plain norm's one-pass clamped statistics over the whole
        image: each rank's partial sums of x and x², and its count, summed
        over the block (one ``SumOverGroup``)."""
        xf = x.to(acc_dtype(x.dtype))
        n, c = x.shape[0], x.shape[-1]
        s = self._sum(torch.cat([xf.sum(dim=(1, 2)).reshape(-1),
                                 (xf * xf).sum(dim=(1, 2)).reshape(-1),
                                 self._count(x, x.shape[2], xf.dtype)]))
        count = s[-1]
        mean = (s[:n * c] / count).view(n, 1, 1, c)
        m2 = (s[n * c:2 * n * c] / count).view(n, 1, 1, c)
        var = torch.clamp(m2 - mean * mean, min=0.0)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)

    def reflect_pad(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        """``ReflectPad``: ``pad`` rows from each neighbour (a reflect fill
        at the true borders), W reflected locally; the conv after it runs
        on the strip as it comes."""
        return _pad_w(halo_rows(x, self.mesh, pad, pad, pad,
                                fill="reflect"), pad).contiguous()

    def conv(self, module, x: torch.Tensor) -> torch.Tensor:
        """``ConvTorch``: zero-padded, through :func:`halo_conv`; without
        padding, on the rows a ``ReflectPad`` before it fetched (a stride-1
        conv)."""
        if not module.padding and module.stride != 1:
            raise ValueError("sp: an unpadded strided conv has no halo rule")
        return halo_conv(*_operands(module, x), self.mesh,
                         stride=module.stride, padding=module.padding)

    def conv_transpose(self, module, x: torch.Tensor) -> torch.Tensor:
        return halo_conv(*_operands(module, x), self.mesh, transposed=True)

    def pool_logit(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the whole image's rows: the owned rows' sums and
        count summed over the block, then divided."""
        n, c = x.shape[0], x.shape[-1]
        s = self._sum(torch.cat([x.sum(dim=(1, 2)).reshape(-1),
                                 self._count(x, x.shape[2], x.dtype)]))
        return (s[:-1] / s[-1]).view(n, c)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``'s mean: of an NHWC strip the sum of
        its rows over the whole image's element count (counted over the
        block, outside autograd); of a tensor every rank holds alike, its
        mean over the block's size."""
        if t.dim() != 4:
            return t.mean() / self.mesh.n
        count = self._count(t, t.numel() // max(t.shape[1], 1), t.dtype)
        if self.mesh.n > 1:
            dist.all_reduce_sum_(count, self.mesh.group)
        return t.sum() / count[0]


    # -- the layers that read a whole image, or rows across the seam ------

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole image of the block's equal strips ``x``
        (``dist.gather_whole``: its backward reduce-scatters)."""
        return x if self.mesh.n == 1 else dist.gather_whole(x,
                                                            self.mesh.group)

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's strip of ``x``, which every rank holds whole."""
        return strip(x, self.mesh)

    def rows(self, x: torch.Tensor) -> int:
        """The whole image's rows of the equal strips ``x``."""
        return x.shape[1] * self.mesh.n

    def resize(self, x: torch.Tensor, size) -> torch.Tensor:
        """``ops/resize.py::interpolate_bilinear`` of a strip
        (:func:`halo_resize`)."""
        return halo_resize(x, self.mesh, size)

    def avg_pool(self, x: torch.Tensor, window: int, stride: int
                 ) -> torch.Tensor:
        """``avg_pool_same`` (3×3, stride 2, padding 1,
        ``count_include_pad=False``) of a strip that starts on the stride:
        an output row reads the row above its anchor, so one row comes from
        the rank above; the first rank pads its top, which the count
        leaves out, as one process's pad."""
        if (window, stride) != (3, 2):
            raise ValueError(f"sp: avg_pool_same({window}, {stride}) has no "
                             "halo rule (the pyramid's is 3, 2)")
        ext = halo_rows(x, self.mesh, 1, 0, 0, stride=2)
        first = self.mesh.index == 0
        y = F.avg_pool2d((ext[:, 1:] if first else ext).permute(0, 3, 1, 2),
                         3, 2, padding=(int(first), 1),
                         count_include_pad=False)
        return y.permute(0, 2, 3, 1)

    def center_crop(self, x: torch.Tensor, size: int) -> torch.Tensor:
        """torchvision's center crop of the whole image to ``size`` (its
        rows and columns), this rank's strip of it: the strips gathered
        whole (a few channels), cropped, the strip kept; a centre crop may
        hold no row of an outer rank's strip."""
        if size % self.mesh.n:
            raise ValueError(f"sp: a center crop to {size} rows does not "
                             f"split over {self.mesh.n} ranks")
        whole = self.gather(x)
        h, w = whole.shape[1], whole.shape[2]
        top, left = (h - size) // 2, (w - size) // 2
        return self.keep(whole[:, top:top + size, left:left + size])

    def smoothing(self, flow: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``mean(dx²) + mean(dy²)`` of the flow's
        forward differences: dy takes the first row of the rank below
        (none below the last rank), and each sum is over the whole
        image's count (N·(H − 1)·W·C for dy, N·H·(W − 1)·C for dx)."""
        n, h, w, c = flow.shape
        ext = halo_rows(flow, self.mesh, 0, 1, 0)
        dy = ext[:, 1:] - ext[:, :-1]
        dx = flow[:, :, 1:] - flow[:, :, :-1]
        rows = self.rows(flow)
        return ((dx * dx).sum() / (n * rows * (w - 1) * c)
                + (dy * dy).sum() / (n * (rows - 1) * w * c))


def training_scope(mesh: Optional[SpMesh]):
    """The layers' sp context for a step of ``mesh`` (a no-op context for
    None)."""
    if mesh is None:
        return contextlib.nullcontext()
    return sp_scope(_Training(mesh))
