"""Volume inference and the depth plan of the port
(``ctagan_tpu/parallel/volume.py``): a whole CT series through the
generator in fixed-size batches, Hann-blended depth windows for a 3-D
model, Hann-blended spatial tiles for an image larger than the model's
resolution, the exact depth-sharded 3-D inference, and the 3-D family's
training with each volume's D axis split over the ranks of a block.

- :func:`infer_volume`: ``batch_per_device`` slices a forward on one card
  (JAX's batch per device times the devices of its mesh; the port runs on
  one device). The tail batch is padded by repeating the last slice, as
  JAX pads it, so every forward has one shape.
- :func:`infer_volume_3d`: overlapping depth windows through any 3-D
  callable (the P3d family's ``Generator3D``), blended along depth by a
  Hann window.
- :func:`sliding_window`: overlapping tiles of one (H, W, C) image, blended
  by a 2-D Hann window.
- :func:`infer_volume_depth_sharded`: one (D, H, W) series with D split
  over the ranks of a depth mesh, seam-free by construction. Each rank
  holds a slab of D / n slices and ``halo`` ghost slices from each
  neighbour (one exchange each way, ``dist.neighbour_rows``), at the
  series' true top and bottom the symmetric extension of its own slab.
  ``Generator3D`` runs locally on slab and ghosts under the context of
  ``parallel/halo.py`` (``_HaloNorm.norm3d``): the norm's statistics are
  summed over the block with the ghost slabs masked, except the outer
  halos of the first and last rank. With ``halo`` at least the depth
  receptive field (``6 + 2 × n_residual_blocks``), every rank's slices
  equal the unsharded generator's on ``np.pad(volume, halo,
  'symmetric')`` (depth only), cropped back.

The depth plan (``mesh: {depth: N}`` or ``{dp: M, depth: N}``;
``parallel/mesh.py``): the N ranks of a block (``dist.mesh_groups``, the
dp columns spaced by N) hold the same replicated state
(:func:`shard_p3d_state_depth` records the mesh on it), read their dp
column's volumes, and each trains on its slab of D / N slices of every
volume (:func:`shard_batch_depth`, after the step's H and W flips). JAX
places the batch with D sharded and jits the plain step, and GSPMD
inserts each conv3d's halo and turns the norm and loss reductions into
sums over the axis; torch has no partitioner, so the step runs under the
context the 3-D layers read (:func:`training_scope`,
``models/layers.py::sp_scope``), written by hand as the sp plan's
(``parallel/spatial.py``), with D in place of H:

- every conv (depth kernel 3, zero padding 1) takes one slice from each
  neighbour (``spatial.halo_rows`` along D, a zero fill at the volume's
  true ends); by the anchor rule a depth stride 2 down takes one from
  above alone and a transposed up of depth stride 2 one from below;
- ``instance_norm3d`` keeps JAX's two-pass variance: the partial sums of
  x, then of the centred squares, each summed over the block
  (``dist.SumOverGroup``); D's logit is the owned slices' sum over the
  whole volume's count, summed over the block; ``ops/losses.py``'s
  ``l1`` and ``mse`` give each rank its part of the loss.

``train/steps.py`` sums each rank's gradients over the block and averages
them over the dp column, so the weights stay bit-identical everywhere.
Every slab has D / N slices at every level; a slab that a depth stride
would leave fractional (``depth_downsample`` 4 at 8 slices under ``{depth:
8}``) raises ``ValueError`` on every rank, where GSPMD pads it. The 3-D
convs are cuDNN's: no kernel is on this path (JAX's sharded steps run
none either).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import acc_dtype, sp_scope
from ctagan_tpu_torch.parallel import dist, spatial
from ctagan_tpu_torch.parallel.halo import _HaloNorm
from ctagan_tpu_torch.parallel.spatial import SpMesh

Apply = Callable[[torch.Tensor], torch.Tensor]
DEPTH_AXIS = "depth"


@torch.no_grad()
def infer_volume(apply_fn: Apply, volume: np.ndarray, device=None,
                 batch_per_device: int = 4) -> np.ndarray:
    """``apply_fn`` (NHWC in and out, on ``device``) over every slice of
    ``volume``: (N, H, W) single-channel or (N, H, W, C) pre-stacked 2.5-D
    context. Returns the (N, H, W) f32 first output channel."""
    step = batch_per_device
    n, h, w = volume.shape[:3]
    out = np.empty((n, h, w), np.float32)
    for start in range(0, n, step):
        chunk = volume[start:start + step]
        valid = chunk.shape[0]
        if valid < step:  # pad the tail so one shape serves every batch
            pad = np.repeat(chunk[-1:], step - valid, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        if chunk.ndim == 3:
            chunk = chunk[..., None]
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        y = apply_fn(x.to(device))
        out[start:start + valid] = y[:valid, :, :, 0].float().cpu().numpy()
    return out


@torch.no_grad()
def infer_volume_3d(apply_fn: Apply, volume: np.ndarray, depth: int = 8,
                    overlap: float = 0.5) -> np.ndarray:
    """A 3-D callable ((1, D, H, W, 1) in and out) over a whole (N, H, W)
    series: overlapping windows of ``depth`` slices, blended along depth by
    a Hann window (the last window ends on the last slice)."""
    n, h, w = volume.shape
    depth = min(depth, n)
    stride = max(1, int(depth * (1.0 - overlap)))
    starts = list(range(0, max(n - depth, 0) + 1, stride))
    if starts[-1] + depth < n:
        starts.append(n - depth)
    wz = np.hanning(depth + 2)[1:-1].astype(np.float32)
    acc = np.zeros((n, h, w), np.float32)
    norm = np.zeros((n, 1, 1), np.float32)
    for s in starts:
        patch = volume[s:s + depth][None, ..., None].astype(np.float32)
        y = apply_fn(torch.from_numpy(patch))
        acc[s:s + depth] += y[0, :, :, :, 0].float().cpu().numpy() * wz[
            :, None, None]
        norm[s:s + depth, 0, 0] += wz
    return acc / np.maximum(norm, 1e-8)


def _hann2d(tile_h: int, tile_w: int) -> np.ndarray:
    wy = np.hanning(tile_h + 2)[1:-1]
    wx = np.hanning(tile_w + 2)[1:-1]
    return np.sqrt(np.outer(wy, wx)).astype(np.float32)


def _starts(extent: int, t: int, overlap: float):
    stride = max(1, int(t * (1.0 - overlap)))
    ss = list(range(0, max(extent - t, 0) + 1, stride))
    if ss[-1] + t < extent:
        ss.append(extent - t)
    return ss


@torch.no_grad()
def sliding_window(apply_fn: Apply, image: torch.Tensor, tile: int = 512,
                   overlap: float = 0.5) -> torch.Tensor:
    """Seam-free tiled inference of one (H, W, C) image: an image that fits
    one tile goes through whole; else overlapping tiles (clamped per axis,
    so an image small in one dimension tiles along the other), all in one
    batched call, blended by a 2-D Hann window. Returns (H, W, C') f32."""
    h, w, _ = image.shape
    if h <= tile and w <= tile:
        return apply_fn(image[None])[0]
    tile_h, tile_w = min(tile, h), min(tile, w)
    ys, xs = _starts(h, tile_h, overlap), _starts(w, tile_w, overlap)
    tiles = torch.stack([image[y:y + tile_h, x:x + tile_w, :]
                         for y in ys for x in xs])
    outs = apply_fn(tiles).float()
    window = torch.from_numpy(_hann2d(tile_h, tile_w)).to(outs.device)[
        ..., None]
    acc = torch.zeros((h, w, outs.shape[-1]), dtype=torch.float32,
                      device=outs.device)
    norm = torch.zeros((h, w, 1), dtype=torch.float32, device=outs.device)
    k = 0
    for y in ys:
        for x in xs:
            acc[y:y + tile_h, x:x + tile_w, :] += outs[k] * window
            norm[y:y + tile_h, x:x + tile_w, :] += window
            k += 1
    return acc / torch.clamp(norm, min=1e-8)


# ===========================================================================
# The depth plan
# ===========================================================================

def make_depth_mesh(n: Optional[int] = None) -> Optional[SpMesh]:
    """This rank's 1-D depth mesh over the first ``n`` ranks of the process
    group (default: every rank; without a group, a mesh of one). Every
    rank calls it, in the same order; a rank beyond the first ``n`` gets
    None."""
    world = dist.world()
    n = world if n is None else n
    if n > world:
        raise ValueError(f"a depth mesh of {n} needs {n} devices, have "
                         f"{world}")
    if n == world:
        return dataclasses.replace(spatial.make_sp_mesh(1, n),
                                   axis=DEPTH_AXIS)
    group = dist.first_ranks(n)
    if dist.rank() >= n:
        return None
    return SpMesh(n, dist.rank(), group, axis=DEPTH_AXIS)


def make_dp_depth_mesh(dp: int, dep: int) -> SpMesh:
    """This rank's place in a ``dp`` × ``dep`` (data, depth) mesh of the
    process group: blocks of ``dep`` consecutive ranks split each volume's
    D, the dp columns split the batch."""
    return dataclasses.replace(spatial.make_sp_mesh(dp, dep),
                               axis=DEPTH_AXIS)


# JAX's messages for a batch axis 1 that does not split: its depth
# placement's, and its sp placement's (``_check_h_divisible``), which
# splits axis 1 of a 5-D batch too
_INDIVISIBLE = {
    DEPTH_AXIS: "depth parallelism needs D divisible by the depth mesh "
                "extent: batch[{key!r}] has D={size} but mesh['depth']={n}",
    "spatial": "spatial parallelism needs H divisible by the spatial mesh "
               "extent: batch[{key!r}] has H={size} but mesh['spatial']={n}",
}


def shard_batch_depth(batch: Dict[str, torch.Tensor], mesh: SpMesh
                      ) -> Dict[str, torch.Tensor]:
    """This rank's slab of axis 1 (D of an NDHWC volume) of each tensor of
    ``batch``; ``*_path`` leaves pass through. An axis 1 that does not
    split over the mesh raises JAX's ValueError."""
    for key, v in batch.items():
        if not key.endswith("_path") and v.dim() >= 2 \
                and v.shape[1] % mesh.n:
            raise ValueError(_INDIVISIBLE[mesh.axis].format(
                key=key, size=v.shape[1], n=mesh.n))
    return {k: v if k.endswith("_path") else spatial.strip(v, mesh)
            for k, v in batch.items()}


def shard_p3d_state_depth(state, mesh: SpMesh):
    """The depth plan's state: replicated as it is (the plan splits the
    activations, not the state); ``state.depth`` records the mesh."""
    state.depth = mesh
    return state


def _slices(x: torch.Tensor, mesh: SpMesh, top: int, below: int,
            stride: int = 1) -> torch.Tensor:
    """``x`` (NCDHW, this rank's slab) with ``top`` slices from the rank
    above and ``below`` from the rank below, zeros at the volume's true
    ends, in ``channels_last_3d`` strides."""
    ext = spatial.halo_rows(x, mesh, top, below, below, stride=stride,
                            dim=2)
    return ext.contiguous(memory_format=torch.channels_last_3d)


class _DepthTraining(spatial._Training):
    """The depth plan's training context (``models/layers.py::sp_scope``):
    what each layer of the 3-D family does to a slab under GSPMD's
    partitioning of the plain step. Every slab of a level has the same
    slices, so each count is this rank's times the block's size."""

    def _whole(self, x: torch.Tensor) -> int:
        """The whole volume's elements of one (sample, channel) of the
        NCDHW slab ``x``."""
        return x.shape[2] * self.mesh.n * x.shape[3] * x.shape[4]

    def _halves(self, d: int, stride: int) -> None:
        """A depth stride must split every slab of the level alike."""
        if d % stride:
            raise ValueError(
                f"depth: the level of {d * self.mesh.n} slices splits into "
                f"slabs of {d} over {self.mesh.n} ranks, which a conv of "
                f"depth stride {stride} cannot split alike (GSPMD pads the "
                "fractional slab; the port needs every slab to divide by "
                "the stride): use fewer depth ranks or deeper patches")

    def norm3d(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """``instance_norm3d`` over the whole volume, in JAX's two passes:
        the mean of the block's partial sums, then the centred second
        moment's (two ``SumOverGroup``)."""
        xf = x.to(acc_dtype(x.dtype))
        n, c = x.shape[:2]
        count = self._whole(x)
        mean = (self._sum(xf.sum(dim=(2, 3, 4))) / count).view(n, c, 1, 1, 1)
        d = xf - mean
        var = (self._sum((d * d).sum(dim=(2, 3, 4))) / count).view(
            n, c, 1, 1, 1)
        return (d * torch.rsqrt(var + eps)).to(x.dtype)

    def conv3d(self, x, weight, bias, stride, padding) -> torch.Tensor:
        """A zero-padded conv of depth kernel 3 and padding 1 (every conv
        of the family): one slice from above, and at depth stride 1 one
        from below."""
        if weight.shape[2] != 3 or padding[0] != 1:
            raise ValueError("depth: a conv needs depth kernel 3 and "
                             "padding 1 (the 3-D family's)")
        self._halves(x.shape[2], stride[0])
        ext = _slices(x, self.mesh, 1, 2 - stride[0], stride[0])
        return F.conv3d(ext, weight, bias, stride=stride,
                        padding=(0, *padding[1:]))

    def conv_transpose3d(self, x, weight, bias, stride, output_padding
                         ) -> torch.Tensor:
        """The up path's transposed conv (padding 1): at depth stride 1 a
        slice from each neighbour; at depth stride 2 one from below, the
        2·d output slices kept."""
        d = x.shape[2]
        if stride[0] == 1:
            return F.conv_transpose3d(
                _slices(x, self.mesh, 1, 1), weight, bias, stride=stride,
                padding=(2, 1, 1), output_padding=output_padding)
        y = F.conv_transpose3d(_slices(x, self.mesh, 0, 1), weight, bias,
                               stride=stride, padding=1,
                               output_padding=output_padding)
        return y[:, :, :stride[0] * d]

    def pool_logit3d(self, x: torch.Tensor) -> torch.Tensor:
        """D's logit: the mean over the whole volume's (D, H, W), the owned
        slices' sums summed over the block."""
        return self._sum(x.sum(dim=(2, 3, 4))) / self._whole(x)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t``'s mean: of an NDHWC slab its sum over
        the whole volume's element count; of a tensor every rank holds
        alike (the logits), its mean over the block's size."""
        if t.dim() != 5:
            return super().mean(t)
        return t.sum() / (t.numel() * self.mesh.n)


def training_scope(mesh: Optional[SpMesh]):
    """The 3-D layers' depth context for a step of ``mesh`` (a no-op
    context for None)."""
    if mesh is None:
        return contextlib.nullcontext()
    return sp_scope(_DepthTraining(mesh))


@torch.no_grad()
def infer_volume_depth_sharded(generator3d, volume,
                               mesh: Optional[SpMesh] = None,
                               halo: Optional[int] = None) -> np.ndarray:
    """``generator3d`` (``Generator3D``) over ``volume`` (D, H, W) with D
    split over ``mesh`` (default: every rank of the process group, or one
    process without a group): every rank of the mesh holds ``volume`` and
    returns the whole (D, H, W) result as a numpy array (f32; f64 for an
    f64 generator). ``halo`` defaults to the depth receptive field, ``6 +
    2 × n_residual_blocks``; D must divide over the mesh into slabs of at
    least ``halo`` slices, and the generator's depth strides must be (1,
    1). The slab is cast to the generator's parameter dtype on its
    device."""
    mesh = mesh or make_depth_mesh()
    n, r = mesh.n, mesh.index
    d, h, w = volume.shape
    if halo is None:
        halo = 6 + 2 * len(generator3d.body)
    if d % n != 0:
        raise ValueError(f"D={d} must divide over {n} devices")
    slab = d // n
    if halo > slab:
        raise ValueError(
            f"halo {halo} exceeds slab depth {slab} — use fewer devices or "
            "a deeper series")
    p = next(generator3d.parameters())
    x = torch.from_numpy(np.ascontiguousarray(
        volume[r * slab:(r + 1) * slab])).to(p.device, p.dtype)[
            None, ..., None]
    above = below = None
    if n > 1:
        # one exchange: halo slices up, halo slices down (one hop each)
        above, below, _ = dist.neighbour_rows(x[:, :halo], x[:, -halo:],
                                              mesh.group)
    # the symmetric extension at the true ends
    top = x[:, :halo].flip(1) if r == 0 else above
    bottom = x[:, -halo:].flip(1) if r == n - 1 else below
    xg = torch.cat([top, x, bottom], dim=1)
    with sp_scope(_HaloNorm(mesh, halo, slab + 2 * halo)):
        out = generator3d(xg)
    part = out[0, halo:halo + slab, :, :, 0]
    part = part.to(acc_dtype(part.dtype)).contiguous()
    if n == 1:
        return part.cpu().numpy()
    flat = part.new_empty(n * part.numel())
    dist.all_gather_into(flat, part.reshape(-1), mesh.group)
    return flat.view(d, h, w).cpu().numpy()
