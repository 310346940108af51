"""Volume inference of the port (``ctagan_tpu/parallel/volume.py``): a whole
CT series through the generator in fixed-size batches, Hann-blended depth
windows for a 3-D model, and Hann-blended spatial tiles for an image larger
than the model's resolution.

- :func:`infer_volume`: ``batch_per_device`` slices a forward on one card
  (JAX's batch per device times the devices of its mesh; the port runs on
  one device). The tail batch is padded by repeating the last slice, as
  JAX pads it, so every forward has one shape.
- :func:`infer_volume_3d`: overlapping depth windows through any 3-D
  callable (the P3d family's ``Generator3D``), blended along depth by a
  Hann window.
- :func:`sliding_window`: overlapping tiles of one (H, W, C) image, blended
  by a 2-D Hann window.

JAX's ``infer_volume_depth_sharded`` and the depth-parallel training
functions wait for ROADMAP M12f (the depth plan).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Apply = Callable[[torch.Tensor], torch.Tensor]


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
