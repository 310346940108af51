"""Whole-series inference of the port (``ctagan_tpu/parallel/serve.py``):
an SE0 DICOM series in, a synthetic SE2 series out.

The system's production path (``--mode infer --series DIR``): read a
patient's whole NCCT series, synthesize the CTA volume in fixed batches on
the card (``parallel/volume.py``), and write a complete DICOM series under
one fresh SeriesInstanceUID: the batch counterpart of test()'s slice by
slice writeback. The generator is the trainer's ``generator_ckpt``, else the
newest checkpoint of its prefix in ``save_root`` (a port ``.pt`` or a JAX
``.ckpt``), run on the trainer's eval route: the serving route (K3, K1, K2)
with ``fused_body``, else the training model's (on the card the body through
K1), and the EMA with ``ema_decay`` > 0. The 3-D family (``P3d``) runs
``Generator3D`` over overlapping windows of ``patch_depth`` slices blended
along depth (``parallel/volume.py::infer_volume_3d``), or with
``infer_depth_sharded: true`` JAX's exact branch: the whole series once,
its D split over the first n ranks of the process group
(``infer_volume_depth_sharded``), n = min(ranks, max(1, D // halo))
lowered until it divides D, halo the depth receptive field; a model it
refuses (a ``depth_downsample`` variant) prints JAX's message and takes
the Hann windows. Rank 0 writes the series.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ctagan_tpu_torch.data.dicom import generate_uid, read_dicom, write_dicom
from ctagan_tpu_torch.data.native import (
    dual_window_native,
    resize_nearest_native,
)
from ctagan_tpu_torch.parallel import dist
from ctagan_tpu_torch.parallel.volume import (
    infer_volume,
    infer_volume_3d,
    infer_volume_depth_sharded,
    make_depth_mesh,
)


def load_series_fullrange(series_dir: str, size: Optional[int] = None
                          ) -> Tuple[np.ndarray, List[str]]:
    """An SE0 series' ``IM*`` files as an (N, H, W) full-range [-1, 1]
    volume ordered by SliceLocation (nearest-resized to ``size``); returns
    (volume, the slices' paths in that order)."""
    entries = []
    for f in sorted(os.listdir(series_dir)):
        if not f.startswith("IM"):
            continue
        path = os.path.join(series_dir, f)
        ds = read_dicom(path)
        entries.append((ds.slice_location or 0.0, path, ds))
    entries.sort(key=lambda t: t[0])
    slices = []
    for _, _, ds in entries:
        full = dual_window_native(ds.pixel_array())[1]
        if size:
            full = resize_nearest_native(full, size)
        slices.append(full)
    return np.stack(slices), [e[1] for e in entries]


def context_stack(volume: np.ndarray, context_slices: int) -> np.ndarray:
    """(N, H, W) -> (N, H, W, k): each slice with its ±k//2 neighbours on
    channels, the series' ends clamped."""
    half = context_slices // 2
    n = volume.shape[0]
    idx = [np.clip(np.arange(n) + off, 0, n - 1)
           for off in range(-half, half + 1)]
    return np.stack([volume[i] for i in idx], axis=-1)


def infer_series(trainer, series_dir: str, out_root: str,
                 times: Optional[Dict[str, float]] = None) -> str:
    """The trainer's generator over a whole SE0 series; writes the synthetic
    series to ``<out_root>/volume/SE2`` (each file named as its source,
    resized back to its rows, ``(img + 1) · 0.5 · 4095`` stored) and returns
    that directory. ``times``, when given, receives the seconds of the
    three parts: ``load``, ``forward`` and ``writeback``. In a process
    group (``infer_depth_sharded``) every rank calls it and rank 0
    writes."""
    import torch

    cfg = trainer.config
    three_d = getattr(trainer, "family", "") == "p3d"
    trainer.load_inference_generator()
    t0 = time.perf_counter()
    volume, paths = load_series_fullrange(series_dir, size=cfg.size)
    if cfg.context_slices > 1 and not three_d:
        volume = context_stack(volume, cfg.context_slices)
    t1 = time.perf_counter()
    model = trainer._eval_model()
    if three_d and cfg.infer_depth_sharded:
        fake = _depth_sharded(model, volume, cfg.patch_depth, trainer.device)
    elif three_d:
        fake = _windows(model, volume, cfg.patch_depth, trainer.device)
    else:
        fused = cfg.fused_body
        fake = infer_volume(lambda x: model(x, fused_body=fused), volume,
                            device=trainer.device)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    t2 = time.perf_counter()
    out_dir = os.path.join(out_root, "volume", "SE2")
    if not dist.is_host0():
        dist.barrier()  # rank 0 writes the series
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    uid = generate_uid()
    for i, path in enumerate(paths):
        ds = read_dicom(path)
        img = fake[i]
        if img.shape != (ds.rows, ds.cols):
            img = resize_nearest_native(np.ascontiguousarray(img, np.float32),
                                        ds.rows)
        ds.set_pixel_data((img + 1.0) * 0.5 * 4095.0)
        ds.series_instance_uid = uid
        write_dicom(ds, os.path.join(out_dir, os.path.basename(path)))
    if times is not None:
        times.update(load=t1 - t0, forward=t2 - t1,
                     writeback=time.perf_counter() - t2)
    dist.barrier()
    return out_dir


def _windows(model, volume: np.ndarray, depth: int, device) -> np.ndarray:
    """The Hann-blended depth windows of ``depth`` slices."""
    return infer_volume_3d(lambda x: model(x.to(device)), volume, depth=depth)


def _depth_sharded(model, volume: np.ndarray, depth: int, device
                   ) -> Optional[np.ndarray]:
    """JAX's ``infer_depth_sharded`` branch: the exact forward of the whole
    series over the first n ranks (each slab covering the depth receptive
    field; n = 1 is the unsharded forward of the symmetric-extended
    volume), or on a ValueError JAX's message and the Hann windows on
    rank 0. None on a rank that holds no result."""
    halo = 6 + 2 * len(model.body)
    d = volume.shape[0]
    n = min(dist.world(), max(1, d // halo))
    while n > 1 and d % n:
        n -= 1
    mesh = make_depth_mesh(n)  # every rank: a group of the first n
    if mesh is None:
        return None
    try:
        return infer_volume_depth_sharded(model, volume, mesh=mesh,
                                          halo=halo)
    except ValueError as e:  # e.g. depth_downsample model variants
        if mesh.index != 0:
            return None
        print(f"infer_depth_sharded unavailable ({e}); falling back to "
              "Hann depth windows", flush=True)
        return _windows(model, volume, depth, device)

