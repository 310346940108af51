"""Test-time evaluation and the synthetic-CTA DICOM writeback of the port
(``ctagan_tpu/train/evaluation.py``).

A synthetic CTA slice is scored against the real one twice: in its SE1
header's display window (``to_windowdata``, 0.3 body masks) and in the
full-range [−1, 1] space under the same masks. :class:`DicomWriteback`
writes ``image_save/ST0/<i>/{SE0,SE1}`` (copies of the sources) and
``image_save/ST1/<i>/SE2`` (the synthetic series under a fresh
SeriesInstanceUID). With an LPIPS function (``ops/lpips.py``) a pair also
scores LPIPSw and LPIPS on the same masked views.
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ctagan_tpu_torch.data.dicom import generate_uid, read_dicom, write_dicom
from ctagan_tpu_torch.ops.metrics import masked_mae, masked_psnr, ssim, uqi
from ctagan_tpu_torch.ops.windowing import (
    body_mask,
    mask_background_to_air,
    to_windowdata,
)

# the rows of _metric_suite's matrix, in JAX's key order
METRIC_KEYS = ("MAEw", "PSNRw", "SSIMw", "UQIw", "MAE", "PSNR", "SSIM", "UQI")


def _threshold_mask(img, thr: float = 0.3) -> torch.Tensor:
    return body_mask(img, thr)


def _masked_views(fake_b, real_b, wc, ww):
    """The reference's masking protocol (HdTrainer.py:481-538): the windowed
    real gives mask ``bb``; the windowed fake is masked by ``bb``, then by
    its own mask ``cc``; the full-range pair takes ``cc`` (fake) and ``bb``
    (real); masked-out pixels become −1. Returns (c_m, b_m, fake_m,
    real_m)."""
    b = to_windowdata(real_b, wc, ww)
    bb = _threshold_mask(b)
    b_m = mask_background_to_air(b, bb)

    c = to_windowdata(fake_b, wc, ww) * bb
    cc = _threshold_mask(c)
    c_m = mask_background_to_air(c, cc)

    fake_m = mask_background_to_air(fake_b, cc)
    real_m = mask_background_to_air(real_b, bb)
    return c_m, b_m, fake_m, real_m


def _metric_suite(fake_b, real_b, wc, ww) -> torch.Tensor:
    """The eight window and full-range metrics of (H, W) slices or an
    (N, H, W) batch with per-slice (N,) windows, as one (8,) or (8, N)
    tensor in :data:`METRIC_KEYS` order."""
    c_m, b_m, fake_m, real_m = _masked_views(fake_b, real_b, wc, ww)
    return torch.stack([
        masked_mae(c_m, b_m), masked_psnr(c_m, b_m), ssim(c_m, b_m),
        uqi(c_m, b_m),
        masked_mae(fake_m, real_m), masked_psnr(fake_m, real_m),
        ssim(fake_m, real_m), uqi(fake_m, real_m),
    ])


def evaluate_pair(fake_b, real_b, wc: float, ww: float,
                  lpips_fn: Optional[Callable] = None) -> Dict[str, float]:
    """Score one full-range (H, W) slice pair in window and raw space; with
    ``lpips_fn`` also LPIPSw (the masked window views) and LPIPS (the
    masked full-range views)."""
    vals = _metric_suite(fake_b, real_b, wc, ww).cpu().numpy()
    out = {k: float(v) for k, v in zip(METRIC_KEYS, vals)}
    if lpips_fn is not None:
        c_m, b_m, fake_m, real_m = _masked_views(fake_b, real_b, wc, ww)
        out["LPIPSw"] = float(lpips_fn(c_m, b_m))
        out["LPIPS"] = float(lpips_fn(fake_m, real_m))
    return out


class DicomWriteback:
    """Stateful SE2 writer with the reference's per-patient layout: a new
    patient index ``i`` and SeriesInstanceUID whenever the source series
    changes (HdTrainer.py:456-476). Several writers (one a data-parallel
    rank) fill one tree when each is shown every slice in order, writing
    its own and passing over (:meth:`skip`) the others', and all share
    ``series_uid_root``: patient ``i``'s series is then
    ``<series_uid_root>.<i>`` in every writer."""

    def __init__(self, image_save_root: str,
                 series_uid_root: Optional[str] = None):
        self.root = image_save_root
        self.uid_root = series_uid_root
        self.current_series = None
        self.patient_idx = 0
        self.series_uid = None
        self.out0 = self.out1 = self.out2 = None

    def skip(self, a_path: str) -> None:
        """Pass over a slice that another writer writes."""
        series_dir = a_path.split("IM")[0]
        if series_dir != self.current_series:
            self.current_series = series_dir
            self.patient_idx += 1
            self.series_uid = (generate_uid() if self.uid_root is None else
                               f"{self.uid_root}.{self.patient_idx}")
            idx = str(self.patient_idx)
            self.out0 = os.path.join(self.root, "ST0", idx, "SE0")
            self.out1 = os.path.join(self.root, "ST0", idx, "SE1")
            self.out2 = os.path.join(self.root, "ST1", idx, "SE2")

    def write(self, a_path: str, fake_b: np.ndarray) -> None:
        self.skip(a_path)
        for d in (self.out0, self.out1, self.out2):
            os.makedirs(d, exist_ok=True)

        name = (a_path.split("SE0/")[-1] if "SE0/" in a_path
                else os.path.basename(a_path))
        b_path = a_path.replace("SE0", "SE1")
        ds = read_dicom(b_path)
        fake_b = np.asarray(fake_b)
        if np.issubdtype(fake_b.dtype, np.integer):
            # stored values already, de-normalized on the device
            newimg = fake_b
        else:
            # [−1, 1] -> stored values (HdTrainer.py:539)
            newimg = (fake_b + 1.0) * 0.5 * 4095.0
        ds.set_pixel_data(newimg)
        ds.series_instance_uid = self.series_uid
        shutil.copy(a_path, os.path.join(self.out0, name))
        shutil.copy(b_path, os.path.join(self.out1, name))
        write_dicom(ds, os.path.join(self.out2, name))


def aggregate(metric_rows) -> Dict[str, float]:
    """Mean of each key over the rows."""
    if not metric_rows:
        return {}
    keys = metric_rows[0].keys()
    return {k: float(np.mean([r[k] for r in metric_rows])) for k in keys}
