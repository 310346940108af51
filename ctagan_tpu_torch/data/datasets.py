"""The dual-window dataset of the port (``ctagan_tpu/data/datasets.py::
DualWindowDataset``).

Each list file holds NCCT slice paths containing ``SE0``; the CTA partner is
the same path with ``SE0`` → ``SE1``. An item is {A1, A2, B1, B2}, the
(windowed, full-range) views of input and target, or with ``raw_feed`` the
stored uint16 pixels {A, B} that the trainer windows on the device. The
training list is re-oversampled every epoch by :meth:`resample`: ``traind1``
appended once, ``traind2`` a random 3..5 times.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ctagan_tpu_torch.data.dicom import read_dicom
from ctagan_tpu_torch.data.native import dual_window_native
from ctagan_tpu_torch.data.native import (  # torch F.interpolate 'nearest'
    resize_nearest_native as _resize_nearest_np,
)


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip("\n") for line in f if line.strip()]


def _pair(paths: Sequence[str]) -> List[str]:
    return [p.replace("SE0", "SE1") for p in paths]


def _stored_pixels(path: str) -> np.ndarray:
    return read_dicom(path).pixel_array()


class DualWindowDataset:
    """Dual-window paired dataset with per-epoch stochastic oversampling of
    the hard-example lists."""

    def __init__(self, list_file: str, oversample: bool = False,
                 sort: bool = True, rng: Optional[np.random.Generator] = None,
                 size: Optional[int] = None, raw_feed: bool = False):
        self.list_file = list_file
        self.base = _read_list(list_file)
        self.oversample = oversample
        self.sort = sort
        self.size = size
        self.raw_feed = raw_feed
        self.files_a: List[str] = []
        self.files_b: List[str] = []
        self.resample(rng or np.random.default_rng())

    def resample(self, rng: np.random.Generator) -> None:
        """Rebuild the file list: base + traind1 once + traind2 ×
        randint(3, 6)."""
        files = list(self.base)
        if self.oversample:
            d1 = self.list_file.replace("train", "traind1")
            d2 = self.list_file.replace("train", "traind2")
            if os.path.exists(d1):
                files += _read_list(d1)
            if os.path.exists(d2):
                for _ in range(int(rng.integers(3, 6))):
                    files += _read_list(d2)
        if self.sort:
            files = sorted(files)
        self.files_a = files
        self.files_b = _pair(files)

    def __len__(self) -> int:
        return len(self.files_a)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        a_path = self.files_a[index % len(self.files_a)]
        b_path = self.files_b[index % len(self.files_b)]
        a, b = _stored_pixels(a_path), _stored_pixels(b_path)
        if self.raw_feed:
            if self.size:
                a = _resize_nearest_np(a, self.size)
                b = _resize_nearest_np(b, self.size)
            return {"A": a[..., None], "B": b[..., None], "A_path": a_path}
        a1, a2 = dual_window_native(a)
        b1, b2 = dual_window_native(b)
        if self.size:
            a1, a2, b1, b2 = (_resize_nearest_np(x, self.size)
                              for x in (a1, a2, b1, b2))
        return {"A1": a1[..., None], "A2": a2[..., None],
                "B1": b1[..., None], "B2": b2[..., None], "A_path": a_path}
