"""The list-file datasets of the port (``ctagan_tpu/data/datasets.py``).

Each list file holds NCCT slice paths containing ``SE0``; the CTA partner is
the same path with ``SE0`` → ``SE1``. Two families:

- :class:`PairedSliceDataset` (pix2pix, CycleGAN, RegGAN): an item is the
  full-range pair {A, B} in [−1, 1], or with ``raw_feed`` the stored uint16
  pixels that the trainer maps to full range on the device. ``unaligned``
  draws a fresh B per visit; ``context_slices`` stacks the ±k neighbours
  of A's series on the channel axis.
- :class:`DualWindowDataset` (HD): an item is {A1, A2, B1, B2}, the
  (windowed, full-range) views of input and target, or with ``raw_feed``
  the stored pixels {A, B}. The training list is re-oversampled every epoch
  by :meth:`~DualWindowDataset.resample`: ``traind1`` appended once,
  ``traind2`` a random 3..5 times.
"""
from __future__ import annotations

import os
import threading
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


def read_fullrange_slice(path: str) -> np.ndarray:
    """Stored pixels -> full range [−1, 1]: negatives to 0, /4095, centred
    (f32, the host codec's arithmetic)."""
    return dual_window_native(_stored_pixels(path))[1]


class PairedSliceDataset:
    """Single-channel paired dataset (A = NCCT SE0, B = CTA SE1)."""

    def __init__(self, list_file: str, sort: bool = True,
                 unaligned: bool = False, size: Optional[int] = None,
                 context_slices: int = 1, seed: int = 0,
                 raw_feed: bool = False):
        files_a = _read_list(list_file)
        if sort:
            files_a = sorted(files_a)
        self.files_a = files_a
        self.files_b = _pair(files_a)
        self.unaligned = unaligned
        self.size = size
        self.seed = seed
        self.raw_feed = raw_feed
        # unaligned B draws: visit ``count`` of ``index`` draws from the key
        # (seed, index, count), so the stream does not depend on the order
        # in which the loader's threads visit the items
        self._b_counts: Dict[int, int] = {}
        self._b_lock = threading.Lock()
        if context_slices % 2 != 1:
            raise ValueError("context_slices must be odd")
        self.context_slices = context_slices
        # index -> (the indices of its series in list order, its position)
        self._series_index: Dict[int, tuple] = {}
        if context_slices > 1:
            by_series: Dict[str, List[int]] = {}
            for i, p in enumerate(files_a):
                by_series.setdefault(os.path.dirname(p), []).append(i)
            for idxs in by_series.values():
                for pos, i in enumerate(idxs):
                    self._series_index[i] = (idxs, pos)

    def __len__(self) -> int:
        return len(self.files_a)

    def _load(self, path: str) -> np.ndarray:
        img = (_stored_pixels(path) if self.raw_feed
               else read_fullrange_slice(path))
        if self.size:
            img = _resize_nearest_np(img, self.size)
        return img[..., None]

    def _load_context(self, index: int) -> np.ndarray:
        """The ±k neighbours of A's slice in its series, clamped at the
        series' ends, stacked on the channel axis (the slice at the
        centre)."""
        idxs, pos = self._series_index[index]
        half = self.context_slices // 2
        return np.stack([
            self._load(self.files_a[idxs[min(max(pos + off, 0),
                                             len(idxs) - 1)]])[..., 0]
            for off in range(-half, half + 1)], axis=-1)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        a_path = self.files_a[index % len(self.files_a)]
        if self.unaligned:
            with self._b_lock:
                count = self._b_counts[index] = self._b_counts.get(index,
                                                                   0) + 1
            rng = np.random.default_rng((self.seed, index, count))
            b_path = self.files_b[int(rng.integers(0, len(self.files_b)))]
        else:
            b_path = self.files_b[index % len(self.files_b)]
        if self.context_slices > 1:
            a_img = self._load_context(index % len(self.files_a))
        else:
            a_img = self._load(a_path)
        return {"A": a_img, "B": self._load(b_path), "A_path": a_path}


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
