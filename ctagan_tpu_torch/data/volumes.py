"""Volume-patch dataset of the port (``ctagan_tpu/data/volumes.py``) for
the 3-D family.

Groups a slice list file by series (directory), orders each series by
SliceLocation, and yields paired NCCT/CTA depth windows (D, H, W, 1) in the
full-range [-1, 1] normalization. Training draws a random window start per
access from the generator it is given (the trainer's seeded one); eval
iterates deterministic windows with stride = depth (non-overlapping).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ctagan_tpu_torch.data.datasets import _read_list
from ctagan_tpu_torch.data.dicom import read_dicom
from ctagan_tpu_torch.data.native import (
    dual_window_native,
    resize_nearest_native,
)


def _load_slice(path: str, size: Optional[int]) -> np.ndarray:
    full = dual_window_native(read_dicom(path).pixel_array())[1]
    if size:
        full = resize_nearest_native(np.ascontiguousarray(full, np.float32),
                                     size)
    return full


class VolumePatchDataset:
    def __init__(self, list_file: str, depth: int = 8,
                 size: Optional[int] = None, train: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.depth = depth
        self.size = size
        self.train = train
        self.rng = rng or np.random.default_rng(0)

        by_series: Dict[str, List[Tuple[float, str]]] = {}
        for p in _read_list(list_file):
            try:
                loc = read_dicom(p).slice_location or 0.0
            except Exception:  # an unreadable file is left out, as in JAX
                continue
            by_series.setdefault(os.path.dirname(p), []).append((loc, p))
        self.series: List[List[str]] = []
        for entries in by_series.values():
            entries.sort(key=lambda t: t[0])
            self.series.append([p for _, p in entries])
        if train:
            self._index = list(range(len(self.series)))
        else:  # deterministic non-overlapping windows
            self._index = []
            for si, s in enumerate(self.series):
                for start in range(0, max(len(s) - depth, 0) + 1, depth):
                    self._index.append((si, start))
                if not s or len(s) < depth:
                    self._index.append((si, 0))
            # each window's A path, as its item carries it
            self.files_a = [self.series[si][min(start, len(self.series[si])
                                                - 1)]
                            for si, start in self._index]

    def __len__(self) -> int:
        return len(self._index)

    def _window(self, series: List[str], start: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        idxs = [min(max(start + d, 0), len(series) - 1)
                for d in range(self.depth)]
        a = np.stack([_load_slice(series[i], self.size) for i in idxs])
        b = np.stack([_load_slice(series[i].replace("SE0", "SE1"), self.size)
                      for i in idxs])
        return a[..., None], b[..., None]

    def _train_start(self, index: int) -> Tuple[List[str], int]:
        """A training item's series and its window start, drawn from the
        generator (no draw where the series has one window)."""
        series = self.series[self._index[index % len(self._index)]]
        hi = max(len(series) - self.depth, 0)
        return series, int(self.rng.integers(0, hi + 1)) if hi > 0 else 0

    def skip(self, index: int) -> None:
        """The draws of item ``index`` without its reads: a data-parallel
        loader skips the other ranks' items so (``data/loader.py``)."""
        if self.train:
            self._train_start(index)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.train:
            series, start = self._train_start(index)
        else:
            si, start = self._index[index % len(self._index)]
            series = self.series[si]
        a, b = self._window(series, start)
        return {"A": a, "B": b,
                "A_path": series[min(start, len(series) - 1)]}
