"""Host preprocessing of the serving path (``ctagan_tpu/data/native.py``).

The dual-window normalization and the nearest resize, in numpy. The JAX
package runs them through its C++ host library when that builds, and
through this same numpy arithmetic when it does not; the two agree bit for
bit on every 16-bit stored value.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def dual_window_native(raw: np.ndarray, wc: float = 50.0,
                       ww: float = 400.0) -> Tuple[np.ndarray, np.ndarray]:
    """Stored values -> (window image, full-range image), both f32 in
    [-1, 1]: the window is HU = stored − 1024 through the (wc, ww) display
    window, truncated to 0..255; the full range is stored / 4095."""
    hu = raw.astype(np.float32) - 1024.0
    win_min = (2 * wc - ww) / 2.0 + 0.5
    d = 255.0 / ((2 * wc + ww) / 2.0 + 0.5 - win_min)
    img1 = np.trunc((hu - win_min) * d)
    np.clip(img1, 0, 255, out=img1)
    img1 = (img1 / 255.0 - 0.5) * 2.0
    img2 = raw.astype(np.float32)
    img2[img2 < 0] = 0
    img2 = (img2 / 4095.0 - 0.5) * 2.0
    return img1.astype(np.float32), img2.astype(np.float32)


def resize_nearest_native(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest resize of an (H, W) image to (size, size): source index
    floor(i · H / size)."""
    h, w = img.shape
    if (h, w) == (size, size):
        return img
    ys = np.floor(np.arange(size) * (h / size)).astype(np.int64)
    xs = np.floor(np.arange(size) * (w / size)).astype(np.int64)
    return img[np.ix_(ys, xs)]
