"""Device windowing of the port (``ctagan_tpu/ops/windowing.py``, the LUT
path): stored integer pixels → the dual-window views by one table gather.

The tables come from the port's host codec (``data/native.py``) over the
stored dtype's whole value range, so ``lut[raw + offset]`` equals the host-
normalised pixel bit for bit on every device: the trainer feeds raw uint16
(``device_windowing``, default on) and windows on the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ctagan_tpu_torch.data.native import dual_window_native

DEFAULT_WC = 50.0
DEFAULT_WW = 400.0

_LUT_CACHE: Dict[tuple, Tuple[np.ndarray, np.ndarray, int]] = {}
_RANGES = {
    np.dtype(np.uint16): (0, 65536),
    np.dtype(np.int16): (-32768, 32768),
    np.dtype(np.uint8): (0, 256),
    np.dtype(np.int8): (-128, 128),
}


def dual_window(raw, wc: float = DEFAULT_WC, ww: float = DEFAULT_WW):
    """Raw stored pixels (0..4095) -> (windowed, full-range) f32 tensors in
    [−1, 1]: the window on HU = raw − 1024, the full range on raw / 4095."""
    win, full = dual_window_native(np.asarray(raw), wc, ww)
    return torch.from_numpy(win), torch.from_numpy(full)


def stored_pixel_luts(dtype, wc: float = DEFAULT_WC, ww: float = DEFAULT_WW):
    """(windowed_lut, fullrange_lut, index_offset) for a stored numpy
    dtype, made by the host codec over the dtype's full range."""
    dt = np.dtype(dtype)
    if dt not in _RANGES:
        raise ValueError(f"unsupported stored-pixel dtype {dt}")
    key = (dt.str, float(wc), float(ww))
    if key not in _LUT_CACHE:
        lo, hi = _RANGES[dt]
        values = np.arange(lo, hi, dtype=np.int64).astype(dt)
        win, full = dual_window_native(values, wc, ww)
        _LUT_CACHE[key] = (win, full, -lo)
    return _LUT_CACHE[key]


_DEVICE_LUTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, int]] = {}


def _device_luts(dtype, wc, ww, device):
    """The tables as tensors on ``device``, uploaded once."""
    key = (np.dtype(dtype).str, float(wc), float(ww), str(device))
    if key not in _DEVICE_LUTS:
        win, full, offset = stored_pixel_luts(dtype, wc, ww)
        _DEVICE_LUTS[key] = (torch.from_numpy(win).to(device),
                             torch.from_numpy(full).to(device), offset)
    return _DEVICE_LUTS[key]


def fullrange_from_stored(raw: torch.Tensor, dtype=np.uint16) -> torch.Tensor:
    """Stored pixels (any integer tensor holding ``dtype``'s values) ->
    full-range [−1, 1], bit-exact with the host codec."""
    _, full, offset = _device_luts(dtype, DEFAULT_WC, DEFAULT_WW, raw.device)
    return full[raw.long() + offset]


def dual_window_from_stored(raw: torch.Tensor, wc: float = DEFAULT_WC,
                            ww: float = DEFAULT_WW, dtype=np.uint16):
    """Stored pixels -> (windowed, full-range), bit-exact with the host
    codec (``read_dual_window_slice``)."""
    win, full, offset = _device_luts(dtype, wc, ww, raw.device)
    idx = raw.long() + offset
    return win[idx], full[idx]
