"""Device windowing of the port (``ctagan_tpu/ops/windowing.py``).

The LUT path: stored integer pixels → the dual-window views by one table
gather. The tables come from the port's host codec (``data/native.py``)
over the stored dtype's whole value range, so ``lut[raw + offset]`` equals
the host-normalised pixel bit for bit on every device: the trainer feeds
raw uint16 (``device_windowing``, default on) and windows on the card.

The eval path's display-window transforms (``to_windowdata``,
``body_mask``, ``mask_background_to_air`` and the arithmetic forms under
them) are torch functions in JAX's order of f32 operations, below.
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


# -- display-window transforms of the eval path (JAX ``ops/windowing.py``) --
#
# Torch functions on tensors of any leading shape, f32 throughout, in JAX's
# order of operations. ``wc``/``ww`` are a number, a 0-d tensor or one value
# per sample (an (N,) tensor, broadcast over each sample's trailing H, W).
# Every division is tensor by tensor on the data's device: a CUDA tensor
# divided by a Python number is computed as a multiply by its reciprocal,
# which moves a value by an ulp and a pixel at a truncation boundary by a
# whole window level.


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _per_sample(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) per-sample values -> (N, 1, ..., 1) against an ``ndim`` image."""
    return t.reshape(t.shape + (1,) * (ndim - t.dim())) if t.dim() else t


def _window_limits(wc, ww, device=None):
    """win_min = (2·WC − WW)/2 + 0.5, win_max = (2·WC + WW)/2 + 0.5 in f32
    (the reference's datasets.py:49-50)."""
    wc, ww = _f32(wc, device), _f32(ww, device)
    two, half = _f32(2.0, device), _f32(0.5, device)
    win_min = (two * wc - ww) / two + half
    win_max = (two * wc + ww) / two + half
    return win_min, win_max


def window_normalize(hu, wc=DEFAULT_WC, ww=DEFAULT_WW) -> torch.Tensor:
    """HU -> the clinical window in [−1, 1]: scale into the window,
    truncate toward zero, clip to [0, 255], /255, then to [−1, 1]."""
    hu = _f32(hu)
    win_min, win_max = (_per_sample(t, hu.dim())
                        for t in _window_limits(wc, ww, hu.device))
    c255, half = _f32(255.0, hu.device), _f32(0.5, hu.device)
    d_factor = c255 / (win_max - win_min)
    img = torch.trunc((hu - win_min) * d_factor)
    img = torch.clamp(img, 0.0, 255.0) / c255
    return (img - half) / half


def fullrange_normalize(raw) -> torch.Tensor:
    """Raw stored values (0..4095) -> [−1, 1]: negatives to 0, /4095."""
    raw = _f32(raw)
    half = _f32(0.5, raw.device)
    img = torch.clamp(raw, min=0.0) / _f32(4095.0, raw.device)
    return (img - half) / half


def to_windowdata(image, wc, ww) -> torch.Tensor:
    """A full-range [−1, 1] image -> window space [−1, 1] (the reference's
    HdTrainer.py:41-64): back to 0..4095, exact zeros to −2000 (air outside
    the reconstruction circle), −1024 to HU, then the (WC, WW) window."""
    image = _f32(image)
    data = (image + 1.0) * 0.5 * 4095.0
    data = torch.where(data == 0.0, -2000.0, data)
    return window_normalize(data - 1024.0, wc, ww)


def body_mask(img, threshold: float = 0.3) -> torch.Tensor:
    """1 where ``img >= threshold``, else 0 (f32)."""
    return (_f32(img) >= threshold).to(torch.float32)


def mask_background_to_air(img, mask) -> torch.Tensor:
    """``img · mask`` with every zero, masked out or not, set to −1 (the
    reference's ``x = x*mask; x[x==0] = -1``: an exact 0 inside the mask
    becomes −1 too, kept)."""
    masked = _f32(img) * mask
    return torch.where(masked == 0.0, -1.0, masked)
