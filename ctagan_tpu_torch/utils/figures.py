"""Qualitative figures of the port (``ctagan_tpu/utils/figures.py``): 8-bit
grayscale PNG panels without cv2 or matplotlib.

The reference's ``testt()`` writes side-by-side panels (input, target,
synthetic, and zoomed crops) with cv2. This module is a copy of the JAX
package's numpy and zlib one: a minimal grayscale PNG codec and the same
panel builder, so the two write the same bytes.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG (filter 0 on
    every row, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png_gray expects uint8")
    h, w = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # gray, 8-bit
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png_gray(path: str) -> np.ndarray:
    """Read back an 8-bit grayscale PNG of filters 0 and 2 (what
    :func:`write_png_gray` writes)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    w = h = 0
    idat = b""
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack_from(">IIBB", data)
            if (depth, color) != (8, 0):
                raise ValueError(f"{path}: not 8-bit grayscale")
        elif tag == b"IDAT":
            idat += data
        pos += 12 + length
    raw = zlib.decompress(idat)
    img = np.zeros((h, w), np.uint8)
    stride = w + 1
    prev = np.zeros(w, np.uint8)
    for i in range(h):
        row = raw[i * stride:(i + 1) * stride]
        ftype, rowdata = row[0], np.frombuffer(row[1:], np.uint8).copy()
        if ftype == 0:
            out = rowdata
        elif ftype == 2:  # up
            out = (rowdata + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        img[i] = out
        prev = img[i]
    return img


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> the uint8 display range (the reference's
    ``tensor2image``): 127.5·x + 127.5, clipped, truncated."""
    return np.clip(127.5 * np.asarray(img, np.float32) + 127.5, 0,
                   255).astype(np.uint8)


def make_panel(images: Sequence[np.ndarray],
               zoom_center: Optional[tuple] = None,
               zoom_size: int = 128) -> np.ndarray:
    """[-1, 1] slices side by side as one uint8 panel; with
    ``zoom_center`` each is followed by a 2× nearest zoom of the
    ``zoom_size`` crop around it (the ``testt()`` layout)."""
    panels: List[np.ndarray] = [to_uint8(im) for im in images]
    if zoom_center is not None:
        cy, cx = zoom_center
        half = zoom_size // 2
        for im in images:
            u8 = to_uint8(im)
            crop = u8[max(cy - half, 0):cy + half, max(cx - half, 0):cx + half]
            up = np.kron(crop, np.ones((2, 2), np.uint8))  # 2x nearest
            pad_h = panels[0].shape[0] - up.shape[0]
            up = np.pad(up, ((0, max(pad_h, 0)), (0, 0)))[:panels[0].shape[0]]
            panels.append(up)
    target_h = max(p.shape[0] for p in panels)
    panels = [np.pad(p, ((0, target_h - p.shape[0]), (0, 0))) for p in panels]
    return np.hstack(panels)


def save_qualitative_panel(out_dir: str, name: str,
                           images: Sequence[np.ndarray],
                           zoom_center: Optional[tuple] = None) -> str:
    """:func:`make_panel` written to ``<out_dir>/<name>.png``; returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    write_png_gray(path, make_panel(images, zoom_center))
    return path
