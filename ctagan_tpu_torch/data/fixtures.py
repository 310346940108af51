"""Synthetic CT slices (``ctagan_tpu/data/fixtures.py``): the seeded request
bodies of the tests and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np


def synthetic_ct_pixels(rng: np.random.Generator,
                        size: int = 64) -> np.ndarray:
    """A plausible stored-value (0..4095) non-contrast CT slice: air
    background, a noisy soft-tissue disc and a bone rim. The same ``rng``
    state gives the same pixels as the JAX package's function."""
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    img = np.zeros((size, size), np.float32)
    body = r < size * 0.4
    img[body] = 1024 + 40 + rng.normal(0, 12, body.sum())
    img[(r >= size * 0.38) & (r < size * 0.4)] = 1024 + 600
    return np.clip(img, 0, 4095).astype(np.uint16)
