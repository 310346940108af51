"""Synthetic CT slices and paired corpora (``ctagan_tpu/data/fixtures.py``):
the seeded request bodies and training trees of the tests and
``chip_smoke.py``. The same seed gives the same pixels, tree and list files
as the JAX package's functions (the generated UIDs differ)."""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ctagan_tpu_torch.data.dicom import generate_uid, make_ct_slice, write_dicom

_NCCT_VESSEL_HU = 90.0  # unenhanced blood + wall
_CTA_VESSEL_HU = 240.0  # enhanced, inside the WC 50 / WW 400 window


def vessel_tree_mask(size: int, z: float, patient_seed: int,
                     n_vessels: int = 3) -> np.ndarray:
    """A deterministic vessel-tree cross-section at slice ``z``: per patient
    ``n_vessels`` smooth curves whose centres follow a sinusoid in z and
    whose radii breathe slowly, inside the soft-tissue disc."""
    prng = np.random.default_rng(patient_seed)
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((size, size), bool)
    for _ in range(n_vessels):
        ang = prng.uniform(0, 2 * np.pi)
        rad0 = prng.uniform(0.12, 0.28)
        wob = prng.uniform(0.02, 0.06)
        phase = prng.uniform(0, 2 * np.pi)
        freq = prng.uniform(0.15, 0.45)
        drift = prng.uniform(-0.04, 0.04)
        r_v = prng.uniform(0.03, 0.055)
        rr = rad0 + wob * np.sin(freq * z + phase)
        a = ang + drift * z
        cy = size / 2 + size * rr * np.sin(a)
        cx = size / 2 + size * rr * np.cos(a)
        rad = size * r_v * (1.0 + 0.2 * np.sin(0.3 * z + phase))
        mask |= np.hypot(yy - cy, xx - cx) < rad
    r = np.hypot(yy - size / 2, xx - size / 2)
    return mask & (r < size * 0.36)


def synthetic_ct_pixels(rng: np.random.Generator, size: int = 64,
                        contrast: bool = False,
                        vessel_mask: Optional[np.ndarray] = None,
                        noise: Optional[np.ndarray] = None) -> np.ndarray:
    """A plausible stored-value (0..4095) CT slice: air background, a noisy
    soft-tissue disc, a bone rim and vessels. Without ``vessel_mask`` the
    contrast slice gets one fixed noisy vessel; with the shared mask and
    ``noise`` a pair differs only by the vessel enhancement (90 → 240 HU)."""
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(yy - size / 2, xx - size / 2)
    img = np.zeros((size, size), np.float32)
    body = r < size * 0.4
    if noise is None:
        img[body] = 1024 + 40 + rng.normal(0, 12, body.sum())
    else:
        img[body] = 1024 + 40 + noise[body]
    img[(r >= size * 0.38) & (r < size * 0.4)] = 1024 + 600
    if vessel_mask is not None:
        hu = _CTA_VESSEL_HU if contrast else _NCCT_VESSEL_HU
        img[vessel_mask] = 1024 + hu
    elif contrast:
        vy, vx = int(size * 0.5), int(size * 0.42)
        vessel = np.hypot(yy - vy, xx - vx) < size * 0.04
        img[vessel] = 1024 + 350 + rng.normal(0, 10, vessel.sum())
    return np.clip(img, 0, 4095).astype(np.uint16)


def make_corpus(root: str, n_patients: int = 2, slices_per_patient: int = 3,
                size: int = 64, seed: int = 0,
                lists: Tuple[str, ...] = ("train", "val", "test")) -> dict:
    """Write ``root/patient<p>/ST0/{SE0,SE1}/IM<s>`` paired NCCT/CTA slices
    and the list files (NCCT paths, split evenly over ``lists``); returns
    {list_name: path}."""
    rng = np.random.default_rng(seed)
    all_paths: List[str] = []
    for p in range(n_patients):
        pdir = os.path.join(root, f"patient{p}", "ST0")
        se0, se1 = os.path.join(pdir, "SE0"), os.path.join(pdir, "SE1")
        os.makedirs(se0, exist_ok=True)
        os.makedirs(se1, exist_ok=True)
        uid0, uid1 = generate_uid(), generate_uid()
        for s in range(slices_per_patient):
            vmask = vessel_tree_mask(size, float(s), seed * 1009 + p)
            shared_noise = rng.normal(0, 12, (size, size)).astype(np.float32)
            ncct = synthetic_ct_pixels(rng, size, contrast=False,
                                       vessel_mask=vmask, noise=shared_noise)
            cta = synthetic_ct_pixels(rng, size, contrast=True,
                                      vessel_mask=vmask, noise=shared_noise)
            common = dict(patient_id=f"P{p}", accession=f"A{p}",
                          slice_location=float(s) * 5.0)
            p0 = os.path.join(se0, f"IM{s}")
            p1 = os.path.join(se1, f"IM{s}")
            write_dicom(make_ct_slice(ncct, series_description="C-",
                                      series_uid=uid0, **common), p0)
            write_dicom(make_ct_slice(cta, series_description="C+",
                                      series_uid=uid1, **common), p1)
            all_paths.append(p0)
    out = {}
    per = max(1, len(all_paths) // len(lists))
    for i, name in enumerate(lists):
        chunk = all_paths[i * per: (i + 1) * per] or all_paths[:1]
        lp = os.path.join(root, f"{name}.txt")
        with open(lp, "w") as f:
            f.write("\n".join(chunk) + "\n")
        out[name] = lp
    return out
