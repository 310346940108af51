"""Offline 3-D registration stage of the port
(``ctagan_tpu/data/registration.py``): the per-patient pipeline that
aligns a patient's CTA series (SE1) onto the NCCT series (SE0) and writes
the warped slices back into the SE1 DICOM files.

The reference runs ANTs SyN (``dcm2nii_sitk`` → ``ants.registration(SyN)``
→ ``ants.apply_transforms`` → a per-slice writeback with rot90/flip axis
fixes). Here, as in the JAX package:

- the same orchestration, through an importable ``ants`` module or an
  injected ``ants_module``;
- without one, the port's own diffeomorphic demons
  (``ops/registration3d.py``) after a rigid phase-correlation pre-shift,
  on the card unless ``device`` names another;
- ``register_translation``, rigid translation alone by phase correlation.

The phase correlation, the pre-shift and the writeback stay on the host,
in numpy.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np

from ctagan_tpu_torch.data.dicom import read_dicom, write_dicom


def _load_series(series_dir: str) -> Tuple[np.ndarray, List[str]]:
    """Stack a series directory into a (N, H, W) HU volume ordered by
    SliceLocation, keeping only the longest series in the directory (by
    SeriesInstanceUID), as the reference's ``dcm2nii_sitk`` keeps the UID
    with the most files: exports often mix a scout into the directory."""
    entries = []
    for f in sorted(os.listdir(series_dir)):
        if not f.startswith("IM"):
            continue
        path = os.path.join(series_dir, f)
        ds = read_dicom(path)
        uid = ds.series_instance_uid or ""
        entries.append((uid, ds.slice_location or 0.0, path, ds))
    by_uid: dict = {}
    for e in entries:
        by_uid.setdefault(e[0], []).append(e)
    if not by_uid:
        raise FileNotFoundError(f"no IM* DICOM slices in {series_dir}")
    longest = max(by_uid.values(), key=len)
    longest.sort(key=lambda t: t[1])
    vol = np.stack([e[3].hu_array() for e in longest])
    return vol, [e[2] for e in longest]


# The reference round-trips DICOM -> NIfTI (sitk) -> ants -> numpy and then
# repairs the orientation with rot90(arr, -1), flip(arr, 1) and a reversed
# z index. The pipeline never leaves DICOM pixel space, so it emulates that
# ledger with an exactly invertible pair: ``dicom_to_nii`` gives the array
# ants would see, ``nii_to_dicom`` applies the reference's recovery chain.


def dicom_to_nii(vol: np.ndarray) -> np.ndarray:
    """(N, H, W) slice-ordered DICOM volume -> (X, Y, Z) NIfTI-view array
    (inverse of ``nii_to_dicom``)."""
    a = np.transpose(vol[::-1], (1, 2, 0))  # z last, reversed
    a = np.flip(a, axis=1)
    return np.rot90(a, 1)


def nii_to_dicom(nii: np.ndarray) -> np.ndarray:
    """The reference's recovery chain: rot90(-1), flip(axis=1), z
    reversed."""
    a = np.rot90(nii, -1)
    a = np.flip(a, axis=1)
    return np.transpose(a, (2, 0, 1))[::-1]


def phase_correlation_shift(fixed: np.ndarray,
                            moving: np.ndarray) -> np.ndarray:
    """Integer 3-D shift (dz, dy, dx) aligning ``moving`` to ``fixed`` by
    phase correlation."""
    f = np.fft.fftn(fixed)
    m = np.fft.fftn(moving)
    cross = f * np.conj(m)
    cross /= np.abs(cross) + 1e-8
    corr = np.fft.ifftn(cross).real
    peak = np.unravel_index(np.argmax(corr), corr.shape)
    shift = np.array(peak, np.int64)
    for i, s in enumerate(corr.shape):
        if shift[i] > s // 2:
            shift[i] -= s
    return shift


def register_translation(root: str, patient: str,
                         st: str = "ST0") -> np.ndarray:
    """Align a patient's CTA (SE1) onto the NCCT (SE0) by rigid translation
    and write the shifted slices back into the SE1 DICOMs (the reference's
    in-place writeback). Returns the applied (dz, dy, dx) shift."""
    base = os.path.join(root, patient, st)
    fixed, _ = _load_series(os.path.join(base, "SE0"))
    moving, paths = _load_series(os.path.join(base, "SE1"))
    n = min(fixed.shape[0], moving.shape[0])
    shift = phase_correlation_shift(fixed[:n], moving[:n])
    warped = np.roll(moving, tuple(shift), axis=(0, 1, 2))
    _writeback_series(paths, warped)
    return shift


def ants_available() -> bool:
    try:
        import ants  # noqa: F401

        return True
    except ImportError:
        return False


def _writeback_series(paths: List[str], hu_vol: np.ndarray):
    """In-place per-slice writeback: HU -> stored values through the
    slice's own rescale intercept, clipped to 0..4095, cast per
    BitsAllocated (int16 / int8; anything else raises)."""
    for i, path in enumerate(paths):
        ds = read_dicom(path)
        stored = hu_vol[i] - ds.rescale_intercept
        ds.set_pixel_data(np.clip(stored, 0, 4095))
        write_dicom(ds, path)


def register_demons_volumes(fixed: np.ndarray, moving: np.ndarray,
                            device=None, times: Optional[dict] = None,
                            **kw) -> np.ndarray:
    """Deformable alignment of ``moving`` onto ``fixed`` with the port's
    multi-scale diffeomorphic demons on ``device`` (default the card). A
    rigid phase-correlation pre-shift on the host absorbs the couch
    translation, so the pyramid carries only the deformable rest. Returns
    the warped volume (same shape and HU scale as ``moving``). ``times``,
    if given, receives the seconds of the phase correlation, the
    registrar's parts and the final warp."""
    import torch

    from ctagan_tpu_torch.ops.registration3d import demons_register, warp3d

    t0 = time.perf_counter()
    n = min(fixed.shape[0], moving.shape[0])
    shift = phase_correlation_shift(fixed[:n], moving[:n])
    rigid = np.roll(moving, tuple(shift), axis=(0, 1, 2)).astype(np.float32)
    if times is not None:
        times["phase correlation"] = time.perf_counter() - t0
    phi = demons_register(fixed.astype(np.float32), rigid, device=device,
                          times=times, **kw)
    t0 = time.perf_counter()
    out = warp3d(torch.from_numpy(rigid).to(phi.device), phi).cpu().numpy()
    if times is not None:
        times["warp"] = time.perf_counter() - t0
    return out


def align_patient(
    root: str,
    patient: str,
    st: str = "ST0",
    ants_module=None,
    min_slices: int = 5,
    keep_first_unwarped: bool = True,
    method: str = "auto",
    device=None,
    times: Optional[dict] = None,
):
    """The per-patient offline alignment of one series pair:

    1. load SE0 (fixed NCCT) and SE1 (moving CTA), the longest series in
       each directory;
    2. skip a pair whose SE0 directory holds fewer than ``min_slices``
       files;
    3. register: ANTs SyN through the NIfTI-view emulation when available
       (``ants_module`` injects one; antspyx is used when importable),
       otherwise the port's demons (``register_demons_volumes`` on
       ``device``, default the card); ``method`` forces one of ``auto |
       syn | demons | translation``;
    4. write SE0 back through the round trip (the identity) and SE1 from
       the warped volume, with the reference's quirk that the NIfTI z=0
       slice, the last in DICOM slice order, is written unwarped (kept
       under ``keep_first_unwarped``).

    Returns "syn", "demons" or "translation" for the method used, or None
    if skipped. ``times``, if given, receives the seconds of the load, the
    registration's parts and the writeback.
    """
    base = os.path.join(root, patient, st)
    se0_dir, se1_dir = os.path.join(base, "SE0"), os.path.join(base, "SE1")
    if len(os.listdir(se0_dir)) < min_slices:
        return None
    t0 = time.perf_counter()
    fixed, fixed_paths = _load_series(se0_dir)
    moving, paths = _load_series(se1_dir)
    if times is not None:
        times["load"] = time.perf_counter() - t0

    if method not in ("auto", "syn", "demons", "translation"):
        raise ValueError(f"unknown registration method {method!r}")
    ants = ants_module
    if ants is None and method in ("auto", "syn") and ants_available():
        import ants as _ants

        ants = _ants
    if method == "syn" and ants is None:
        raise ImportError("method='syn' requires antspyx (or a mock module)")
    if method in ("demons", "translation"):
        ants = None

    if ants is not None:
        nii_f = dicom_to_nii(fixed.astype(np.float32))
        nii_m = dicom_to_nii(moving.astype(np.float32))
        fi = ants.from_numpy(nii_f)
        mi = ants.from_numpy(nii_m)
        tx = ants.registration(fixed=fi, moving=mi, type_of_transform="SyN")
        wi = ants.apply_transforms(
            fixed=fi, moving=mi, transformlist=tx["fwdtransforms"],
            interpolator="linear")
        # the reference pins direction/origin/spacing to the fixed image;
        # the numpy round trip has no header, only the voxel grid matters
        warped_nii = wi.numpy() if hasattr(wi, "numpy") else np.asarray(wi)
        if keep_first_unwarped:
            warped_nii = np.array(warped_nii)
            warped_nii[:, :, 0] = nii_m[:, :, 0]
        warped = nii_to_dicom(warped_nii)
        used = "syn"
    elif method == "translation":
        n = min(fixed.shape[0], moving.shape[0])
        shift = phase_correlation_shift(fixed[:n], moving[:n])
        warped = np.roll(moving, tuple(shift), axis=(0, 1, 2))
        used = "translation"
    else:
        warped = register_demons_volumes(
            fixed.astype(np.float32), moving.astype(np.float32),
            device=device, times=times)
        if keep_first_unwarped:
            # the reference leaves the NIfTI z=0 slice unwarped; in DICOM
            # slice order that is the last slice (z reversed)
            warped = np.array(warped)
            warped[-1] = moving[-1]
        used = "demons"

    t0 = time.perf_counter()
    # SE0 writeback: the identity through the ledger, the same in-place
    # rewrite the reference performs
    _writeback_series(
        fixed_paths, nii_to_dicom(dicom_to_nii(fixed.astype(np.float32))))
    _writeback_series(paths, warped)
    if times is not None:
        times["writeback"] = time.perf_counter() - t0
    return used


def register_syn(root: str, patient: str, st: str = "ST0",
                 ants_module=None):
    """ANTs SyN deformable registration (the reference's behaviour). Raises
    when antspyx is not installed and no module is injected."""
    if ants_module is None and not ants_available():
        raise ImportError(
            "antspyx not installed; use register_translation for the "
            "dependency-free rigid stage")
    return align_patient(root, patient, st, ants_module=ants_module)


def invert_lists(list_file: str) -> int:
    """The reference's ``invert()`` post-pass: flip (axis=1) every SE0
    slice in the list and its SE1 partner, rewriting the files in place.
    Returns the number of slice pairs processed."""
    with open(list_file) as f:
        paths = [line.strip("\n") for line in f if line.strip()]
    paths.sort()
    paths.sort(key=lambda x: (x.split("IM")[0], int(x.split("IM")[1])))
    n = 0
    for p in paths:
        for q in (p, p.replace("SE0", "SE1")):
            ds = read_dicom(q)
            ds.set_pixel_data(np.flip(ds.pixel_array(), axis=1))
            write_dicom(ds, q)
        n += 1
    return n
