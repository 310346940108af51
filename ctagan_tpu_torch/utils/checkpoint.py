"""Checkpoints of the port (``ctagan_tpu/utils/checkpoint.py``): metric-
stamped, atomic, resumable.

A checkpoint is one ``torch.save`` of ``{"state": {...}, "epoch", "lr",
"lr_d"}`` named ``<prefix>_e<epoch>[_<psnr>_<ssim>].pt``: the JAX package's
naming under the port's own suffix, so JAX's ``.ckpt`` pattern never
matches a port file.

The port also reads the JAX package's flax msgpack ``.ckpt`` files
(:func:`load_jax_checkpoint`, through the pure-Python decoder in
``utils/msgpack.py``): :func:`find_checkpoints` lists both suffixes under
one prefix, newest epoch first, the port's ``.pt`` first on an equal
epoch. JAX's orbax ``.ocp`` directories are listed too, and loading one
raises (ROADMAP M6, the orbax reader).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

SUFFIX = ".pt"
JAX_SUFFIX = ".ckpt"
_CKPT_RE = re.compile(r"^(?P<prefix>.+?)_e(?P<epoch>\d+)"
                      r"(?:_(?P<metrics>[-\d._]+))?\.(?P<suffix>pt|ckpt|ocp)$")
# on an equal epoch: the port's own file, then JAX's msgpack, then orbax
_SUFFIX_RANK = {"pt": 2, "ckpt": 1, "ocp": 0}


def checkpoint_name(prefix: str, epoch: int, psnr: Optional[float] = None,
                    ssim: Optional[float] = None) -> str:
    """``<prefix>_e<epoch>[_<psnr>_<ssim>].pt``, the metrics rounded to 4
    places as the JAX package stamps them."""
    if psnr is not None and ssim is not None:
        return f"{prefix}_e{epoch}_{round(psnr, 4)}_{round(ssim, 4)}{SUFFIX}"
    return f"{prefix}_e{epoch}{SUFFIX}"


def save_checkpoint(save_root: str, prefix: str, epoch: int,
                    payload: Dict[str, Any], psnr: Optional[float] = None,
                    ssim: Optional[float] = None) -> str:
    """Write ``payload`` under its stamped name; returns the path. Atomic: a
    crash mid-write leaves a ``.tmp`` and never a torn file at the name that
    resume reads."""
    os.makedirs(save_root, exist_ok=True)
    path = os.path.join(save_root, checkpoint_name(prefix, epoch, psnr, ssim))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def is_jax_checkpoint(path: str) -> bool:
    """A JAX package checkpoint (flax msgpack ``.ckpt`` or orbax ``.ocp``)
    rather than a port ``.pt`` or a reference ``.pth``."""
    return path.rstrip("/").endswith((JAX_SUFFIX, ".ocp"))


def _refuse_orbax(path: str) -> None:
    if path.rstrip("/").endswith(".ocp"):
        raise NotImplementedError(
            f"{path}: JAX's orbax checkpoints are not read by the port yet "
            "(ROADMAP M6, the orbax .ocp reader); save with "
            "checkpoint_backend: msgpack")


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """A JAX ``.ckpt``'s payload as nested dicts: ``state`` (the family
    state's fields by name, numpy arrays at the leaves; tuples keyed "0",
    "1", ..., optax's ``ScaleByAdamState`` by field), ``epoch``, ``lr`` and
    ``lr_d``."""
    from ctagan_tpu_torch.utils.msgpack import unpackb

    _refuse_orbax(path)
    with open(path, "rb") as f:
        data = f.read()
    return unpackb(data)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A port checkpoint's payload (or a ``.pth`` state dict), every tensor
    on the CPU; a JAX checkpoint through :func:`load_jax_checkpoint`."""
    if is_jax_checkpoint(path):
        return load_jax_checkpoint(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def find_checkpoints(save_root: str, prefix: str) -> List[Tuple[str, int]]:
    """Every checkpoint of ``prefix`` (the port's ``.pt``, JAX's ``.ckpt``
    and ``.ocp``), newest epoch first and the port's on an equal epoch, as
    (path, epoch) pairs."""
    if not os.path.isdir(save_root):
        return []
    found = []
    for fn in os.listdir(save_root):
        m = _CKPT_RE.match(fn)
        if m and m.group("prefix") == prefix:
            epoch = int(m.group("epoch"))
            found.append(((epoch, _SUFFIX_RANK[m.group("suffix")]),
                          os.path.join(save_root, fn)))
    found.sort(key=lambda kp: kp[0], reverse=True)
    return [(path, key[0]) for key, path in found]


def find_latest_checkpoint(save_root: str, prefix: str
                           ) -> Optional[Tuple[str, int]]:
    """The newest (path, epoch) of ``prefix``, or None."""
    found = find_checkpoints(save_root, prefix)
    return found[0] if found else None


def find_latest_of_family(save_root: str, family: str
                          ) -> Optional[Tuple[str, int]]:
    """The newest (path, epoch) whose prefix ends in ``_<family>``, under any
    config name and either suffix (on an equal epoch the port's ``.pt``,
    then the name that sorts last), or None."""
    if not os.path.isdir(save_root):
        return None
    best: Optional[Tuple[int, int, str]] = None
    for fn in os.listdir(save_root):
        m = _CKPT_RE.match(fn)
        if m and m.group("prefix").endswith(f"_{family}"):
            cand = (int(m.group("epoch")), _SUFFIX_RANK[m.group("suffix")],
                    fn)
            best = cand if best is None or cand > best else best
    return None if best is None else (os.path.join(save_root, best[2]),
                                      best[0])
