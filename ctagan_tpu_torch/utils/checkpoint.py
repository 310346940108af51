"""Checkpoints of the port (``ctagan_tpu/utils/checkpoint.py``): metric-
stamped, atomic, resumable.

A checkpoint is one ``torch.save`` of ``{"state": {...}, "epoch", "lr",
"lr_d"}`` named ``<prefix>_e<epoch>[_<psnr>_<ssim>].pt``: the JAX package's
naming under the port's own suffix, so JAX's ``.ckpt`` pattern never
matches a port file and this module never matches a JAX one. JAX's flax
msgpack ``.ckpt`` files are not read yet (ROADMAP M6).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

SUFFIX = ".pt"
_CKPT_RE = re.compile(
    r"^(?P<prefix>.+?)_e(?P<epoch>\d+)(?:_(?P<metrics>[-\d._]+))?\.pt$")


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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A port checkpoint's payload, every tensor on the CPU."""
    if path.endswith((".ckpt", ".ocp")):
        raise NotImplementedError(
            f"{path}: JAX checkpoints (flax msgpack / orbax) are not read "
            "by the port yet (ROADMAP M6)")
    return torch.load(path, map_location="cpu", weights_only=True)


def find_checkpoints(save_root: str, prefix: str) -> List[Tuple[str, int]]:
    """Every port checkpoint of ``prefix``, newest epoch first, as (path,
    epoch) pairs."""
    if not os.path.isdir(save_root):
        return []
    out: List[Tuple[str, int]] = []
    for fn in os.listdir(save_root):
        m = _CKPT_RE.match(fn)
        if m and m.group("prefix") == prefix:
            out.append((os.path.join(save_root, fn), int(m.group("epoch"))))
    out.sort(key=lambda pe: pe[1], reverse=True)
    return out


def find_latest_checkpoint(save_root: str, prefix: str
                           ) -> Optional[Tuple[str, int]]:
    """The newest (path, epoch) of ``prefix``, or None."""
    found = find_checkpoints(save_root, prefix)
    return found[0] if found else None


def find_latest_of_family(save_root: str, family: str
                          ) -> Optional[Tuple[str, int]]:
    """The newest (path, epoch) whose prefix ends in ``_<family>``, under any
    config name (ties to the name that sorts last), or None."""
    if not os.path.isdir(save_root):
        return None
    best: Optional[Tuple[int, str]] = None
    for fn in os.listdir(save_root):
        m = _CKPT_RE.match(fn)
        if m and m.group("prefix").endswith(f"_{family}"):
            cand = (int(m.group("epoch")), fn)
            best = cand if best is None or cand > best else best
    return None if best is None else (os.path.join(save_root, best[1]),
                                      best[0])
