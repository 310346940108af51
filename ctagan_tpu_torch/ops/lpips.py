"""LPIPS (AlexNet) of the port (``ctagan_tpu/ops/lpips.py``): the perceptual
distance the reference's test() reports as LPIPSw and LPIPS.

The standard LPIPS v0.1 formulation: the input scaling layer, the AlexNet
feature trunk (five conv stages, a tap after each ReLU, max pools after the
first two), per-channel unit normalisation of each tap, squared difference,
non-negative 1×1 linear heads, the spatial mean, summed over taps.
Single-channel [-1, 1] slices are tiled to RGB.

No weights are in the repo and none are fetched: ``lpips_weights`` names a
file built by :func:`combine_torch_checkpoints` from a torchvision AlexNet
checkpoint and the lpips package's linear heads (``python -m
ctagan_tpu_torch.ops.lpips <alexnet.pth> <alex.pth> <out.pth>``). With no
file configured test() prints "not computed"; a configured file that does
not exist raises. Parameters keep torch's layouts: ``conv{i}_w`` (O, I, kh,
kw), ``conv{i}_b`` (O,), ``lin{i}_w`` (C,).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

# LPIPS v0.1's scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# AlexNet trunk: (out channels, kernel, stride, pad); max pool after 0 and 1
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
             (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
# torchvision AlexNet's ``features`` indices of the five convs
_FEATURE_IDX = (0, 3, 6, 8, 10)


def alexnet_features(params: Dict[str, torch.Tensor], x: torch.Tensor
                     ) -> List[torch.Tensor]:
    """x: (N, 3, H, W) scaled input -> the five ReLU taps, NCHW."""
    taps = []
    h = x
    for i, (_, _, stride, pad) in enumerate(_ALEX_CFG):
        h = F.relu(F.conv2d(h, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=stride, padding=pad))
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
    return taps


def _prep(im: torch.Tensor) -> torch.Tensor:
    """(H, W) or (N, H, W, 1|3) in [-1, 1] -> the scaled (N, 3, H, W)."""
    im = im.float()
    if im.dim() == 2:
        im = im[None, :, :, None]
    if im.shape[-1] == 1:
        im = im.expand(-1, -1, -1, 3)
    shift = torch.tensor(_SHIFT, dtype=im.dtype, device=im.device)
    scale = torch.tensor(_SCALE, dtype=im.dtype, device=im.device)
    return ((im - shift) / scale).permute(0, 3, 1, 2)


def lpips_distance(params: Dict[str, torch.Tensor], img0: torch.Tensor,
                   img1: torch.Tensor) -> torch.Tensor:
    """LPIPS between two (H, W) or (N, H, W, 1|3) images in [-1, 1]: a
    scalar, or (N,) for a batch of several."""
    t0 = alexnet_features(params, _prep(img0))
    t1 = alexnet_features(params, _prep(img1))
    total = 0.0
    for i, (f0, f1) in enumerate(zip(t0, t1)):
        n0 = f0 * torch.rsqrt((f0 * f0).sum(1, keepdim=True) + 1e-10)
        n1 = f1 * torch.rsqrt((f1 * f1).sum(1, keepdim=True) + 1e-10)
        lin = params[f"lin{i}_w"][None, :, None, None]
        total = total + ((n0 - n1) ** 2 * lin).sum(1).mean(dim=(1, 2))
    return total.squeeze()


def load_weights_from_torch(path: str, device=None
                            ) -> Dict[str, torch.Tensor]:
    """LPIPS parameters from a torch file: torchvision AlexNet keys
    (``features.{0,3,6,8,10}.weight/bias``) merged with the lpips heads
    (``lin{0-4}.model.1.weight``), or the two under ``alexnet`` /
    ``lpips``. The heads are clamped to be non-negative."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if "alexnet" in raw:
        merged = dict(raw["alexnet"])
        merged.update(raw["lpips"])
        raw = merged
    params: Dict[str, torch.Tensor] = {}
    for i, fi in enumerate(_FEATURE_IDX):
        params[f"conv{i}_w"] = raw[f"features.{fi}.weight"].float()
        params[f"conv{i}_b"] = raw[f"features.{fi}.bias"].float()
    for i in range(5):
        w = raw[f"lin{i}.model.1.weight"].float().reshape(-1)
        params[f"lin{i}_w"] = torch.clamp(w, min=0.0)
    return {k: v.to(device) for k, v in params.items()}


def combine_torch_checkpoints(alexnet_path: str, lpips_path: str,
                              out_path: str) -> str:
    """The one weights file :func:`load_weights_from_torch` reads, from a
    torchvision AlexNet checkpoint (its classifier dropped) and the lpips
    package's linear heads (``lin{i}`` or ``lins.{i}`` keys)."""
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=False)
    if hasattr(alex, "state_dict"):
        alex = alex.state_dict()
    heads = torch.load(lpips_path, map_location="cpu", weights_only=False)
    if hasattr(heads, "state_dict"):
        heads = heads.state_dict()
    merged = {}
    for fi in _FEATURE_IDX:
        merged[f"features.{fi}.weight"] = alex[f"features.{fi}.weight"]
        merged[f"features.{fi}.bias"] = alex[f"features.{fi}.bias"]
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        merged[key] = heads[key if key in heads
                            else f"lins.{i}.model.1.weight"]
    torch.save(merged, out_path)
    return out_path


def make_lpips_fn(weights_path: Optional[str], device=None):
    """``fn(img0, img1) -> tensor`` on ``device``, or None when no weights
    are configured; a configured path that does not exist raises (the
    reference always prints its two LPIPS columns)."""
    if not weights_path:
        return None
    if not os.path.exists(weights_path):
        raise FileNotFoundError(
            f"lpips_weights file not found: {weights_path!r}; build it with "
            "`python -m ctagan_tpu_torch.ops.lpips <alexnet.pth> "
            "<lpips_alex.pth> <out.pth>` (combine_torch_checkpoints)")
    params = load_weights_from_torch(weights_path, device)

    @torch.no_grad()
    def fn(img0, img1):
        return lpips_distance(params, img0, img1)

    return fn


def random_params(gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights of the right shapes (tests only): N(0, 0.05²) convs
    drawn from ``gen``, zero biases, uniform heads 1/C."""
    params: Dict[str, torch.Tensor] = {}
    in_c = 3
    for i, (out_c, k, _, _) in enumerate(_ALEX_CFG):
        params[f"conv{i}_w"] = torch.randn((out_c, in_c, k, k),
                                           generator=gen) * 0.05
        params[f"conv{i}_b"] = torch.zeros(out_c)
        params[f"lin{i}_w"] = torch.ones(out_c) / out_c
        in_c = out_c
    return params


def _main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ctagan_tpu_torch.ops.lpips",
        description="combine a torchvision AlexNet checkpoint and the lpips "
                    "linear heads into the file lpips_weights names")
    ap.add_argument("alexnet")
    ap.add_argument("lpips")
    ap.add_argument("out")
    args = ap.parse_args(argv)
    out = combine_torch_checkpoints(args.alexnet, args.lpips, args.out)
    print(f"wrote {out}; set `lpips_weights: {out}` in your config")


if __name__ == "__main__":
    _main()
