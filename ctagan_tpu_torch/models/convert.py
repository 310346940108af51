"""JAX Generator parameter tree -> the port's (reference-format) state dict.

A reimplementation of ``ctagan_tpu/models/torch_export.py::
generator_state_dict`` that needs no JAX: the tree is nested dicts of numpy
arrays, ``{"params": {"ConvTorch_0": {"Conv_0": {"kernel", "bias"}}, ...}}``.

- Conv kernel (kh, kw, I, O)                        -> Conv2d (O, I, kh, kw)
- ConvTranspose (transpose_kernel=True) (kh, kw, O, I) -> (I, O, kh, kw)
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _weight(sd, key, p) -> None:
    k = np.asarray(p["kernel"], dtype=np.float32)
    sd[f"{key}.weight"] = torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    sd[f"{key}.bias"] = torch.from_numpy(
        np.asarray(p["bias"], dtype=np.float32).copy())


def generator_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """models.Generator params (numpy) -> state dict for the port's
    ``Generator`` and the reference's (``load_state_dict(strict=True)``)."""
    params = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for key, name in (("model_head.1", "ConvTorch_0"),
                      ("model_head.4", "ConvTorch_1"),
                      ("model_head.7", "ConvTorch_2")):
        _weight(sd, key, params[name]["Conv_0"])
    blocks = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("ResidualBlock_"))
    for b in blocks:
        blk = params[f"ResidualBlock_{b}"]
        _weight(sd, f"model_body.{b}.conv_block.1", blk["ConvTorch_0"]["Conv_0"])
        _weight(sd, f"model_body.{b}.conv_block.5", blk["ConvTorch_1"]["Conv_0"])
    # both kernel layouts reverse their axes: (kh, kw, O, I) -> (I, O, kh, kw)
    _weight(sd, "model_tail.0", params["ConvTransposeTorch_0"]["ConvTranspose_0"])
    _weight(sd, "model_tail.3", params["ConvTransposeTorch_1"]["ConvTranspose_0"])
    _weight(sd, "model_tail.7", params["ConvTorch_3"]["Conv_0"])
    return sd
