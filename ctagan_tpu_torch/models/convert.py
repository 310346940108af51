"""JAX parameter trees -> the port's (reference-format) state dicts.

Reimplementations of ``ctagan_tpu/models/torch_export.py``'s
``generator_state_dict``, ``discriminator_state_dict``,
``nlayer_discriminator_state_dict`` and ``regnet_state_dict`` (and the
multi-scale discriminator's, that one under ``scale{i}.`` prefixes) that
need no JAX: the tree is nested dicts of numpy
arrays, ``{"params": {"ConvTorch_0": {"Conv_0": {"kernel", "bias"}}, ...}}``.

The ``load_*_state`` functions fill a port family state's nets from a JAX
family state's trees.

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


def quantized_generator_params(tree: Any) -> Any:
    """The tree ``ctagan_tpu.ops.quantize.quantize_generator`` returns, as
    numpy arrays -> the port's int8 inference tree
    (``ops/quantize.py::quantize_generator``): the same structure and
    layouts, each array a tensor of its own dtype (int8 ``q``, f32 the rest)."""
    if isinstance(tree, dict):
        return {k: quantized_generator_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [quantized_generator_params(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def discriminator_state_dict(tree: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """models.Discriminator params -> the scalar PatchGAN's
    ``model.{0,2,5,8,11}`` state dict."""
    params = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 2, 5, 8, 11)):
        _weight(sd, f"model.{idx}", params[f"ConvTorch_{i}"]["Conv_0"])
    return sd


def nlayer_discriminator_state_dict(tree: Dict[str, Any], n_layers: int = 3
                                    ) -> Dict[str, torch.Tensor]:
    """models.NLayerDiscriminator params -> the pix2pixHD getIntermFeat
    layout, ``model{n}.0`` for its n_layers + 2 convs."""
    params = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for n in range(n_layers + 2):
        _weight(sd, f"model{n}.0", params[f"ConvTorch_{n}"]["Conv_0"])
    return sd


def multiscale_discriminator_state_dict(tree: Dict[str, Any],
                                        n_layers: int = 3
                                        ) -> Dict[str, torch.Tensor]:
    """models.MultiScaleDiscriminator params -> the port's
    ``MultiScaleDiscriminator``: each ``scale{i}``'s NLayer state dict under
    the prefix ``scale{i}.``."""
    params = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(params)):
        for k, v in nlayer_discriminator_state_dict(
                params[f"scale{i}"], n_layers).items():
            sd[f"scale{i}.{k}"] = v
    return sd


def _resnet_block(sd, prefix, sub) -> None:
    _weight(sd, f"{prefix}.conv_block.1", sub["ConvTorch_0"]["Conv_0"])
    _weight(sd, f"{prefix}.conv_block.5", sub["ConvTorch_1"]["Conv_0"])


def regnet_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """models.RegNet params -> the reference Reg's ``offset_map.*`` state
    dict, for the port's ``RegNet``."""
    from ctagan_tpu_torch.models.reg import NDF, NUF

    params = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(NDF)):
        sub = params[f"down_{i + 1}"]
        _weight(sd, f"offset_map.down_{i + 1}.conv_0.conv2d",
                sub["ConvTorch_0"]["Conv_0"])
        _resnet_block(sd, f"offset_map.down_{i + 1}.conv_0.resnet_block."
                      "model.0", sub["RegResnetBlock_0"])
    _weight(sd, "offset_map.c1.conv2d", params["c1"]["ConvTorch_0"]["Conv_0"])
    for j in range(3):
        _resnet_block(sd, f"offset_map.t.model.{j}", params[f"t_{j}"])
    _weight(sd, "offset_map.c2.conv2d", params["c2"]["ConvTorch_0"]["Conv_0"])
    for i in range(len(NUF)):
        level = len(NDF) - i
        _weight(sd, f"offset_map.up_{level}.conv2d",
                params[f"up_{level}"]["ConvTorch_0"]["Conv_0"])
    _resnet_block(sd, "offset_map.refine.0.model.0", params["refine_res"])
    _weight(sd, "offset_map.refine.1.conv2d",
            params["refine_conv"]["ConvTorch_0"]["Conv_0"])
    _weight(sd, "offset_map.output.conv2d",
            params["output"]["ConvTorch_0"]["Conv_0"])
    return sd


# -- a JAX family state's params -> the port state's nets ---------------------
# Each takes the params trees of a JAX ``P2pState``, ``RegState`` or
# ``CycState`` (numpy) and loads them into the port state of the same family
# (``train/steps.py``) with ``strict=True``; an EMA shadow starts at the
# loaded generator, as JAX's ``init_*_state`` copies it.

def _load(net, sd, ema=None) -> None:
    net.load_state_dict(sd, strict=True)
    if ema is not None:
        ema.load_state_dict(sd, strict=True)


def load_p2p_state(state, g_params, d_params) -> None:
    """``g_params``/``d_params`` into a ``P2pState`` (D on the input stack
    plus the output, 2 channels at ``input_nc`` 1)."""
    _load(state.g_model, generator_state_dict(g_params), state.g_ema)
    _load(state.d_model, discriminator_state_dict(d_params))


def load_reg_state(state, g_params, r_params, d_params) -> None:
    """``g_params``/``r_params``/``d_params`` into a ``RegState``."""
    _load(state.g_model, generator_state_dict(g_params), state.g_ema)
    _load(state.r_model, regnet_state_dict(r_params))
    _load(state.d_model, discriminator_state_dict(d_params))


def load_cyc_state(state, g_a2b, g_b2a, d_a, d_b) -> None:
    """The four nets of a JAX ``CycState`` into a port ``CycState``."""
    _load(state.g_a2b, generator_state_dict(g_a2b), state.g_ema)
    _load(state.g_b2a, generator_state_dict(g_b2a), state.g_ema_b2a)
    _load(state.d_a, discriminator_state_dict(d_a))
    _load(state.d_b, discriminator_state_dict(d_b))
