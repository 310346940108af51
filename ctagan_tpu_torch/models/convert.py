"""JAX parameter trees -> the port's (reference-format) state dicts.

Reimplementations of ``ctagan_tpu/models/torch_export.py``'s
``generator_state_dict``, ``discriminator_state_dict``,
``nlayer_discriminator_state_dict`` and ``regnet_state_dict`` (and the
multi-scale discriminator's, that one under ``scale{i}.`` prefixes) that
need no JAX: the tree is nested dicts of numpy
arrays, ``{"params": {"ConvTorch_0": {"Conv_0": {"kernel", "bias"}}, ...}}``.

The ``load_*_state`` functions fill a port family state's nets from a JAX
family state's trees; :func:`load_jax_state` fills a whole port family state
(nets, EMAs, Adam moments, CycleGAN's replay pools) from a JAX family
state read from a ``.ckpt`` (``utils/checkpoint.py::load_jax_checkpoint``).

:func:`generator3d_state_dict` and :func:`discriminator3d_state_dict` map
the 3-D family's trees (``models/volumetric.py``; JAX has no torch export
of them, so the port's own ``state_dict()`` keys are the target).

- Conv kernel (kh, kw, I, O)                        -> Conv2d (O, I, kh, kw)
- ConvTranspose (transpose_kernel=True) (kh, kw, O, I) -> (I, O, kh, kw)
- the same in 3-D, (kd, kh, kw, a, b) -> (b, a, kd, kh, kw)
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _array(a) -> np.ndarray:
    """A leaf as f32, or f64 where it is f64 (a float64 check's tree)."""
    a = np.asarray(a)
    return a if a.dtype == np.float64 else a.astype(np.float32)


def _weight(sd, key, p) -> None:
    """A flax kernel and bias -> ``key.weight`` / ``key.bias``: the two
    channel axes swapped in front of the spatial ones, which keep their
    order (2-D and 3-D, plain and transposed convs alike)."""
    k = _array(p["kernel"])
    nd = k.ndim - 2
    sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(
        k.transpose(nd + 1, nd, *range(nd))))
    sd[f"{key}.bias"] = torch.from_numpy(_array(p["bias"]).copy())


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


def _params(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if "params" in tree else tree


def is_3d_tree(tree: Dict[str, Any]) -> bool:
    """Whether a JAX G or D tree is the 3-D family's."""
    return "Conv3d_0" in _params(tree)


def generator3d_state_dict(tree: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """models.volumetric.Generator3D params -> the port's ``Generator3D``
    (``head``, ``down.{0,1}``, ``body.{i}.conv{1,2}``, ``up.{0,1}``,
    ``tail``)."""
    params = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    _weight(sd, "head", params["Conv3d_0"]["Conv_0"])
    for i in (0, 1):
        _weight(sd, f"down.{i}", params[f"Conv3d_{i + 1}"]["Conv_0"])
    blocks = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("ResidualBlock3D_"))
    for b in blocks:
        blk = params[f"ResidualBlock3D_{b}"]
        for j in (0, 1):
            _weight(sd, f"body.{b}.conv{j + 1}", blk[f"Conv3d_{j}"]["Conv_0"])
    for i in (0, 1):
        _weight(sd, f"up.{i}", params[f"ConvTranspose_{i}"])
    _weight(sd, "tail", params["Conv3d_3"]["Conv_0"])
    return sd


def discriminator3d_state_dict(tree: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """models.volumetric.Discriminator3D params -> the port's
    ``Discriminator3D`` (``convs.{0..4}``)."""
    params = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(5):
        _weight(sd, f"convs.{i}", params[f"Conv3d_{i}"]["Conv_0"])
    return sd


def jax_generator_state_dict(tree: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """A JAX G tree, 2-D or 3-D (told apart by its keys), as the port's
    state dict."""
    return (generator3d_state_dict(tree) if is_3d_tree(tree)
            else generator_state_dict(tree))


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

def _d_state_dict(d_model, tree):
    """A JAX D tree for the port's D: the multi-scale layout where the port's
    D is a ``MultiScaleDiscriminator`` (HD stage 2), else the scalar one."""
    from ctagan_tpu_torch.models.discriminator import MultiScaleDiscriminator

    if isinstance(d_model, MultiScaleDiscriminator):
        return multiscale_discriminator_state_dict(tree)
    if is_3d_tree(tree):
        return discriminator3d_state_dict(tree)
    return discriminator_state_dict(tree)


def _load(net, sd, ema=None) -> None:
    net.load_state_dict(sd, strict=True)
    if ema is not None:
        ema.load_state_dict(sd, strict=True)


def load_p2p_state(state, g_params, d_params) -> None:
    """``g_params``/``d_params`` into a ``P2pState`` (D on the input stack
    plus the output, 2 channels at ``input_nc`` 1), the pix2pix family's or
    the 3-D P3d family's."""
    _load(state.g_model, jax_generator_state_dict(g_params), state.g_ema)
    _load(state.d_model, _d_state_dict(state.d_model, d_params))


def load_reg_state(state, g_params, r_params, d_params) -> None:
    """``g_params``/``r_params``/``d_params`` into a ``RegState``."""
    _load(state.g_model, generator_state_dict(g_params), state.g_ema)
    _load(state.r_model, regnet_state_dict(r_params))
    _load(state.d_model, _d_state_dict(state.d_model, d_params))


def load_cyc_state(state, g_a2b, g_b2a, d_a, d_b) -> None:
    """The four nets of a JAX ``CycState`` into a port ``CycState``."""
    _load(state.g_a2b, generator_state_dict(g_a2b), state.g_ema)
    _load(state.g_b2a, generator_state_dict(g_b2a), state.g_ema_b2a)
    _load(state.d_a, discriminator_state_dict(d_a))
    _load(state.d_b, discriminator_state_dict(d_b))


# -- a whole JAX family state (a ``.ckpt``'s ``state``) -> the port state ------
# optax's ``scale_by_adam`` keeps one ``count`` and moment trees ``mu``/``nu``
# of the params' structure; torch's Adam keeps per param ``step``,
# ``exp_avg`` and ``exp_avg_sq``. Both correct the bias by the same power
# of the count, so the moments go through the params' own transposes and
# the count becomes every param's step. JAX's ``rng`` key has no torch
# counterpart: the port state keeps its own generator.

def _scalar_dtype() -> torch.dtype:
    # torch's Adam keeps ``step`` in this type (torch.optim's own rule)
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def _load_adam(opt: torch.optim.Adam, nets, adam, to_sd) -> None:
    """optax ``ScaleByAdamState`` {count, mu, nu} into ``opt``, whose params
    are ``nets``' in order; ``to_sd`` maps one net's moment tree (``mu`` and
    ``nu`` are that tree for one net, a tuple keyed "0", "1", … for
    several) to its state dict."""
    count = int(np.asarray(adam["count"]))
    opt.state.clear()
    if count == 0:  # no step taken: torch's Adam starts with no state
        return
    step = torch.tensor(float(count), dtype=_scalar_dtype())
    for i, (net, conv) in enumerate(zip(nets, to_sd)):
        mu, nu = adam["mu"], adam["nu"]
        if len(nets) > 1:
            mu, nu = mu[str(i)], nu[str(i)]
        mu_sd, nu_sd = conv(mu), conv(nu)
        named = dict(net.named_parameters())
        if set(mu_sd) != set(named) or set(nu_sd) != set(named):
            raise KeyError(f"Adam moments do not match the net's params: "
                           f"{sorted(set(mu_sd) ^ set(named))}")
        for name, p in named.items():
            opt.state[p] = {
                "step": step.clone(),
                "exp_avg": mu_sd[name].to(device=p.device, dtype=p.dtype),
                "exp_avg_sq": nu_sd[name].to(device=p.device, dtype=p.dtype)}


def _load_ema(ema, tree, fallback_sd) -> None:
    """A JAX EMA tree into the port's shadow; a checkpoint without one (its
    run had no EMA) starts the shadow at the loaded G, as JAX's init does."""
    if ema is None:
        return
    ema.load_state_dict(fallback_sd if tree is None
                        else jax_generator_state_dict(tree), strict=True)


def _load_pool(buf, tree) -> None:
    data = torch.from_numpy(np.array(tree["data"]))
    buf.data.copy_(data.to(buf.data.dtype))
    buf.size = int(np.asarray(tree["size"]))


def load_jax_state(state, jax_state: Dict[str, Any]) -> None:
    """A JAX ``P2pState`` (pix2pix, and P3d's 3-D nets), ``RegState``
    (RegGAN, HD stage 1 and 2) or ``CycState``, as nested dicts by field
    name, into the port state of the same family: every net
    (``strict=True``), the EMAs, the Adam moments and counts, and
    CycleGAN's two replay pools. The port state's ``torch.Generator`` is
    left as it is."""
    st = jax_state
    if hasattr(state, "g_a2b"):  # CycState
        load_cyc_state(state, st["g_a2b_params"], st["g_b2a_params"],
                       st["d_a_params"], st["d_b_params"])
        _load_ema(state.g_ema, st.get("g_ema"), state.g_a2b.state_dict())
        _load_ema(state.g_ema_b2a, st.get("g_ema_b2a"),
                  state.g_b2a.state_dict())
        _load_adam(state.g_opt, (state.g_a2b, state.g_b2a), st["g_opt"],
                   (generator_state_dict, generator_state_dict))
        _load_adam(state.d_a_opt, (state.d_a,), st["d_a_opt"],
                   (discriminator_state_dict,))
        _load_adam(state.d_b_opt, (state.d_b,), st["d_b_opt"],
                   (discriminator_state_dict,))
        _load_pool(state.fake_a_buffer, st["fake_a_buffer"])
        _load_pool(state.fake_b_buffer, st["fake_b_buffer"])
        return
    d_sd = lambda tree: _d_state_dict(state.d_model, tree)  # noqa: E731
    if hasattr(state, "r_model"):  # RegState
        load_reg_state(state, st["g_params"], st["r_params"], st["d_params"])
        _load_adam(state.r_opt, (state.r_model,), st["r_opt"],
                   (regnet_state_dict,))
    else:  # P2pState
        load_p2p_state(state, st["g_params"], st["d_params"])
    _load_ema(state.g_ema, st.get("g_ema"), state.g_model.state_dict())
    _load_adam(state.g_opt, (state.g_model,), st["g_opt"],
               (jax_generator_state_dict,))
    _load_adam(state.d_opt, (state.d_model,), st["d_opt"], (d_sd,))


def jax_generator_params(jax_state: Dict[str, Any]) -> Dict[str, Any]:
    """The generator tree of a JAX family state: ``g_params``, or CycleGAN's
    ``g_a2b_params`` (its eval generator)."""
    return jax_state["g_params" if "g_params" in jax_state
                     else "g_a2b_params"]
