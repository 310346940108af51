"""Parity: the port's HD stage 2 against the JAX package, and its trainer
dispatch by config name.

Each comparison feeds the same numpy inputs (from a seed) to both sides;
JAX's weights reach the port through ``models/convert.py`` and
``load_state_dict(strict=True)``.

- ``NLayerDiscriminator`` and ``MultiScaleDiscriminator`` (``num_d`` 1 and
  2, ``center_crop`` and ``avg_pool``) in f32, feature by feature: atol
  1e-5 of each feature's largest magnitude (f32 convs summed in another
  order). The convert keys equal ``torch_export``'s, the values exactly.
- ``center_crop`` exact, ``avg_pool_same`` 1e-6; the five stage-2 losses
  rtol 1e-6 in f32, with exact zeros inside the mask.
- ``warp2d_local`` (the ``warp_max_disp`` warp) against JAX's shift-stack
  ``warp2d_local`` at R = 4, flows up to ~7 px and no sample point within
  0.05 px of a pixel centre: values atol 1e-5, gradients atol 1e-4, as
  ``warp2d`` is held in ``test_torch_port_train_modules.py``.
- One stage-2 step against JAX's ``reg_train_step(dual_window_mode=True,
  stage2=True)`` in float64 with ``noise_level: 0``, from the same weights:
  the default (``num_d`` 1, center crop); ``FM_lamda: 1`` with ``num_d: 2``
  and ``r1_gamma: 0.1`` (one case: a JAX float64 step takes 15-50 s on a
  CPU); and ``warp_max_disp: 4`` with ``reg_downsample: 2``.
  The losses rtol 1e-9, the Adam first moments of G, R and D per tensor
  1e-6 of the tensor's Frobenius norm (floored at 1e-3 of the net's
  largest), as the stage-1 step is held. Both sides' mask helpers cast to
  f32, and so does the R1 score, so ``SR_loss2`` and ``R1_loss`` are f32
  means of 10⁴-10⁵ terms inside the float64 step: they, and the totals
  that hold them (``toal_loss``, ``loss_D_B``), are held to F32_RTOL = 2e-6
  of the f32 term (about 16 f32 ulps: pairwise sums of 2¹⁶ terms in
  another order), plus the 1e-9 of the rest.
- ``build_trainer`` on the seven ``configs/*.yaml`` (P3d alone raises);
  ``HdTrainerStage2.bootstrap_from_stage1``; the train entry point on
  ``HdGan2``, then ``--mode test``.

128² is the smallest size both RegNets run (JAX's pads an empty axis at
64²), so the ``reg_downsample: 2`` case runs at 256² (R at 128²).
"""
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.models import discriminator as jax_disc
from ctagan_tpu.models import layers as jax_layers
from ctagan_tpu.models import torch_export, torch_import
from ctagan_tpu.ops import losses as jax_losses
from ctagan_tpu.ops import warp as jax_warp
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.__main__ import main
from ctagan_tpu_torch.__main__ import train as port_train
from ctagan_tpu_torch.data.fixtures import make_corpus, synthetic_ct_pixels
from ctagan_tpu_torch.data.native import dual_window_native
from ctagan_tpu_torch.models import (
    Generator,
    MultiScaleDiscriminator,
    NLayerDiscriminator,
    RegNet,
)
from ctagan_tpu_torch.models import layers
from ctagan_tpu_torch.models.convert import (
    generator_state_dict,
    multiscale_discriminator_state_dict,
    nlayer_discriminator_state_dict,
    regnet_state_dict,
)
from ctagan_tpu_torch.ops import losses, warp
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.train.trainers import (
    CycTrainer,
    HdTrainerStage1,
    HdTrainerStage2,
    P2pTrainer,
    P3dTrainer,
    RegTrainer,
    build_trainer,
)
from ctagan_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = 1e-5
LOSS_RTOL = 1e-6
LR, LR_D = 1e-4, 2e-4
STEP_RTOL = 1e-9
F32_RTOL = 2e-6
MOMENT_TOL, MOMENT_FLOOR = 1e-6, 1e-3
FLOW_HEAD_SCALE = 1e4
CFG = {"Adv_lamda1": 1.0, "Corr_lamda1": 20.0, "Corr_lamda2": 2.0,
       "Smooth_lamda": 10.0, "noise_level": 0, "aligned_aug": False,
       "d_refwd": True}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# -- the discriminators ------------------------------------------------------

def _check_feats(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=FEAT_TOL * np.abs(w).max())


@pytest.mark.parametrize("interm", [True, False])
def test_nlayer_discriminator_matches_jax(interm):
    x = _rand((2, 64, 64, 1), 1)
    model = jax_disc.NLayerDiscriminator(get_interm_feat=interm)
    params = jax.device_get(model.init(jax.random.PRNGKey(2), x))
    sd = nlayer_discriminator_state_dict(params)
    want_sd = torch_export.nlayer_discriminator_state_dict(params)
    assert list(sd) == list(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(sd[k].numpy(), want_sd[k])
    d = NLayerDiscriminator(get_interm_feat=interm)
    d.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = d(_t(x))
    want = model.apply(params, x)
    if interm:
        assert [tuple(f.shape) for f in got] == [
            (2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256),
            (2, 7, 7, 512), (2, 6, 6, 1)]
        _check_feats(got, want)
    else:
        _check_feats([got], [want])


@pytest.mark.parametrize("num_d,pyramid", [(1, "center_crop"),
                                           (2, "center_crop"),
                                           (2, "avg_pool")])
def test_multiscale_discriminator_matches_jax(num_d, pyramid):
    x = _rand((2, 96, 96, 1), 3)
    model = jax_disc.MultiScaleDiscriminator(num_d=num_d, pyramid=pyramid)
    params = jax.device_get(model.init(jax.random.PRNGKey(4), x))
    sd = multiscale_discriminator_state_dict(params)
    want_keys = [f"scale{i}.{k}" for i in range(num_d) for k in
                 torch_export.nlayer_discriminator_state_dict(
                     params["params"][f"scale{i}"])]
    assert list(sd) == want_keys
    d = MultiScaleDiscriminator(num_d=num_d, pyramid=pyramid)
    d.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = d(_t(x))
    want = model.apply(params, x)
    assert len(got) == len(want) == num_d
    for g, w in zip(got, want):
        _check_feats(g, w)
    # the second scale sees a 48² input either way
    assert num_d == 1 or tuple(got[1][0].shape) == (2, 24, 24, 64)


def test_discriminators_seeded_init():
    a = MultiScaleDiscriminator(num_d=2).reset_parameters(5)
    b = MultiScaleDiscriminator(num_d=2).reset_parameters(5)
    c = MultiScaleDiscriminator(num_d=2).reset_parameters(6)
    for (k, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(p, q), k
        assert not torch.equal(p, r), k
        # PyTorch's default conv init: U(±1/sqrt(fan_in))
        fan_in = a.get_parameter(k.replace(".bias", ".weight"))[0].numel()
        assert float(p.abs().max()) <= 1.0 / np.sqrt(fan_in)
    with pytest.raises(ValueError, match="pyramid"):
        MultiScaleDiscriminator(pyramid="crop")


@pytest.mark.parametrize("shape,size", [((2, 10, 12, 3), 5),
                                        ((1, 9, 9, 2), 4)])
def test_center_crop_and_avg_pool_match_jax(shape, size):
    x = _rand(shape, 7)
    np.testing.assert_array_equal(
        layers.center_crop(_t(x), size).numpy(),
        np.asarray(jax_layers.center_crop(x, size)))
    np.testing.assert_allclose(layers.avg_pool_same(_t(x)).numpy(),
                               np.asarray(jax_layers.avg_pool_same(x)),
                               atol=1e-6)


# -- the losses --------------------------------------------------------------

def _scales(seed, num_d, shapes=((2, 8, 8, 4), (2, 4, 4, 8), (2, 3, 3, 1))):
    return [[_rand(s, seed + 10 * i + j) for j, s in enumerate(shapes)]
            for i in range(num_d)]


@pytest.mark.parametrize("num_d", [1, 2])
@pytest.mark.parametrize("real", [True, False])
def test_gan_losses_match_jax(num_d, real):
    feats = _scales(20, num_d)
    tfeats = [[_t(f) for f in s] for s in feats]
    for got, want in (
        (losses.gan_loss_multiscale(tfeats, real),
         jax_losses.gan_loss_multiscale(feats, real)),
        (losses.gan_loss_single(tfeats[-1], real),
         jax_losses.gan_loss_single(feats[-1], real)),
        (losses.lsgan_loss(tfeats[0][-1], real),
         jax_losses.lsgan_loss(feats[0][-1], real)),
    ):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_gan_loss_refuses_scales_without_a_weight():
    feats = [[_t(f) for f in s] for s in _scales(30, 3)]
    with pytest.raises(ValueError, match="num_d"):
        losses.gan_loss_multiscale(feats, True)


@pytest.mark.parametrize("num_d", [1, 2])
def test_feature_matching_matches_jax_and_detaches_real(num_d):
    fake, real = _scales(40, num_d), _scales(50, num_d)
    tfake = [[_t(f, True) for f in s] for s in fake]
    treal = [[_t(f, True) for f in s] for s in real]
    got = losses.feature_matching_loss(tfake, treal, num_d=num_d)
    want = jax_losses.feature_matching_loss(fake, real, num_d=num_d)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    got.backward()
    assert all(f.grad is None for s in treal for f in s)
    assert all(float(f.grad.abs().sum()) > 0 for s in tfake for f in s[:-1])


def test_masked_correlation_loss_matches_jax_with_zeros_in_the_mask():
    pred, target = _rand((2, 16, 16, 1), 60), _rand((2, 16, 16, 1), 61)
    window = _rand((2, 16, 16, 1), 62)
    window[:, :8] = np.abs(window[:, :8]) + 0.3  # a body region
    # exact zeros inside the mask become -1 on both sides
    pred[:, 2:4, 2:6] = 0.0
    target[:, 3:5, 4:8] = 0.0
    got = losses.masked_correlation_loss(_t(pred), _t(target), _t(window))
    want = jax_losses.masked_correlation_loss(pred, target, window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    # the quirk is live: without it the loss differs
    mask = (window >= 0.3).astype(np.float32)
    plain = np.mean(np.abs(pred * mask - target * mask))
    assert abs(float(got) - plain) > 1e-3


# -- the warp_max_disp warp --------------------------------------------------

def _flow(shape, seed, scale):
    """Flows whose sample points keep >= 0.05 px off every pixel centre."""
    f = _rand(shape, seed, scale)
    frac = f - np.floor(f)
    return np.where(np.abs(frac - 0.5) > 0.45, np.floor(f) + 0.5 + (
        frac - 0.5) * 0.8, f).astype(np.float32)


@pytest.mark.parametrize("scale", [2.0, 4.0])
def test_warp2d_local_matches_jax(scale):
    src = _rand((2, 16, 20, 3), 70)
    flow = _flow((2, 16, 20, 2), 71, scale)
    assert (np.abs(flow) > 4).any() or scale < 4
    cot = _rand((2, 16, 20, 3), 72)

    def jloss(s, f):
        return jnp.sum(jax_warp.warp2d_local(s, f, 4) * cot)

    want = np.asarray(jax_warp.warp2d_local(src, flow, 4))
    gs_want, gf_want = jax.grad(jloss, argnums=(0, 1))(src, flow)
    s_t, f_t = _t(src, True), _t(flow, True)
    got = warp.warp2d_local(s_t, f_t, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(gs_want),
                               atol=1e-4)
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(gf_want),
                               atol=1e-4)
    # no gradient where the clip saturates
    assert np.abs(f_t.grad.numpy()[np.abs(flow) > 4]).max(initial=0.0) == 0


@pytest.mark.parametrize("local", [False, True])
def test_bf16_warp_samples_on_an_f32_grid_as_jax(local):
    """HdGan_fast.yaml's bf16 warp: JAX samples at f32 pixel coordinates and
    returns f32. The port's grid was bf16, which cannot hold a row index
    past 256 (and left non-finite values); now it is f32 too. Values atol
    1e-3: the f32 coordinates' round trip through grid_sample's [-1, 1]
    at 300 px against JAX's direct gather."""
    src = _rand((1, 300, 300, 1), 80)
    flow = _flow((1, 300, 300, 2), 81, 2.0)
    sb, fb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (src, flow))
    want = (jax_warp.warp2d_local(sb, fb, 4) if local
            else jax_warp.warp2d(sb, fb))
    assert want.dtype == jnp.float32
    st, ft = (torch.from_numpy(np.asarray(a.astype(jnp.float32))
                               ).bfloat16() for a in (sb, fb))
    got = warp.warp2d_local(st, ft, 4) if local else warp.warp2d(st, ft)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


# -- one stage-2 step against JAX, in float64 ------------------------------

STEP_CASES = {
    "default": (128, {}, {}),
    "fm_num_d2_r1": (128, {"FM_lamda": 1.0, "r1_gamma": 0.1}, {"num_d": 2}),
    "warp_ds": (256, {"warp_max_disp": 4, "reg_downsample": 2}, {}),
}
F32_TERMS = {"SR_loss2": ("SR_loss2",), "toal_loss": ("SR_loss2",),
             "R1_loss": ("R1_loss",), "loss_D_B": ("R1_loss",)}


def _batch(size):
    rng = np.random.default_rng(11)
    a = synthetic_ct_pixels(rng, size)
    b = synthetic_ct_pixels(rng, size, contrast=True)
    (a1, a2), (b1, b2) = dual_window_native(a), dual_window_native(b)
    return {k: v[None, :, :, None].astype(np.float64) for k, v in
            (("A1", a1), ("A2", a2), ("B1", b1), ("B2", b2))}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


CONVERT = {"g": generator_state_dict, "r": regnet_state_dict,
           "d": multiscale_discriminator_state_dict}


def _jax_tree(net, key):
    """The port's seeded weights as the JAX model's parameter tree
    (``ctagan_tpu/models/torch_import.py``): both sides start from the same
    weights without JAX's eager init, which takes most of a minute on a
    CPU."""
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    if key == "g":
        return torch_import.import_generator(sd)
    if key == "r":
        return torch_import.import_regnet(sd)
    return {"params": {
        f"scale{i}": torch_import.import_nlayer_discriminator(
            {k.split(".", 1)[1]: v for k, v in sd.items()
             if k.startswith(f"scale{i}.")})["params"]
        for i in range(net.num_d)}}


@pytest.fixture(scope="module", params=list(STEP_CASES))
def stage2_step(request):
    """JAX's stage-2 step (jitted) and the port's, from the same weights."""
    size, knobs, dkw = STEP_CASES[request.param]
    cfg = dict(CFG, **knobs)
    nets = {
        "g": Generator(1, 1, n_residual_blocks=2, base_features=16,
                       fused_body=False, fused_body_grad=True
                       ).reset_parameters(0),
        "r": RegNet().reset_parameters(1),
        "d": MultiScaleDiscriminator(**dkw).reset_parameters(2),
    }
    # the flow head starts near zero; scale it to flows of a few pixels
    with torch.no_grad():
        nets["r"].offset_map.output.conv2d.weight.mul_(FLOW_HEAD_SCALE)
    gp, rp, dp = (_f64(_jax_tree(nets[k], k)) for k in ("g", "r", "d"))
    batch = _batch(size)
    g = JaxGenerator(1, 1, n_residual_blocks=2, base_features=16,
                     fused_body_grad=False)
    r, d = JaxRegNet(), jax_disc.MultiScaleDiscriminator(**dkw)
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        state = jax_steps.RegState(gp, rp, dp, tx.init(gp), tx.init(rp),
                                   tx.init(dp), jax.random.PRNGKey(0))
        fn = jax.jit(partial(jax_steps.reg_train_step, g, r, d, tx, cfg,
                             dual_window_mode=True, stage2=True))
        new, want = jax.device_get(fn(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float64(LR), lr_d=jnp.float64(LR_D)))
    finally:
        jax.config.update("jax_enable_x64", False)
    for net in nets.values():
        net.double()
    pstate = steps.init_reg_state(nets["g"], nets["r"], nets["d"], seed=0)
    got = steps.reg_train_step(
        pstate, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
        lr_d=LR_D, dual_window_mode=True, stage2=True)
    return knobs, new, want, pstate, got


def test_stage2_losses_match_jax(stage2_step):
    knobs, _, want, _, got = stage2_step
    # the JAX step's keys, in the order its dict takes them
    assert list(got) == (
        ["toal_loss", "loss_D_B"] + ["R1_loss"] * ("r1_gamma" in knobs)
        + ["SM_loss", "SR_loss", "adv_loss"] + ["FM_loss"] * (
            "FM_lamda" in knobs) + ["SR_loss2"])
    assert set(got) == set(want)
    for k in want:
        f32 = sum(abs(float(want[t])) for t in F32_TERMS.get(k, ())
                  if t in want)
        np.testing.assert_allclose(
            float(got[k]), float(want[k]), rtol=STEP_RTOL,
            atol=1e-15 + F32_RTOL * f32, err_msg=k)


@pytest.mark.parametrize("net", ["g", "r", "d"])
def test_stage2_adam_first_moments_match_jax(stage2_step, net):
    _, new, _, pstate, _ = stage2_step
    opt_state = {"g": new.g_opt, "r": new.r_opt, "d": new.d_opt}[net]
    want = CONVERT[net](opt_state.mu)  # (1 - b1) * grad, in port key names
    model = {"g": pstate.g_model, "r": pstate.r_model,
             "d": pstate.d_model}[net]
    opt = {"g": pstate.g_opt, "r": pstate.r_opt, "d": pstate.d_opt}[net]
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    floor = MOMENT_FLOOR * max(float(np.linalg.norm(v)) for v in
                               (w.numpy() for w in want.values()))
    for name, w in want.items():
        state = opt.state[named[name]]
        assert int(state["step"]) == 1
        got = state["exp_avg"].numpy()
        err = np.linalg.norm(got - w.numpy()) / max(
            float(np.linalg.norm(w.numpy())), floor)
        assert err <= MOMENT_TOL, (name, err)


# -- trainers: dispatch by name, the stage-1 bootstrap, the entry point ------

@pytest.mark.parametrize("name,want", [
    ("HdGan", HdTrainerStage1), ("HdGan_fast", HdTrainerStage1),
    ("HdGan2", HdTrainerStage2), ("P2p", P2pTrainer),
    ("CycleGan", CycTrainer), ("RegGan", RegTrainer),
    pytest.param("P3d", P3dTrainer, id="P3d-M9")])
def test_build_trainer_dispatches_by_config_name(name, want, tmp_path):
    config = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    config.save_root = str(tmp_path)  # nothing to resume from
    t = build_trainer(config, torch.device("cpu"), quiet=True)
    assert type(t) is want
    assert t.ckpt_prefix == f"{config.name}_{want.family}"
    d_model = t.d_a if want is CycTrainer else t.d_model
    assert isinstance(d_model, MultiScaleDiscriminator) == (
        want is HdTrainerStage2)


def test_build_trainer_refuses_an_unknown_name():
    config = load_config({"name": "NoSuchGan"})
    with pytest.raises(KeyError, match="unknown trainer 'NoSuchGan'"):
        build_trainer(config, torch.device("cpu"))


def _corpus(root):
    """One patient of two 128² slice pairs; train on the first alone, so an
    epoch is one step; test on both."""
    lists = make_corpus(str(root), n_patients=1, slices_per_patient=2,
                        size=128, seed=3, lists=("train",))
    with open(lists["train"]) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    out = {}
    for name, chunk in (("train", paths[:1]), ("val", paths[:1]),
                        ("test", paths)):
        out[name] = os.path.join(str(root), f"{name}_s2.txt")
        with open(out[name], "w") as f:
            f.write("\n".join(chunk) + "\n")
    return out


def _cfg(lists, root, name="HdGan", **kw):
    cfg = dict(name=name, size=128, seed=0, n_cpu=1, n_epochs=1,
               decay_epoch=1, val_every=100, train_list=lists["train"],
               val_list=lists["val"], test_list=lists["test"],
               save_root=f"{root}/model/", image_save=f"{root}/img/")
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def stage1_ckpt(tmp_path_factory):
    """A stage-1 checkpoint whose G and R are not the seeded ones."""
    root = tmp_path_factory.mktemp("stage1")
    lists = _corpus(root)
    t = HdTrainerStage1(load_config(_cfg(lists, root)), torch.device("cpu"),
                        quiet=True)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for p in list(t.g_model.parameters()) + list(t.r_model.parameters()):
            p.add_(torch.randn(p.shape, generator=gen) * 1e-2)
    path = t._save(1)
    return {"root": root, "lists": lists, "path": path,
            "g": {k: v.clone() for k, v in t.g_model.state_dict().items()},
            "r": {k: v.clone() for k, v in t.r_model.state_dict().items()}}


def _same(model, want):
    got = model.state_dict()
    assert set(got) == set(want)
    return all(torch.equal(got[k], want[k]) for k in want)


def test_bootstrap_loads_g_and_r_and_keeps_d_fresh(stage1_ckpt, tmp_path):
    s1 = stage1_ckpt
    # an older stage-1 run under another config name is passed over
    old = os.path.join(os.path.dirname(s1["path"]), "Other_hd1_e0.pt")
    if not os.path.exists(old):
        os.link(s1["path"], old)
    t = HdTrainerStage2(load_config(_cfg(s1["lists"], s1["root"], "HdGan2")),
                        torch.device("cpu"), quiet=True)
    fresh_d = {k: v.clone() for k, v in t.d_model.state_dict().items()}
    assert not _same(t.g_model, s1["g"])
    t.bootstrap_from_stage1()
    assert _same(t.g_model, s1["g"]) and _same(t.r_model, s1["r"])
    assert _same(t.d_model, fresh_d)
    seeded = MultiScaleDiscriminator().reset_parameters(0 + 2)
    assert _same(t.d_model, seeded.state_dict())
    assert all(not opt.state for opt in (t.state.g_opt, t.state.r_opt,
                                         t.state.d_opt))
    # stage1_ckpt names the file
    t2 = HdTrainerStage2(load_config(_cfg(
        s1["lists"], tmp_path, "HdGan2", stage1_ckpt=s1["path"])),
        torch.device("cpu"), quiet=True)
    t2.bootstrap_from_stage1()
    assert _same(t2.g_model, s1["g"])
    # a JAX stage-1 checkpoint of the same G and R is read too (flax
    # msgpack); JAX's orbax directories are not read yet
    from ctagan_tpu.utils import checkpoint as jax_ckpt

    np_sd = {k: {n: v.numpy() for n, v in s1[k].items()} for k in "gr"}
    jax_path = jax_ckpt.save_checkpoint(str(tmp_path), "HdGan_hd1", 3, {
        "state": {"g_params": torch_import.import_generator(np_sd["g"]),
                  "r_params": torch_import.import_regnet(np_sd["r"])},
        "epoch": 3, "lr": 1e-4, "lr_d": 1e-4})
    t3 = HdTrainerStage2(load_config(_cfg(s1["lists"], tmp_path, "HdGan2")),
                         torch.device("cpu"), quiet=True)
    assert not _same(t3.g_model, s1["g"])
    t3.bootstrap_from_stage1(jax_path)
    assert _same(t3.g_model, s1["g"]) and _same(t3.r_model, s1["r"])
    with pytest.raises(NotImplementedError, match="M6"):
        t2.bootstrap_from_stage1(str(tmp_path / "HdGan_hd1_e3.ocp"))


def test_bootstrap_without_a_stage1_checkpoint_raises(stage1_ckpt, tmp_path):
    t = HdTrainerStage2(load_config(_cfg(stage1_ckpt["lists"], tmp_path,
                                         "HdGan2")),
                        torch.device("cpu"), quiet=True)
    with pytest.raises(FileNotFoundError, match="stage1_ckpt"):
        t.bootstrap_from_stage1()


def _yaml(path, cfg):
    path.write_text("".join(f"{k}: '{v}'\n" if isinstance(v, str) else
                            f"{k}: {v}\n" for k, v in cfg.items()))
    return str(path)


def test_entry_point_dispatches_by_name(stage1_ckpt, tmp_path, capsys):
    """The repaired fault: ``HdGan2`` trained HD stage 1, and the JAX
    package's other families quietly trained HD stage 1 too. Each name now
    builds its own family's trainer (P3d too, since M9). ``--max-steps 0``
    caps each epoch at no step, as JAX's; the configs have one epoch."""
    s1 = stage1_ckpt
    cfg = load_config(_cfg(s1["lists"], s1["root"], "HdGan2"))
    t = port_train(cfg, torch.device("cpu"), max_steps=0)
    assert type(t) is HdTrainerStage2
    assert _same(t.g_model, s1["g"]) and _same(t.r_model, s1["r"])
    assert "(HD stage 2)" in capsys.readouterr().out
    for name, title in (("RegGan", "RegGAN"), ("CycleGan", "CycleGAN"),
                        ("P2p", "pix2pix"), ("P3d", "3-D pix2pix")):
        path = _yaml(tmp_path / f"{name}.yaml",
                     _cfg(s1["lists"], tmp_path, name, decay_epoch=0))
        args = ["--config", path, "--mode", "train", "--device", "cpu",
                "--max-steps", "0"]
        assert main(args) == 0
        assert f"training {name} ({title})" in capsys.readouterr().out
    # a fresh stage-2 run with no stage-1 checkpoint warns and goes on
    cfg = load_config(_cfg(s1["lists"], tmp_path, "HdGan2"))
    t = port_train(cfg, torch.device("cpu"), max_steps=0)
    assert "warning: no stage-1 checkpoint found" in capsys.readouterr().out
    assert _same(t.g_model, Generator(1, 1).reset_parameters(0).state_dict())


def test_stage2_train_then_test_entry_point_on_cpu(stage1_ckpt, tmp_path):
    """``python -m ctagan_tpu_torch`` on an ``HdGan2`` config after a
    stage-1 run, in a fresh interpreter without jax, flax or yaml: it
    bootstraps, trains an epoch and saves ``HdGan2_hd2_e1.pt``; then
    ``--mode test`` scores that checkpoint and writes the SE2 series."""
    s1 = stage1_ckpt
    root = tmp_path
    os.makedirs(root / "model")
    os.link(s1["path"], root / "model" / os.path.basename(s1["path"]))
    path = _yaml(root / "HdGan2.yaml", _cfg(s1["lists"], root, "HdGan2",
                                            log_every=1, decay_epoch=0))
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'yaml', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import runpy, torch\n"
            "torch.set_num_threads(2)\n"
            "sys.argv = ['ctagan_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('ctagan_tpu_torch', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    res = subprocess.run(
        [sys.executable, "-c", code, "--config", path, "--mode", "train",
         "--device", "cpu", "--max-steps", "1"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    linked = root / "model" / os.path.basename(s1["path"])
    assert f"bootstrapped G and R from {linked}" in res.stdout
    epoch = [ln for ln in res.stdout.splitlines() if ln.startswith("Epoch")]
    assert len(epoch) == 1 and "SR_loss2" in epoch[0]
    saved = os.listdir(root / "model")
    assert sorted(f for f in saved if f.endswith(".pt")) == sorted(
        [os.path.basename(s1["path"]), "HdGan2_hd2_e1.pt"])
    # JAX's loop writes its loss curve, live panel and dashboard there too
    for f in ("HdGan2_losses.csv", "HdGan2_latest_panel.png",
              "dashboard.html"):
        assert f in saved, f
    res = subprocess.run(
        [sys.executable, "-c", code, "--config", path, "--mode", "test",
         "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "testing HdGan2 (HD stage 2)" in res.stdout
    assert "test: 2 slices in" in res.stdout
    se2 = [f for d, _, fs in os.walk(root / "img") for f in fs
           if f"{os.sep}SE2" in d]
    assert len(se2) == 2
