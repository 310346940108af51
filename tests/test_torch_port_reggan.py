"""Parity: the port's RegGAN family against the JAX package, and
``grad_accum`` and ``ema_decay`` on the reg step that HD shares.

- ``reg_train_step(dual_window_mode=False)`` (RegGAN: A in, B the
  registration target, ``Adv_lamda``/``Corr_lamda``, D at G's lr) in
  float64 against JAX's, from the same weights with ``noise_level: 0``, on
  a batch of 1; and HD stage 1 (``dual_window_mode=True``) with
  ``grad_accum: 2`` on a batch of 2 against JAX's step with the same knob.
  The losses rtol 1e-9, the Adam first moments of G, R and D as
  ``test_torch_port_train_step.py`` holds them.
- The EMA over two steps of RegGAN and of HD stage 1: exactly the formula
  on the port's own params and G's optimizer count.
- ``RegTrainer``: D's Adam runs at ``lr``, not ``lrd``; ``context_slices``
  > 1 and ``mesh: {pp: …}`` raise for the families that JAX refuses them.

128² (the RegNet's seven max pools need it), a G of 2 residual blocks at
base 16.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.data.native import dual_window_native
from ctagan_tpu_torch.models import Discriminator, RegNet
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
    load_reg_state,
    regnet_state_dict,
)
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.train.trainers import (
    CycTrainer,
    HdTrainerStage1,
    HdTrainerStage2,
    P2pTrainer,
    RegTrainer,
)
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_p2p import (
    EMA_DECAY,
    LR,
    _corpus,
    assert_losses,
    assert_moments,
    expect_ema,
    f64,
    jax_small_g,
    jax_tree,
    pair_batch,
    run_jax,
    small_g,
    snapshot,
)

torch.set_num_threads(2)

SIZE = 128
LR_D = 2e-4
FLOW_HEAD_SCALE = 1e4
CFG = {"Adv_lamda": 1.0, "Corr_lamda": 20.0, "Adv_lamda1": 1.0,
       "Corr_lamda1": 20.0, "Smooth_lamda": 10.0, "noise_level": 0,
       "aligned_aug": False, "d_refwd": True}
CONVERT = {"g": generator_state_dict, "r": regnet_state_dict,
           "d": discriminator_state_dict}


def _nets():
    g, r, d = (small_g(0), RegNet().reset_parameters(1),
               Discriminator().reset_parameters(2))
    # the flow head starts near zero; scale it to flows of a few pixels
    with torch.no_grad():
        r.offset_map.output.conv2d.weight.mul_(FLOW_HEAD_SCALE)
    return g, r, d


def _hd_batch(n):
    """HD's {A1, A2, B1, B2}: both views of ``n`` synthetic pairs."""
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels

    rng = np.random.default_rng(11)
    out = {k: [] for k in ("A1", "A2", "B1", "B2")}
    for _ in range(n):
        for side, contrast in (("A", False), ("B", True)):
            w, f = dual_window_native(synthetic_ct_pixels(rng, SIZE,
                                                          contrast=contrast))
            out[side + "1"].append(w[:, :, None])
            out[side + "2"].append(f[:, :, None])
    return {k: np.stack(v).astype(np.float64) for k, v in out.items()}


CASES = {
    # RegGAN: one pair, D at G's lr (JAX's RegTrainer passes no lr_d)
    "reggan": (dict(), False, 1, None),
    # HD stage 1 with two microbatches of one pair each
    "hd1_accum2": (dict(grad_accum=2), True, 2, LR_D),
}


@pytest.fixture(scope="module", params=list(CASES))
def reg_step(request):
    knobs, dual, n, lr_d = CASES[request.param]
    cfg = dict(CFG, **knobs)
    nets = _nets()
    gp, rp, dp = (f64(jax_tree(net)) for net in nets)
    batch = _hd_batch(n) if dual else pair_batch(n, SIZE)
    jg, jr, jd = jax_small_g(), JaxRegNet(), JaxDiscriminator()
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        state = jax_steps.RegState(gp, rp, dp, tx.init(gp), tx.init(rp),
                                   tx.init(dp), jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_enable_x64", False)
    kw = dict(dual_window_mode=dual)
    if lr_d is not None:
        kw["lr_d"] = np.float64(lr_d)
    new, want = run_jax(partial(jax_steps.reg_train_step, jg, jr, jd, tx, cfg,
                                **kw), state, batch)
    for net in nets:
        net.double()
    pstate = steps.init_reg_state(*nets, seed=0)
    got = steps.reg_train_step(
        pstate, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
        lr_d=lr_d, dual_window_mode=dual)
    return new, want, pstate, got


def test_reg_losses_match_jax(reg_step):
    _, want, _, got = reg_step
    assert list(got) == ["toal_loss", "loss_D_B", "SM_loss", "SR_loss",
                         "adv_loss"]
    assert_losses(got, want)


@pytest.mark.parametrize("net", ["g", "r", "d"])
def test_reg_adam_first_moments_match_jax(reg_step, net):
    new, _, pstate, _ = reg_step
    assert_moments(getattr(pstate, f"{net}_model"),
                   getattr(pstate, f"{net}_opt"),
                   getattr(new, f"{net}_opt").mu, CONVERT[net])


def test_load_reg_state_loads_jax_trees_and_the_ema():
    nets = _nets()
    trees = [jax_tree(net) for net in nets]
    pstate = steps.init_reg_state(small_g(5), RegNet(), Discriminator(),
                                  ema=True)
    load_reg_state(pstate, *trees)
    for attr, want in (("g_model", 0), ("g_ema", 0), ("r_model", 1),
                       ("d_model", 2)):
        sd = nets[want].state_dict()
        assert all(torch.equal(v, sd[k]) for k, v in
                   getattr(pstate, attr).state_dict().items()), attr


# -- the EMA ------------------------------------------------------------------

@pytest.mark.parametrize("dual", [False, True], ids=["reggan", "hd1"])
def test_reg_ema_over_two_steps_is_the_ramped_formula(dual):
    nets = _nets()
    pstate = steps.init_reg_state(*nets, seed=0, ema=True)
    ema0 = snapshot(pstate.g_ema)
    batch = _hd_batch(1) if dual else pair_batch(1, SIZE)
    batch = {k: torch.from_numpy(v).float() for k, v in batch.items()}
    cfg = dict(CFG, noise_level=1, ema_decay=EMA_DECAY)
    params = []
    for _ in range(2):
        steps.reg_train_step(pstate, cfg, batch, LR, lr_d=LR_D,
                             dual_window_mode=dual)
        params.append(snapshot(pstate.g_model))
    want = expect_ema(ema0, params)
    got = snapshot(pstate.g_ema)
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- the trainers -------------------------------------------------------------

def _cfg(root, lst, name="RegGan", **kw):
    cfg = dict(name=name, size=SIZE, seed=0, n_cpu=1, n_epochs=1,
               decay_epoch=1, val_every=100, train_list=lst, val_list=lst,
               test_list=lst, save_root=f"{root}/model/",
               image_save=f"{root}/img/")
    cfg.update(kw)
    return cfg


def test_reg_trainer_steps_d_at_the_g_lr(tmp_path):
    lst = _corpus(tmp_path, n_patients=1, slices=1, size=SIZE)
    t = RegTrainer(load_config(_cfg(tmp_path, lst, lr=1e-4, lrd=7e-4)),
                   torch.device("cpu"), quiet=True)
    t.train(max_steps=1)
    assert [g["lr"] for g in t.state.d_opt.param_groups] == [1e-4]
    assert t.state.g_ema is None and t._eval_model() is t.g_model
    hd = HdTrainerStage1(load_config(_cfg(tmp_path / "hd", lst, "HdGan",
                                          lr=1e-4, lrd=7e-4)),
                         torch.device("cpu"), quiet=True)
    hd.train(max_steps=1)
    assert [g["lr"] for g in hd.state.d_opt.param_groups] == [7e-4]


@pytest.mark.parametrize("cls", [RegTrainer, CycTrainer, HdTrainerStage1,
                                 HdTrainerStage2])
def test_context_slices_is_refused_outside_p2p(tmp_path, cls):
    cfg = load_config(_cfg(tmp_path, "unused.txt", context_slices=3))
    with pytest.raises(ValueError, match="P2p family only"):
        cls(cfg, torch.device("cpu"), quiet=True)


@pytest.mark.parametrize("cls", [P2pTrainer, RegTrainer, HdTrainerStage1])
def test_pipeline_mesh_raises_naming_m12(tmp_path, cls):
    # a pp mesh needs batchSize to divide into pp_microbatches (JAX's
    # check, default 2): one microbatch of the one row
    cfg = load_config(dict(_cfg(tmp_path, "unused.txt"), mesh={"pp": 2},
                           pp_microbatches=1))
    with pytest.raises(NotImplementedError, match="M12"):
        cls(cfg, torch.device("cpu"), quiet=True)
