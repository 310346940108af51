"""Parity: a float64 training step resumed from a JAX checkpoint.

``load_jax_state`` then one float64 step, HD stage 1 and CycleGAN: JAX
takes a step, saves it with its ``save_checkpoint``, and both sides step
again from the file. Losses rtol 1e-9, both Adam moments per tensor 1e-6 of
the tensor's Frobenius norm (floored at 1e-3 of the net's largest), as the
family step tests hold them; CycleGAN's pools equal, its EMAs follow JAX's.
Each family's step is jitted once (module-scoped fixtures).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.train import replay_buffer as jax_rb
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu.utils import checkpoint as jax_ckpt
from ctagan_tpu_torch.models import Discriminator
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
    load_jax_state,
    regnet_state_dict,
)
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.utils import checkpoint
from tests.test_torch_port_p2p import (
    LR,
    LOSS_RTOL,
    MOMENT_FLOOR,
    MOMENT_TOL,
    assert_losses,
    f64,
    jax_small_g,
    jax_tree,
    pair_batch,
    small_g,
)
from tests.test_torch_port_reggan import CFG as REG_CFG
from tests.test_torch_port_reggan import LR_D, _hd_batch, _nets

torch.set_num_threads(2)

SIZE = 64  # CycleGAN; HD stage 1 at the RegNet's 128 (REG_CFG)
CYC_CFG = {"Adv_lamda": 1.0, "Cyc_lamda": 10.0, "noise_level": 0,
           "aligned_aug": False}


def _payload(state, epoch=3, lr=1e-4, lr_d=2e-4):
    return {"state": jax.device_get(state), "epoch": epoch, "lr": lr,
            "lr_d": lr_d}


def _moments_close(model, opt, adam, convert, count):
    named = dict(model.named_parameters())
    for key, which in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = convert(adam[key])
        floor = MOMENT_FLOOR * max(float(np.linalg.norm(w.numpy()))
                                   for w in want.values())
        for name, w in want.items():
            st = opt.state[named[name]]
            assert int(st["step"]) == count
            err = np.linalg.norm(st[which].numpy() - w.numpy()) / max(
                float(np.linalg.norm(w.numpy())), floor)
            assert err <= MOMENT_TOL, (key, name, err)


def _jax_two_steps(fn, state, batch, tmp_path, prefix):
    """One JAX step, the state saved by JAX's save_checkpoint, a second step
    from the file; returns (path, stepped state, its losses). Both states
    are placed with ``jax.device_put``, as JAX's trainer places a resumed
    one, so the one jitted step serves both calls without a recompile."""
    jax.config.update("jax_enable_x64", True)
    try:
        step = jax.jit(fn)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        s1, _ = step(jax.device_put(state), b, jnp.float64(LR))
        path = jax_ckpt.save_checkpoint(str(tmp_path), prefix, 1,
                                        _payload(s1))
        loaded = jax_ckpt.load_checkpoint(path, _payload(s1))["state"]
        s2, want = jax.device_get(step(jax.device_put(loaded), b,
                                       jnp.float64(LR)))
        assert step._cache_size() == 1
    finally:
        jax.config.update("jax_enable_x64", False)
    return path, s2, want


@pytest.fixture(scope="module")
def hd1_resumed(tmp_path_factory):
    cfg = dict(REG_CFG)
    nets = _nets()
    gp, rp, dp = (f64(jax_tree(net)) for net in nets)
    jg, jr, jd = jax_small_g(), JaxRegNet(), JaxDiscriminator()
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        state = jax_steps.RegState(gp, rp, dp, tx.init(gp), tx.init(rp),
                                   tx.init(dp), jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_enable_x64", False)
    batch = _hd_batch(1)
    fn = partial(jax_steps.reg_train_step, jg, jr, jd, tx, cfg,
                 dual_window_mode=True, lr_d=np.float64(LR_D))
    path, new, want = _jax_two_steps(fn, state, batch,
                                     tmp_path_factory.mktemp("hd1"), "H_hd1")
    fresh = _nets()  # other weights: everything comes from the file
    for net in fresh:
        net.double()
    pstate = steps.init_reg_state(*fresh, seed=0)
    load_jax_state(pstate, checkpoint.load_jax_checkpoint(path)["state"])
    got = steps.reg_train_step(
        pstate, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
        lr_d=LR_D, dual_window_mode=True)
    return new, want, pstate, got


def test_hd1_step_resumed_from_a_jax_checkpoint_matches_jax(hd1_resumed):
    _, want, _, got = hd1_resumed
    assert_losses(got, want)


@pytest.mark.parametrize("net", ["g", "r", "d"])
def test_hd1_resumed_adam_moments_match_jax(hd1_resumed, net):
    new, _, pstate, _ = hd1_resumed
    model = {"g": pstate.g_model, "r": pstate.r_model,
             "d": pstate.d_model}[net]
    conv = {"g": generator_state_dict, "r": regnet_state_dict,
            "d": discriminator_state_dict}[net]
    _moments_close(model, getattr(pstate, f"{net}_opt"),
                   getattr(new, f"{net}_opt")._asdict(), conv, 2)


@pytest.fixture(scope="module")
def cyc_resumed(tmp_path_factory):
    nets = (small_g(0), small_g(1), Discriminator().reset_parameters(2),
            Discriminator().reset_parameters(3))
    ga, gb, da, db = (f64(jax_tree(net)) for net in nets)
    jg, jd = jax_small_g(), JaxDiscriminator()
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        pools = [jax_rb.ReplayBuffer.create(50, (SIZE, SIZE, 1), np.float64)
                 for _ in range(2)]
        state = jax_steps.CycState(ga, gb, da, db, tx.init((ga, gb)),
                                   tx.init(da), tx.init(db), *pools,
                                   jax.random.PRNGKey(0), ga, gb)
    finally:
        jax.config.update("jax_enable_x64", False)
    batch = pair_batch(1, SIZE)
    fn = partial(jax_steps.cyc_train_step, jg, jd, tx, CYC_CFG)
    path, new, want = _jax_two_steps(fn, state, batch,
                                     tmp_path_factory.mktemp("cyc"), "C_cyc")
    fresh = (small_g(5), small_g(6), Discriminator().reset_parameters(7),
             Discriminator().reset_parameters(8))
    for net in fresh:
        net.double()
    pstate = steps.init_cyc_state(*fresh, SIZE, seed=0, ema=True)
    load_jax_state(pstate, checkpoint.load_jax_checkpoint(path)["state"])
    assert pstate.fake_a_buffer.size == pstate.fake_b_buffer.size == 1
    got = steps.cyc_train_step(
        pstate, CYC_CFG, {k: torch.from_numpy(v) for k, v in batch.items()},
        LR)
    return new, want, pstate, got


def test_cyc_step_resumed_from_a_jax_checkpoint_matches_jax(cyc_resumed):
    new, want, pstate, got = cyc_resumed
    assert_losses(got, want)
    for key in ("fake_a_buffer", "fake_b_buffer"):
        buf = getattr(pstate, key)
        assert buf.size == int(getattr(new, key).size) == 2
        np.testing.assert_allclose(buf.data[:2].numpy(),
                                   np.asarray(getattr(new, key).data)[:2],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("net", ["g", "d_a", "d_b"])
def test_cyc_resumed_adam_moments_match_jax(cyc_resumed, net):
    new, _, pstate, _ = cyc_resumed
    if net == "g":  # one Adam over both generators
        adam = new.g_opt._asdict()
        for i, model in enumerate((pstate.g_a2b, pstate.g_b2a)):
            one = {"mu": adam["mu"][i], "nu": adam["nu"][i]}
            _moments_close(model, pstate.g_opt, one, generator_state_dict, 2)
    else:
        _moments_close(getattr(pstate, net), getattr(pstate, f"{net}_opt"),
                       getattr(new, f"{net}_opt")._asdict(),
                       discriminator_state_dict, 2)


def test_cyc_resumed_emas_follow_jax(cyc_resumed):
    new, _, pstate, _ = cyc_resumed
    for ema, tree in ((pstate.g_ema, new.g_ema),
                      (pstate.g_ema_b2a, new.g_ema_b2a)):
        want = generator_state_dict(tree)
        for k, v in ema.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=LOSS_RTOL * 1e3, atol=1e-12)
