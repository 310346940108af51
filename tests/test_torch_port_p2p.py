"""Parity: the port's pix2pix family against the JAX package, and the
shared pieces of the paired families (``PairedSliceDataset``, the EMA, the
microbatch loop).

- One ``p2p_train_step`` in float64 against JAX's, from the same weights
  (the port's seeded nets, converted with ``ctagan_tpu/models/
  torch_import.py``) with ``noise_level: 0`` (the augmentation is the
  identity on both sides; their random streams differ): at ``grad_accum``
  1 on a batch of 1 and at ``grad_accum`` 2 on a batch of 2. The losses
  rtol 1e-9; the Adam first moments ((1 − β1)·grad after one step) per
  tensor 1e-6 of the tensor's Frobenius norm, floored at 1e-3 of the net's
  largest, as ``test_torch_port_train_step.py`` holds HD stage 1.
- ``context_slices: 3``: G on a 3-channel stack, D on 4 channels, one step.
- The EMA over two steps: exactly the formula on the port's own params and
  the G optimizer's count; the ramped decay equal to JAX's
  ``_ema_update``; val and ``load_generator`` read and write the EMA.
- ``PairedSliceDataset`` item for item against JAX's (aligned,
  ``context_slices: 3`` with its clamps at the series' ends, ``raw_feed``
  then ``fullrange_from_stored``), exactly.
- ``python -m ctagan_tpu_torch --mode train`` then ``--mode test`` on a
  P2p config at 64² in a fresh interpreter without jax.

A G of 2 residual blocks at base 16 and 64² images, as small as the JAX
package's own step tests.
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

from ctagan_tpu.data import datasets as jax_datasets
from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.models import torch_import
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.data import datasets
from ctagan_tpu_torch.data.fixtures import make_corpus
from ctagan_tpu_torch.models import Discriminator, Generator
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
    load_p2p_state,
)
from ctagan_tpu_torch.ops.windowing import fullrange_from_stored
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.train.trainers import P2pTrainer
from ctagan_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
CFG = {"P2P_lamda": 100.0, "Adv_lamda": 1.0, "noise_level": 0,
       "aligned_aug": False}
LR = 1e-4
LOSS_RTOL = 1e-9
MOMENT_TOL, MOMENT_FLOOR = 1e-6, 1e-3
EMA_DECAY = 0.999
SMALL_G = dict(n_residual_blocks=2, base_features=16)


# -- helpers shared by the paired families' test files -----------------------

def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def jax_tree(net):
    """A port net's seeded weights as the JAX model's parameter tree."""
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    if isinstance(net, Generator):
        return torch_import.import_generator(sd)
    if isinstance(net, Discriminator):
        return torch_import.import_discriminator(sd)
    return torch_import.import_regnet(sd)


def small_g(seed):
    return Generator(1, 1, fused_body=False, fused_body_grad=True,
                     **SMALL_G).reset_parameters(seed)


def jax_small_g():
    return JaxGenerator(1, 1, fused_body_grad=False, **SMALL_G)


def pair_batch(n, size, seed=11, keys=("A", "B")):
    """``n`` full-range slice pairs from the synthetic CT fixture."""
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
    from ctagan_tpu_torch.data.native import dual_window_native

    rng = np.random.default_rng(seed)
    out = {k: [] for k in keys}
    for _ in range(n):
        for k, contrast in zip(keys, (False, True)):
            px = synthetic_ct_pixels(rng, size, contrast=contrast)
            out[k].append(dual_window_native(px)[1][:, :, None])
    return {k: np.stack(v).astype(np.float64) for k, v in out.items()}


def run_jax(fn, state, batch, *args, **kw):
    """``fn(state, batch, lr, ...)`` jitted, in float64."""
    jax.config.update("jax_enable_x64", True)
    try:
        return jax.device_get(jax.jit(fn)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float64(LR), *args, **kw))
    finally:
        jax.config.update("jax_enable_x64", False)


def assert_losses(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-15, err_msg=k)


def assert_moments(model, opt, mu, convert):
    """The port's Adam first moments of ``model`` against JAX's ``mu``."""
    want = convert(mu)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    floor = MOMENT_FLOOR * max(float(np.linalg.norm(w.numpy()))
                               for w in want.values())
    for name, w in want.items():
        st = opt.state[named[name]]
        assert int(st["step"]) == 1
        err = np.linalg.norm(st["exp_avg"].numpy() - w.numpy()) / max(
            float(np.linalg.norm(w.numpy())), floor)
        assert err <= MOMENT_TOL, (name, err)


def expect_ema(ema0, params_by_step, decay=EMA_DECAY):
    """The EMA after each step from the shadow's start, by the formula:
    e ← e·d + p·(1 − d), d = min(decay, (1 + t)/(10 + t)) in f32."""
    ema = {k: v.clone() for k, v in ema0.items()}
    for t, params in enumerate(params_by_step, start=1):
        d, om = steps.ema_decay_at(decay, t)
        ema = {k: ema[k] * d + params[k] * om for k in ema}
    return ema


def snapshot(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


# -- one step against JAX -----------------------------------------------------

@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def p2p_step(request):
    n = request.param  # grad_accum, on a batch of as many pairs
    cfg = dict(CFG, grad_accum=n)
    g, d = small_g(0), Discriminator(2).reset_parameters(1)
    gp, dp = f64(jax_tree(g)), f64(jax_tree(d))
    batch = pair_batch(n, SIZE)
    jg, jd = jax_small_g(), JaxDiscriminator(2)
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        state = jax_steps.P2pState(gp, dp, tx.init(gp), tx.init(dp),
                                   jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_enable_x64", False)
    new, want = run_jax(partial(jax_steps.p2p_train_step, jg, jd, tx, cfg),
                        state, batch)
    g.double()
    d.double()
    pstate = steps.init_p2p_state(g, d, seed=0)
    got = steps.p2p_train_step(
        pstate, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    return new, want, pstate, got


def test_p2p_losses_match_jax(p2p_step):
    _, want, _, got = p2p_step
    assert list(got) == ["loss_G", "loss_L1", "loss_GAN_A2B", "loss_D_B"]
    assert_losses(got, want)


@pytest.mark.parametrize("net", ["g", "d"])
def test_p2p_adam_first_moments_match_jax(p2p_step, net):
    new, _, pstate, _ = p2p_step
    if net == "g":
        assert_moments(pstate.g_model, pstate.g_opt, new.g_opt.mu,
                       generator_state_dict)
    else:
        assert_moments(pstate.d_model, pstate.d_opt, new.d_opt.mu,
                       discriminator_state_dict)


def test_load_p2p_state_loads_jax_trees_and_the_ema():
    g, d = small_g(3), Discriminator(2).reset_parameters(4)
    gp, dp = jax_tree(g), jax_tree(d)
    pstate = steps.init_p2p_state(small_g(5), Discriminator(2), ema=True)
    load_p2p_state(pstate, gp, dp)
    for got, want in ((pstate.g_model, g), (pstate.g_ema, g),
                      (pstate.d_model, d)):
        sd = want.state_dict()
        assert all(torch.equal(v, sd[k]) for k, v in
                   got.state_dict().items())


def test_p2p_context_slices_3_runs_one_step():
    g = Generator(3, 1, fused_body=False, fused_body_grad=True,
                  **SMALL_G).reset_parameters(0)
    d = Discriminator(4).reset_parameters(1)
    pstate = steps.init_p2p_state(g, d, seed=0)
    batch = pair_batch(1, SIZE)
    a = np.concatenate([batch["A"]] * 3, axis=-1)
    before = snapshot(g)
    got = steps.p2p_train_step(
        pstate, dict(CFG, noise_level=1),
        {"A": torch.from_numpy(a).float(),
         "B": torch.from_numpy(batch["B"]).float()}, LR)
    assert all(np.isfinite(float(v)) for v in got.values())
    assert any(not torch.equal(p, before[k])
               for k, p in g.named_parameters())


# -- the EMA ------------------------------------------------------------------

def test_p2p_ema_over_two_steps_is_the_ramped_formula():
    g, d = small_g(0), Discriminator(2).reset_parameters(1)
    pstate = steps.init_p2p_state(g, d, seed=0, ema=True)
    ema0 = snapshot(pstate.g_ema)
    assert all(torch.equal(v, snapshot(g)[k]) for k, v in ema0.items())
    batch = {k: torch.from_numpy(v).float()
             for k, v in pair_batch(1, SIZE).items()}
    cfg = dict(CFG, noise_level=1, ema_decay=EMA_DECAY)
    params = []
    for _ in range(2):
        steps.p2p_train_step(pstate, cfg, batch, LR)
        params.append(snapshot(g))
    assert steps._count(pstate.g_opt) == 2
    want = expect_ema(ema0, params)
    got = snapshot(pstate.g_ema)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(not torch.equal(got[k], params[-1][k]) for k in want)


@pytest.mark.parametrize("count", [1, 2, 90, 5000])
def test_ema_decay_ramp_equals_jax(count):
    """1·d + 0·(1 − d) = d and 0·d + 1·(1 − d) = 1 − d: JAX's decay and its
    complement, exactly."""
    ones = {"w": np.ones(4, np.float32)}
    zeros = {"w": np.zeros(4, np.float32)}
    d, om = steps.ema_decay_at(EMA_DECAY, count)
    got_d = jax_steps._ema_update(ones, zeros, EMA_DECAY, count=count)
    got_om = jax_steps._ema_update(zeros, ones, EMA_DECAY, count=count)
    assert np.all(np.asarray(got_d["w"]) == np.float32(d))
    assert np.all(np.asarray(got_om["w"]) == np.float32(om))
    rng = np.random.default_rng(count)
    e, p = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_steps._ema_update({"w": e}, {"w": p}, EMA_DECAY,
                                            count=count)["w"])
    ema, net = torch.nn.Linear(8, 8, bias=False), torch.nn.Linear(8, 8,
                                                                  bias=False)
    with torch.no_grad():
        ema.weight.copy_(torch.from_numpy(e.reshape(8, 8)))
        net.weight.copy_(torch.from_numpy(p.reshape(8, 8)))
    steps._ema_update(ema, net, EMA_DECAY, count)
    np.testing.assert_allclose(ema.weight.detach().numpy().ravel(), want,
                               rtol=0, atol=2e-7)


def _corpus(root, n_patients=2, slices=3, size=SIZE):
    return make_corpus(str(root), n_patients=n_patients,
                       slices_per_patient=slices, size=size, seed=4,
                       lists=("train",))["train"]


def _p2p_cfg(root, lst, **kw):
    cfg = dict(name="P2p", size=SIZE, seed=0, n_cpu=1, n_epochs=1,
               decay_epoch=1, val_every=1, train_list=lst, val_list=lst,
               test_list=lst, save_root=f"{root}/model/",
               image_save=f"{root}/img/")
    cfg.update(kw)
    return cfg


def test_p2p_trainer_val_and_load_generator_read_the_ema(tmp_path):
    lst = _corpus(tmp_path, n_patients=1, slices=2)
    t = P2pTrainer(load_config(_p2p_cfg(tmp_path, lst, ema_decay=EMA_DECAY)),
                   torch.device("cpu"), quiet=True)
    t.train(max_steps=2)
    assert t._eval_model() is t.state.g_ema
    ema_sd = {k: v.clone() for k, v in t.state.g_ema.state_dict().items()}
    assert any(not torch.equal(v, t.g_model.state_dict()[k])
               for k, v in ema_sd.items())
    val = t.validate()
    # the same weights as a live G, with no EMA: the same validation
    plain = P2pTrainer(load_config(_p2p_cfg(tmp_path / "p", lst)),
                       torch.device("cpu"), quiet=True)
    plain.g_model.load_state_dict(ema_sd)
    assert plain._eval_model() is plain.g_model
    assert plain.validate() == val
    # loaded weights overwrite the live G and the shadow
    path = str(tmp_path / "g.pth")
    full = Generator(1, 1).reset_parameters(9)
    torch.save(full.state_dict(), path)
    t.load_generator(path)
    for model in (t.g_model, t.state.g_ema):
        assert all(torch.equal(v, full.state_dict()[k])
                   for k, v in model.state_dict().items())


# -- PairedSliceDataset -------------------------------------------------------

def _items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_path"):
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    {}, {"size": 32}, {"context_slices": 3}, {"context_slices": 5},
    {"raw_feed": True}, {"raw_feed": True, "context_slices": 3,
                         "size": 32}], ids=str)
def test_paired_dataset_equals_jax_item_for_item(tmp_path, kw):
    lst = _corpus(tmp_path)
    got, want = (mod.PairedSliceDataset(lst, **kw)
                 for mod in (datasets, jax_datasets))
    assert got.files_a == want.files_a and got.files_b == want.files_b
    assert len(got) == len(want) == 6
    for i in range(len(got)):
        _items_equal(got[i], want[i])
    if kw.get("context_slices"):
        # the first slice of a series repeats itself below, the last above
        half = kw["context_slices"] // 2
        first, last = got[0]["A"], got[2]["A"]
        for c in range(half):
            np.testing.assert_array_equal(first[..., c], first[..., half])
            np.testing.assert_array_equal(last[..., -1 - c],
                                          last[..., half])


def test_raw_feed_maps_to_full_range_on_the_device(tmp_path):
    lst = _corpus(tmp_path)
    raw = datasets.PairedSliceDataset(lst, raw_feed=True)
    want = jax_datasets.PairedSliceDataset(lst)
    for i in range(len(raw)):
        item = raw[i]
        assert item["A"].dtype == np.uint16
        for k in ("A", "B"):
            t = torch.from_numpy(item[k].astype(np.int32))
            np.testing.assert_array_equal(fullrange_from_stored(t).numpy(),
                                          want[i][k])
        np.testing.assert_array_equal(
            datasets.read_fullrange_slice(item["A_path"]),
            jax_datasets.read_fullrange_slice(item["A_path"]))


# -- the entry point ----------------------------------------------------------

def _yaml(path, cfg):
    path.write_text("".join(f"{k}: '{v}'\n" if isinstance(v, str) else
                            f"{k}: {v}\n" for k, v in cfg.items()))
    return str(path)


def test_p2p_train_then_test_entry_point_on_cpu(tmp_path):
    """``python -m ctagan_tpu_torch`` on a P2p config at 64², in a fresh
    interpreter without jax, flax or yaml: an epoch of two steps saves
    ``P2p_p2p_e1_*.pt``; ``--mode test`` scores it and writes the SE2
    series."""
    lst = _corpus(tmp_path, n_patients=1, slices=2)
    # one epoch: --max-steps caps each epoch, as JAX's train.py
    path = _yaml(tmp_path / "P2p.yaml", _p2p_cfg(tmp_path, lst, log_every=1,
                                                 n_cpu=2, decay_epoch=0))
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'yaml', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import runpy, torch\n"
            "torch.set_num_threads(2)\n"
            "sys.argv = ['ctagan_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('ctagan_tpu_torch', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))

    def run(*args):
        res = subprocess.run(
            [sys.executable, "-c", code, "--config", path, "--device", "cpu",
             *args], cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout

    out = run("--mode", "train", "--max-steps", "2")
    assert "training P2p (pix2pix)" in out
    epoch = [ln for ln in out.splitlines() if ln.startswith("Epoch")]
    assert len(epoch) == 2 and "loss_L1" in epoch[0]
    saved = os.listdir(tmp_path / "model")
    pts = [f for f in saved if f.endswith(".pt")]
    assert len(pts) == 1 and pts[0].startswith("P2p_p2p_e1_")
    # JAX's loop writes its loss and val curves, panel and dashboard there
    for f in ("P2p_losses.csv", "P2p_val.csv", "P2p_latest_panel.png",
              "dashboard.html"):
        assert f in saved, f
    out = run("--mode", "test")
    assert "test: 2 slices" in out
    for key in ("MAEw", "PSNRw", "SSIMw", "UQIw", "MAE:", "PSNR:", "SSIM:",
                "UQI:"):
        assert key in out
    se2 = [f for d, _, fs in os.walk(tmp_path / "img") for f in fs
           if os.sep + "SE2" in d]
    assert len(se2) == 2
