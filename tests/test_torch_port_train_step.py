"""Parity: one HD stage-1 step of the port against the JAX package's
``reg_train_step(dual_window_mode=True)``, from the same converted weights on
the same batch, and the port's train entry point end to end on the CPU.

The JAX step runs its generator on the plain XLA body (``fused_body_grad``
off); the port runs its FusedChainFunction route, whose K1/K4/K5 calls take
their plain versions on the CPU. ``noise_level: 0`` makes the augmentation
the identity on both sides (their random streams differ). After one step
Adam's first moment is (1 − β1)·grad, so comparing the moments of G, R and D
compares the gradients, which the first update (±lr per element) would hide.

Both steps run in float64. In f32 the two frameworks' gradients of this
step differ by up to a few percent (measured: 1.1 % in the Frobenius norm
for the discriminator's input gradient alone, up to 5.6 % for G's head),
because the one-pass InstanceNorm variance E[x²] − E[x]² and the ReLU masks
amplify rounding in sums taken in another order; in float64 that noise is
~1e-12, so the comparison sees the algorithms. Tolerances: losses rtol 1e-9;
moments per tensor in the Frobenius norm 1e-6 of the tensor's norm (floored
at 1e-3 of the net's largest, for the conv biases before an InstanceNorm,
whose gradients are zero in exact arithmetic).
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

from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.__main__ import _device, main
from ctagan_tpu_torch.data.fixtures import make_corpus, synthetic_ct_pixels
from ctagan_tpu_torch.data.native import dual_window_native
from ctagan_tpu_torch.models import Discriminator, Generator, RegNet
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
    regnet_state_dict,
)
from ctagan_tpu_torch.train import steps

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256
CFG = {"Adv_lamda1": 1.0, "Corr_lamda1": 20.0, "Smooth_lamda": 10.0,
       "noise_level": 0, "aligned_aug": False, "d_refwd": True}
LR, LR_D = 1e-4, 2e-4
MOMENT_TOL, MOMENT_FLOOR = 1e-6, 1e-3
FLOW_HEAD_SCALE = 1e4
CONVERT = {"g": generator_state_dict, "r": regnet_state_dict,
           "d": discriminator_state_dict}


def _batch():
    rng = np.random.default_rng(11)
    a = synthetic_ct_pixels(rng, SIZE)
    b = synthetic_ct_pixels(rng, SIZE, contrast=True)
    (a1, a2), (b1, b2) = dual_window_native(a), dual_window_native(b)
    return {k: v[None, :, :, None] for k, v in
            (("A1", a1), ("A2", a2), ("B1", b1), ("B2", b2))}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def one_step():
    """The JAX step (jitted once) and the port's step from the same state,
    both in float64."""
    g = JaxGenerator(1, 1, n_residual_blocks=2, base_features=16,
                     fused_body_grad=False)
    r, d = JaxRegNet(), JaxDiscriminator()
    state, tx = jax_steps.init_reg_state(g, r, d, jax.random.PRNGKey(0), SIZE)
    host = jax.device_get(state)
    # the flow head starts near zero (N(0, 1e-5)); scale it to flows of a
    # few pixels so the warp's gradients see real displacements
    head = host.r_params["params"]["output"]["ConvTorch_0"]["Conv_0"]
    head["kernel"] = np.asarray(head["kernel"]) * FLOW_HEAD_SCALE
    gp, rp, dp = (_f64(t) for t in (host.g_params, host.r_params,
                                    host.d_params))
    batch = {k: v.astype(np.float64) for k, v in _batch().items()}
    jax.config.update("jax_enable_x64", True)
    try:
        state = jax_steps.RegState(gp, rp, dp, tx.init(gp), tx.init(rp),
                                   tx.init(dp), host.rng)
        fn = jax.jit(partial(jax_steps.reg_train_step, g, r, d, tx, CFG,
                             dual_window_mode=True))
        new, want = jax.device_get(fn(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float64(LR), lr_d=jnp.float64(LR_D)))
    finally:
        jax.config.update("jax_enable_x64", False)
    nets = {
        "g": Generator(1, 1, n_residual_blocks=2, base_features=16,
                       fused_body=False, fused_body_grad=True),
        "r": RegNet(), "d": Discriminator(),
    }
    for k, params in (("g", gp), ("r", rp), ("d", dp)):
        nets[k].load_state_dict(CONVERT[k](params), strict=True)
        nets[k].double()
    pstate = steps.init_reg_state(nets["g"], nets["r"], nets["d"], seed=0)
    got = steps.reg_train_step(
        pstate, CFG, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
        lr_d=LR_D, dual_window_mode=True)
    return new, want, pstate, got


def test_losses_match_jax(one_step):
    _, want, _, got = one_step
    assert list(got) == ["toal_loss", "loss_D_B", "SM_loss", "SR_loss",
                         "adv_loss"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-9,
                                   atol=1e-15, err_msg=k)


@pytest.mark.parametrize("net", ["g", "r", "d"])
def test_adam_first_moments_match_jax(one_step, net):
    new, _, pstate, _ = one_step
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


def test_unported_knobs_raise(one_step):
    """``pipeline_1f1b`` alone is not ported yet; ``grad_accum``,
    ``ema_decay`` and the RegGAN mode (``dual_window_mode=False``) run."""
    _, _, pstate, _ = one_step
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(NotImplementedError, match="ROADMAP M12"):
        steps.reg_train_step(pstate, CFG, batch, LR, dual_window_mode=True,
                             pipeline_1f1b=object())


def _config(tmp_path, size):
    lists = make_corpus(str(tmp_path), n_patients=1, slices_per_patient=3,
                        size=size, seed=1, lists=("train",))
    with open(os.path.join(REPO, "configs", "HdGan.yaml")) as f:
        text = f.read()
    path = tmp_path / "HdGan_cpu.yaml"
    # one epoch: --max-steps caps each epoch, as JAX's train.py
    path.write_text(text + f"\ntrain_list: '{lists['train']}'\n"
                    f"size: {size}\nlog_every: 1\nn_epochs: 1\n"
                    "decay_epoch: 0\n")
    return str(path)


def test_train_entry_point_runs_on_cpu(tmp_path):
    """``python -m ctagan_tpu_torch --mode train --device cpu`` takes real
    steps in a fresh interpreter without jax, flax or yaml."""
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
        [sys.executable, "-c", code, "--config", _config(tmp_path, SIZE),
         "--mode", "train", "--device", "cpu", "--max-steps", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("Epoch")]
    assert len(lines) == 2 and "toal_loss" in lines[0]
    assert "2 steps; over steps 2-2" in res.stdout


def test_entry_point_needs_a_card_unless_told_cpu(tmp_path):
    """The repaired ``_device``: no quiet fall-back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path cannot be reached")
    with pytest.raises(SystemExit, match="--device cpu"):
        _device(None)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--config", os.path.join(REPO, "configs", "HdGan.yaml"),
              "--mode", "train", "--max-steps", "1"])
    assert _device("cpu") == torch.device("cpu")
