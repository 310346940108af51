"""Parity: the port's trainer loop (``TrainerBase.train``) and its host
modules against the JAX package's.

- ``TrainLogger``: the same loss sequence over two epochs and a resume
  gives byte-equal ``<name>_losses.csv`` and ``dashboard.html`` on both
  sides.
- ``render_dashboard`` / ``write_dashboard``: byte-equal HTML on the same
  CSVs and PNG, a torn CSV tail included.
- The live panel's uint8 pack bit-equal to JAX's formula, f32 and bf16.
- ``Watchdog`` with an injected ``on_stall`` (fires, held off by beats,
  suspended by pause) and ``supervise`` with an injected ``run``.
- ``python -m ctagan_tpu_torch --mode train --device cpu --supervise 1``
  whose first attempt exits 42 after its step-1 checkpoint (a
  ``sitecustomize`` shadow, JAX's own drill): relaunched with ``--resume``,
  it ends with exit 0.
- A 32² CPU training run: the CSV byte-equal to what JAX's logger writes
  for the run's losses, the val CSV, the panel PNG, the dashboard, the
  watchdog disarmed; ``max_steps_per_epoch`` with JAX's per-epoch meaning.
- The config keys of the loop and the mesh: JAX's defaults, a YAML
  model axis refused naming M12 when the trainer is built, and ``mesh:
  {dp: 2}`` in one process refused as JAX's "needs 2 devices".
- ``remat``: float64 gradients of the layer route bit-equal with and
  without it and against JAX's ``Generator(remat=True)`` (2 blocks, 32²),
  per tensor within 1e-6 of the tensor's Frobenius norm, floored at 1e-3
  of the net's largest (a conv bias before an InstanceNorm has an exact
  gradient of zero); the kernel route takes no checkpoint, as in JAX.
"""
import csv
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.models import torch_import
from ctagan_tpu.utils import dashboard as jax_dashboard
from ctagan_tpu.utils import watchdog as jax_watchdog
from ctagan_tpu.utils.config import Config as JaxConfig
from ctagan_tpu.utils.logging import TrainLogger as JaxTrainLogger
from ctagan_tpu_torch.__main__ import supervised_argv
from ctagan_tpu_torch.data.fixtures import make_corpus
from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.models import generator as generator_module
from ctagan_tpu_torch.train.trainers import build_trainer, panel_uint8
from ctagan_tpu_torch.utils import dashboard
from ctagan_tpu_torch.utils.config import Config, load_config
from ctagan_tpu_torch.utils.figures import read_png_gray, write_png_gray
from ctagan_tpu_torch.utils.logging import TrainLogger
from ctagan_tpu_torch.utils.watchdog import (
    STALL_EXIT_CODE,
    Watchdog,
    supervise,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
GRAD_TOL, GRAD_FLOOR = 1e-6, 1e-3

# a loss sequence of three keys in the order a step returns them (not
# sorted), two epochs of three batches
LOSSES = [{"loss_G": 2.0 + 0.1 * i, "loss_D_B": 0.5 / (i + 1),
           "loss_L1": 1.0 / 3.0 + i} for i in range(6)]


def _feed(cls, log_dir, losses, start_epoch=0, n_epochs=3):
    lg = cls("P2p", n_epochs, 3, log_dir=str(log_dir), log_every=2,
             quiet=True, start_epoch=start_epoch)
    for lo in losses:
        lg.log(lo)
    return lg


def test_train_logger_csv_and_dashboard_byte_equal_to_jax(tmp_path):
    """Two epochs, then a resumed logger (start_epoch 2) for a third: the
    same CSV rows (absolute epochs) and the same dashboard bytes."""
    for cls, d in ((JaxTrainLogger, tmp_path / "jax"),
                   (TrainLogger, tmp_path / "port")):
        lg = _feed(cls, d, LOSSES)
        assert lg.epoch == 3 and lg.batch == 1
        _feed(cls, d, LOSSES[:3], start_epoch=2)
    for name in ("P2p_losses.csv", "dashboard.html"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
    rows = list(csv.reader(open(tmp_path / "port" / "P2p_losses.csv")))
    assert rows[0] == ["epoch", "loss_D_B", "loss_G", "loss_L1"]
    assert [r[0] for r in rows[1:]] == ["1", "2", "3"]


def _panel_png(path):
    img = (np.arange(12 * 36) % 256).astype(np.uint8).reshape(12, 36)
    write_png_gray(str(path), img)
    return path.read_bytes()


@pytest.mark.parametrize("case", ["full", "torn_tail", "empty"])
def test_dashboard_html_byte_equal_to_jax(tmp_path, case):
    """``render_dashboard`` on the same rows and PNG, and ``write_dashboard``
    over the same files on disk (a torn or malformed CSV tail skipped by
    both), give the same bytes."""
    png = _panel_png(tmp_path / "P2p_latest_panel.png")
    if case != "empty":
        with open(tmp_path / "P2p_losses.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch", "loss_D_B", "loss_G"])
            for e in range(1, 5):
                w.writerow([e, 0.9 / e, 2.4 - 0.3 * e])
            if case == "torn_tail":
                f.write("5,0.4,junk,more\n5,oops\n6,0.1")
        for e, (p, s) in enumerate(((22.0, 0.81), (25.5, 0.88)), 1):
            dashboard.append_val_csv(str(tmp_path), "P2p", e, p, s)
    for mod in (jax_dashboard, dashboard):
        assert mod._read_csv(str(tmp_path / "P2p_losses.csv")) == \
            jax_dashboard._read_csv(str(tmp_path / "P2p_losses.csv"))
    lh, lr = jax_dashboard._read_csv(str(tmp_path / "P2p_losses.csv"))
    vh, vr = jax_dashboard._read_csv(str(tmp_path / "P2p_val.csv"))
    assert dashboard.render_dashboard("P2p", lh, lr, vh, vr, png) == \
        jax_dashboard.render_dashboard("P2p", lh, lr, vh, vr, png)
    want = open(jax_dashboard.write_dashboard(str(tmp_path), "P2p"),
                "rb").read()
    out = dashboard.write_dashboard(str(tmp_path), "P2p")
    assert open(out, "rb").read() == want
    assert not os.path.exists(out + ".tmp")
    if case != "empty":
        assert "<svg" in want.decode() and "data:image/png;base64," in \
            want.decode()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_panel_pack_is_jax_formula(dtype):
    """clip((t + 1) · 127.5, 0, 255) in f32, truncated to uint8, bit-equal
    to JAX's pack on values across and beyond [-1, 1]."""
    x = np.random.default_rng(0).uniform(-1.3, 1.3, (64, 80)).astype(
        np.float32)
    x[0, :6] = [-1.0, 1.0, 0.0, -1.0 + 1 / 127.5, 1.0 - 1e-7, 0.5]
    t = torch.from_numpy(x).to(dtype)
    jt = jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jnp.clip((jt.astype(jnp.float32) + 1.0) * 127.5, 0,
                               255).astype(jnp.uint8))
    got = panel_uint8(t).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# -- the watchdog and the supervisor -----------------------------------------

def test_watchdog_fires_on_stall():
    fired = []
    with Watchdog(0.2, on_stall=lambda: fired.append(1), poll_s=0.05):
        time.sleep(0.5)
    assert fired == [1]  # once, then its thread ends


def test_watchdog_beats_hold_it_off():
    fired = []
    wd = Watchdog(0.4, on_stall=lambda: fired.append(1), poll_s=0.05)
    with wd:
        for _ in range(10):
            wd.beat()
            time.sleep(0.08)
    assert not fired


def test_watchdog_pause_suspends_detection():
    fired = []
    wd = Watchdog(0.2, on_stall=lambda: fired.append(1), poll_s=0.05)
    with wd:
        wd.pause()
        wd.pause()  # re-entrant
        time.sleep(0.5)
        wd.resume()
        time.sleep(0.1)  # still paused once
        assert not fired
        wd.resume()
        wd.beat()
    assert not fired
    assert STALL_EXIT_CODE == jax_watchdog.STALL_EXIT_CODE == 42


@pytest.mark.parametrize("codes,restarts,want_rc,want_calls", [
    ({1: STALL_EXIT_CODE, 2: 1}, 3, 0, 3),  # stall, crash, then success
    ({1: 7, 2: 7, 3: 7}, 2, 7, 3),  # gives up after 2 restarts
])
def test_supervise_restarts_with_resume_as_jax(codes, restarts, want_rc,
                                                want_calls):
    runs = {}
    for name, fn in (("port", supervise), ("jax", jax_watchdog.supervise)):
        calls = []

        def run(cmd, calls=calls):
            calls.append(list(cmd))
            return codes.get(len(calls), 0)

        rc = fn(["prog", "--config", "c.yaml"], max_restarts=restarts,
                run=run)
        runs[name] = (rc, calls)
    assert runs["port"] == runs["jax"]
    rc, calls = runs["port"]
    assert rc == want_rc and len(calls) == want_calls
    assert "--resume" not in calls[0]
    assert all(c.count("--resume") == 1 for c in calls[1:])


def test_supervised_argv_drops_both_forms():
    for argv in (["--config", "c.yaml", "--supervise", "2", "--mode",
                  "train"],
                 ["--config", "c.yaml", "--supervise=2", "--mode", "train"]):
        assert supervised_argv(argv) == [
            sys.executable, "-m", "ctagan_tpu_torch", "--config", "c.yaml",
            "--mode", "train"]


# a sitecustomize shadow, first on the child's PYTHONPATH (so it survives
# the supervisor's relaunch): the WEDGE_TICK-th StepTimer.tick of the first
# attempt (no marker file yet) exits 42 as the watchdog does
SHADOW = """\
import os
if os.environ.get("WEDGE_MARKER"):
    from ctagan_tpu_torch.train import trainers as _t
    _orig, _n = _t.StepTimer.tick, [0]
    def tick(self):
        _n[0] += 1
        m = os.environ["WEDGE_MARKER"]
        if _n[0] == int(os.environ["WEDGE_TICK"]) and not os.path.exists(m):
            open(m, "w").write("x")
            os._exit(42)
        _orig(self)
    _t.StepTimer.tick = tick
"""


def _p2p_yaml(root, lists, **kw):
    cfg = dict(name="P2p", size=SIZE, seed=0, n_cpu=1, n_epochs=2,
               decay_epoch=0, val_every=1, log_every=1,
               train_list=lists["train"], val_list=lists["val"],
               test_list=lists["test"], save_root=f"{root}/model/",
               image_save=f"{root}/img/")
    cfg.update(kw)
    path = os.path.join(root, "P2p.yaml")
    with open(path, "w") as f:
        f.write("".join(f"{k}: {v!r}\n" if isinstance(v, str)
                        else f"{k}: {v}\n" for k, v in cfg.items()))
    return path


def test_supervise_resumes_a_child_that_exits_42(tmp_path):
    """``--supervise 1``: the first attempt exits 42 after its step-1
    checkpoint; the relaunch carries ``--resume``, resumes from that
    checkpoint and trains epoch 2 to the end."""
    lists = make_corpus(str(tmp_path), n_patients=1, slices_per_patient=2,
                        size=SIZE, seed=0, lists=("train",))
    lists = dict.fromkeys(("train", "val", "test"), lists["train"])
    cfg = _p2p_yaml(str(tmp_path), lists, checkpoint_every_iters=1,
                    stall_timeout=300.0)
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(SHADOW)
    marker = tmp_path / "exited_once"
    env = dict(os.environ, WEDGE_MARKER=str(marker), WEDGE_TICK="1",
               OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(hook), REPO]))
    res = subprocess.run(
        [sys.executable, "-m", "ctagan_tpu_torch", "--config", cfg,
         "--mode", "train", "--device", "cpu", "--supervise", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert marker.exists()
    assert "[supervise] attempt 1 exited 42 (stall-kill)" in res.stderr
    model = tmp_path / "model"
    assert f"resumed from {model}/P2p_p2p_e1.pt (epoch 1)" in res.stdout
    saved = sorted(f for f in os.listdir(model) if f.endswith(".pt"))
    assert saved[:2] == ["P2p_p2p_e1.pt", "P2p_p2p_e2.pt"]
    assert len(saved) == 3 and saved[2].startswith("P2p_p2p_e2_")
    rows = list(csv.reader(open(model / "P2p_losses.csv")))
    assert [r[0] for r in rows] == ["epoch", "2"]  # epoch 1 never ended


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """A P2p run at 32² on the CPU: two epochs of two steps, log_every 1,
    val every epoch, the watchdog armed."""
    root = tmp_path_factory.mktemp("loop")
    lists = make_corpus(str(root), n_patients=1, slices_per_patient=2,
                        size=SIZE, seed=0, lists=("train",))
    lists = dict.fromkeys(("train", "val", "test"), lists["train"])
    cfg = load_config(_p2p_yaml(str(root), lists, stall_timeout=120.0))
    t = build_trainer(cfg, torch.device("cpu"), quiet=True)
    armed = []
    step = t._step

    def spy(batch, lr, lr_d):
        armed.append(t._watchdog is not None)
        return step(batch, lr, lr_d)

    t._step = spy
    t.train()
    return t, root / "model", armed


def test_cpu_run_writes_loss_csv_byte_equal_to_jax_logger(cpu_run,
                                                          tmp_path):
    t, model, armed = cpu_run
    assert armed == [True] * 4 and t._watchdog is None
    jax_log = JaxTrainLogger("P2p", t.config.total_epochs, 2,
                             log_dir=str(tmp_path), log_every=1, quiet=True)
    for lo in t.loss_history:
        jax_log.log(lo)
    assert (model / "P2p_losses.csv").read_bytes() == \
        (tmp_path / "P2p_losses.csv").read_bytes()
    rows = list(csv.reader(open(model / "P2p_val.csv")))
    assert rows[0] == ["epoch", "PSNR", "SSIM"] and len(rows) == 3


def test_cpu_run_writes_panel_and_dashboard(cpu_run):
    t, model, _ = cpu_run
    panel = read_png_gray(str(model / "P2p_latest_panel.png"))
    assert panel.shape == (SIZE, 3 * SIZE)
    # the last write is the validation's panel of the first val slice:
    # input | synthesized | target through the eval G
    a = t._eval_input(t._eval_put(t.val_dataset[0]["A"][None]))
    b = t._eval_input(t._eval_put(t.val_dataset[0]["B"][None]))
    with torch.no_grad():
        fake = t._eval_model()(a)
    from ctagan_tpu_torch.utils.figures import make_panel

    want = make_panel([x[0, :, :, 0].float().numpy() for x in (a, fake, b)])
    np.testing.assert_array_equal(panel, want)
    body = (model / "dashboard.html").read_text()
    assert "<svg" in body and "data:image/png;base64," in body
    assert "val PSNR" in body and "loss_G" in body
    assert not os.path.exists(model / "dashboard.html.tmp")


def test_live_panel_is_the_live_batch_through_the_eval_g(cpu_run, tmp_path):
    """``_refresh_live_panel`` on a batch: its first sample's input | fake |
    target, packed by the JAX formula; a 3-D batch writes nothing."""
    t, _, _ = cpu_run
    t.config = dataclasses.replace(t.config, save_root=str(tmp_path))
    rng = np.random.default_rng(1)
    db = {k: torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 1))
                              .astype(np.float32)) for k in ("A", "B")}
    t._refresh_live_panel(db)
    with torch.no_grad():
        fake = t._eval_model()(db["A"][:1])
    want = np.hstack([panel_uint8(x[0, :, :, 0]).numpy()
                      for x in (db["A"], fake, db["B"])])
    np.testing.assert_array_equal(
        read_png_gray(str(tmp_path / "P2p_latest_panel.png")), want)
    os.remove(tmp_path / "P2p_latest_panel.png")
    t._refresh_live_panel({k: v[:, None] for k, v in db.items()})
    assert not os.path.exists(tmp_path / "P2p_latest_panel.png")


def test_max_steps_per_epoch_caps_each_epoch_as_jax(tmp_path):
    """JAX's ``--max-steps``: each of the two epochs stops after one step,
    validates and saves; a cut epoch writes no CSV row, and the logger
    moves on to the next epoch. The entry point's flag maps to it."""
    lists = make_corpus(str(tmp_path), n_patients=1, slices_per_patient=3,
                        size=SIZE, seed=0, lists=("train",))
    lists = dict.fromkeys(("train", "val", "test"), lists["train"])
    cfg = load_config(_p2p_yaml(str(tmp_path), lists))
    t = build_trainer(cfg, torch.device("cpu"), quiet=True)
    t.train(max_steps_per_epoch=1)
    assert t.steps_done == 2
    saved = sorted(f for f in os.listdir(tmp_path / "model")
                   if f.endswith(".pt"))
    assert [f[:11] for f in saved] == ["P2p_p2p_e1_", "P2p_p2p_e2_"]
    assert not os.path.exists(tmp_path / "model" / "P2p_losses.csv")
    assert len(list(csv.reader(open(tmp_path / "model" / "P2p_val.csv")))) \
        == 3
    from ctagan_tpu_torch import __main__ as entry

    seen = {}
    real = entry.train
    entry.train = lambda config, device, **kw: seen.update(kw)
    try:
        entry.main(["--config", _p2p_yaml(str(tmp_path), lists),
                    "--mode", "train", "--device", "cpu", "--max-steps",
                    "3"])
    finally:
        entry.train = real
    assert seen == {"max_steps_per_epoch": 3}


# -- the config keys ---------------------------------------------------------

LOOP_KEYS = ("remat", "live_panels", "stall_timeout", "patch_depth",
             "depth_downsample", "infer_depth_sharded", "mesh")


def test_loop_and_mesh_keys_are_fields_with_jax_defaults(tmp_path):
    port, ref = Config(), JaxConfig()
    for k in LOOP_KEYS:
        assert getattr(port, k) == getattr(ref, k), k
    path = tmp_path / "c.yaml"
    path.write_text("remat: true\nlive_panels: false\nstall_timeout: 30.0\n"
                    "patch_depth: 4\ndepth_downsample: 2\n"
                    "infer_depth_sharded: true\nmesh:\n  dp: 1\n")
    from ctagan_tpu.utils.config import load_config as jax_load

    cfg, want = load_config(str(path)), jax_load(str(path))
    for k in LOOP_KEYS:
        assert getattr(cfg, k) == getattr(want, k), k
    assert cfg.extras == {}


@pytest.mark.parametrize("raw", [
    {"depth_downsample": 3}, {"patch_depth": 6, "depth_downsample": 4},
    {"mesh": {"xp": 2}}, {"mesh": {"tp": 2, "sp": 2}}, {"mesh": {"dp": 0}},
])
def test_config_validation_refuses_as_jax(raw):
    with pytest.raises(ValueError):
        JaxConfig(**raw).validate()
    with pytest.raises(ValueError):
        load_config(raw)


@pytest.mark.parametrize("text", ["mesh: {dp: 2}", "mesh:\n  pp: 2",
                                  "mesh: {dp: 1, tp: 4}"])
def test_yaml_mesh_reaches_the_m12_refusal(tmp_path, text):
    """A model axis not ported reaches its M12 refusal; the dp and tp
    plans are ported, and ``{dp: 2}`` or ``{dp: 1, tp: 4}`` in one process
    reaches JAX's "needs N devices"."""
    path = tmp_path / "c.yaml"
    # pp_microbatches 1: a pp mesh needs batchSize (1) to divide into it
    # (JAX's check, default 2)
    path.write_text(f"name: P2p\nsize: {SIZE}\npp_microbatches: 1\n{text}\n")
    cfg = load_config(str(path))
    err, match = ((ValueError, "needs 2 devices, have 1") if "dp: 2" in text
                  else (ValueError, "needs 4 devices, have 1")
                  if "tp: 4" in text
                  else (NotImplementedError, "ROADMAP M12"))
    with pytest.raises(err, match=match):
        build_trainer(cfg, torch.device("cpu"), quiet=True)


def test_mesh_of_ones_is_accepted(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(f"name: P2p\nsize: {SIZE}\nmesh: {{dp: 1, pp: 1}}\n")
    build_trainer(load_config(str(path)), torch.device("cpu"), quiet=True)


# -- remat -------------------------------------------------------------------

SMALL = dict(n_residual_blocks=2, base_features=16)


def _port_grads(g, x, w):
    g.zero_grad(set_to_none=True)
    (g(x) * w).sum().backward()
    return {k: p.grad.detach().clone() for k, p in g.named_parameters()}


@pytest.fixture(scope="module")
def remat_grads():
    torch.set_default_dtype(torch.float64)
    try:
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.uniform(-1, 1, (1, SIZE, SIZE, 1)))
        w = torch.from_numpy(rng.standard_normal((1, SIZE, SIZE, 1)))
        g = Generator(1, 1, fused_body=False, fused_body_grad=False,
                      **SMALL).reset_parameters(5).double()
        plain = _port_grads(g, x, w)
        calls = []
        real = generator_module.checkpoint
        generator_module.checkpoint = lambda *a, **kw: (
            calls.append(1), real(*a, **kw))[1]
        try:
            g.remat = True
            remat = _port_grads(g, x, w)
        finally:
            generator_module.checkpoint = real
        return g, x, w, plain, remat, len(calls)
    finally:
        torch.set_default_dtype(torch.float32)


def test_remat_layer_route_grads_bit_equal(remat_grads):
    _, _, _, plain, remat, n_checkpoints = remat_grads
    assert n_checkpoints == SMALL["n_residual_blocks"]
    assert set(plain) == set(remat)
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k


def test_remat_grads_match_jax_remat_generator(remat_grads):
    g, x, w, _, remat, _ = remat_grads
    sd = {k: v.detach().numpy() for k, v in g.state_dict().items()}
    # flax names a rematerialized block's params CheckpointResidualBlock_i
    params = {"params": {k.replace("ResidualBlock", "CheckpointResidualBlock"):
                         v for k, v in torch_import.import_generator(sd)[
                             "params"].items()}}
    jg = JaxGenerator(1, 1, remat=True, fused_body_grad=False,
                      tap_heads=False, **SMALL)
    jax.config.update("jax_enable_x64", True)
    try:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        grads = jax.device_get(jax.jit(jax.grad(
            lambda p: jnp.sum(jg.apply(p, jnp.asarray(x.numpy()))
                              * jnp.asarray(w.numpy()))))(params))
    finally:
        jax.config.update("jax_enable_x64", False)
    from ctagan_tpu_torch.models.convert import generator_state_dict

    want = generator_state_dict({k.replace("Checkpoint", ""): v
                                 for k, v in grads["params"].items()})
    assert set(want) == set(remat)
    floor = GRAD_FLOOR * max(float(np.linalg.norm(v.numpy()))
                             for v in want.values())
    for k, v in want.items():
        err = np.linalg.norm(remat[k].numpy() - v.numpy())
        assert err <= GRAD_TOL * max(float(np.linalg.norm(v.numpy())),
                                     floor), k


def test_remat_does_nothing_on_the_kernel_route():
    """JAX's fused-grad body never builds the rematerialized block; the
    port's kernel route takes no checkpoint and gives the same grads."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, SIZE, SIZE, 1))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, SIZE, SIZE, 1))
                         .astype(np.float32))
    g = Generator(1, 1, fused_body=False, fused_body_grad=True,
                  **SMALL).reset_parameters(6)
    plain = _port_grads(g, x, w)
    real = generator_module.checkpoint
    generator_module.checkpoint = None  # any call would raise
    try:
        g.remat = True
        remat = _port_grads(g, x, w)
    finally:
        generator_module.checkpoint = real
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
