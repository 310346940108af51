"""Parity: the port's 3-D family (P3d) against the JAX package's.

At 8 base features, 2 residual blocks, depth-4 windows of 32² slices:

- ``Generator3D`` at each ``depth_downsample`` (1, 2, 4) and
  ``Discriminator3D`` with JAX's weights carried over
  (``models/convert.py``, checked key for key by ``load_state_dict(strict=
  True)``): float64 outputs within 1e-10.
- ``instance_norm3d`` against JAX's own, in f32 and bf16.
- ``VolumePatchDataset``: series, eval windows and arrays equal JAX's on a
  seeded corpus, and the train windows from one seeded generator.
- One float64 ``p3d_train_step`` against JAX's, its H/W flips drawn from
  JAX's key and injected: losses rtol 1e-9; G's and D's Adam first moments
  per tensor within 1e-6 of the tensor's Frobenius norm, floored at 1e-3 of
  the net's largest (a conv bias before an InstanceNorm has an exact
  gradient of zero), at ``grad_accum`` 1 on a batch of 1 and 2 on a batch
  of 2. Parameters after the step are not compared: Adam turns the
  rounding noise of a zero gradient into a full ``lr`` step.
- A P3d ``.ckpt`` written by JAX resumes in the port; ``generator_weights``
  and ``load_inference_generator`` read it and a port ``.pt``.
- ``P3dTrainer`` validate() and test() aggregates against JAX's
  ``P3dTrainer`` on converted weights (f32).
- ``infer_series`` on a P3d config: the blended volume within 2e-5 of
  JAX's ``infer_volume_3d``, the SE2 series written from it; with
  ``infer_depth_sharded`` at world 1 the series of the direct forward of
  the symmetric-extended volume, cropped.
- ``--mode train``, ``test`` and ``infer --series`` on a P3d config on the
  CPU in a fresh interpreter without jax.

JAX's ``instance_norm3d`` casts its statistics to f32 whatever the input
type (``ctagan_tpu/models/volumetric.py:64-66``), which would put f32
rounding into a float64 comparison. For the float64 checks this file
swaps it, in the test process only, for the same two-pass formula with
``promote_types(x.dtype, f32)`` statistics (the rule of JAX's 2-D
``instance_norm``); the unswapped function is held against the port's in
f32 and bf16 by its own test.
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

from ctagan_tpu.data.volumes import VolumePatchDataset as JaxVolumes
from ctagan_tpu.models import volumetric as jax_vol
from ctagan_tpu.parallel.volume import infer_volume_3d as jax_infer_3d
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu.train.trainers import P3dTrainer as JaxP3dTrainer
from ctagan_tpu.utils.checkpoint import save_checkpoint as jax_save
from ctagan_tpu.utils.config import load_config as jax_load_config
from ctagan_tpu_torch.data.dicom import read_dicom
from ctagan_tpu_torch.data.fixtures import make_corpus
from ctagan_tpu_torch.data.volumes import VolumePatchDataset
from ctagan_tpu_torch.models.convert import (
    discriminator3d_state_dict,
    generator3d_state_dict,
)
from ctagan_tpu_torch.models.volumetric import (
    Discriminator3D,
    Generator3D,
    instance_norm3d,
)
from ctagan_tpu_torch.parallel.serve import infer_series
from ctagan_tpu_torch.parallel.volume import infer_volume_3d
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.train.trainers import (
    P3dTrainer,
    build_trainer,
    generator_weights,
)
from ctagan_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, DEPTH = 32, 4
SMALL = dict(n_residual_blocks=2, base_features=8)
DS = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
OUT_TOL = 1e-10
LOSS_RTOL = 1e-9
MOMENT_TOL, MOMENT_FLOOR = 1e-6, 1e-3
CFG = {"P2P_lamda": 100.0, "Adv_lamda": 1.0}
LR = 1e-4
# f32 eval on two implementations (PSNR in dB, the others absolute)
EVAL_PSNR_TOL, EVAL_TOL = 1e-3, 1e-5
BLEND_TOL = 2e-5
# JAX's own instance_norm3d, kept before any test swaps the module's name
JAX_INSTANCE_NORM3D = jax_vol.instance_norm3d


def _norm3d_f64(x, eps=1e-5, spatial_axis=None, halo=0):
    assert spatial_axis is None
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(xf, axis=(1, 2, 3), keepdims=True)
    var = jnp.var(xf, axis=(1, 2, 3), keepdims=True)
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


@pytest.fixture(scope="module")
def f64_norm():
    """JAX's instance_norm3d with float64 statistics for f64 input, for the
    float64 checks of this module only."""
    real = jax_vol.instance_norm3d
    jax_vol.instance_norm3d = _norm3d_f64
    yield
    jax_vol.instance_norm3d = real


@pytest.fixture
def x64(f64_norm):
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def jax_g(ds=1):
    return jax_vol.Generator3D(1, 1, depth_strides=DS[ds], tap_head=False,
                               tap_tail=False, **SMALL)


def jax_d():
    return jax_vol.Discriminator3D(2)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's G and D params, each from one jitted init (the G's shapes do
    not depend on its depth strides)."""
    a = jnp.zeros((1, DEPTH, SIZE, SIZE, 1))
    gp = jax.jit(jax_g().init)(jax.random.PRNGKey(0), a)
    dp = jax.jit(jax_d().init)(jax.random.PRNGKey(1),
                               jnp.zeros((1, DEPTH, SIZE, SIZE, 2)))
    return jax.device_get(gp), jax.device_get(dp)


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def port_g(gp, ds=1, dtype=torch.float64):
    g = Generator3D(1, 1, depth_strides=DS[ds], **SMALL).to(dtype)
    g.load_state_dict(generator3d_state_dict(gp), strict=True)
    return g


def port_d(dp, dtype=torch.float64):
    d = Discriminator3D(2).to(dtype)
    d.load_state_dict(discriminator3d_state_dict(dp), strict=True)
    return d


def _volume(n, c=1, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, DEPTH, SIZE, SIZE, c))


@pytest.mark.parametrize("ds", [1, 2, 4])
def test_generator3d_matches_jax_float64(jax_params, x64, ds):
    gp = f64(jax_params[0])
    x = _volume(1, seed=ds)
    want = np.asarray(jax.jit(jax_g(ds).apply)(gp, jnp.asarray(x)))
    with torch.no_grad():
        got = port_g(gp, ds)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


def test_discriminator3d_matches_jax_float64(jax_params, x64):
    dp = f64(jax_params[1])
    x = _volume(2, c=2)
    want = np.asarray(jax.jit(jax_d().apply)(dp, jnp.asarray(x)))
    with torch.no_grad():
        got = port_d(dp)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


def test_state_dict_maps_every_key(jax_params):
    gp, dp = jax_params
    assert set(generator3d_state_dict(gp)) == set(
        Generator3D(1, 1, **SMALL).state_dict())
    assert set(discriminator3d_state_dict(dp)) == set(
        Discriminator3D(2).state_dict())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)])
def test_instance_norm3d_matches_jax(dtype, tol):
    """JAX's own (f32 statistics) against the port's: f32 within 1e-5;
    bf16 within two bf16 ulps (f32 statistics summed in another order can
    round an output to the neighbouring bf16 value)."""
    x = np.random.default_rng(2).normal(0.3, 2.0, (2, DEPTH, 16, 16, 8)
                                        ).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    jt = jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(JAX_INSTANCE_NORM3D(jt).astype(jnp.float32))
    got = instance_norm3d(t.permute(0, 4, 1, 2, 3)).permute(
        0, 2, 3, 4, 1).float().numpy()
    assert instance_norm3d(t.permute(0, 4, 1, 2, 3)).dtype == dtype
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol


# -- the volume feed -----------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("p3d")
    lists = make_corpus(str(root), n_patients=3, slices_per_patient=6,
                        size=SIZE, seed=0)
    return root, lists


def test_volume_dataset_equals_jax(corpus):
    _, lists = corpus
    for lf in (lists["train"], lists["test"]):
        got = VolumePatchDataset(lf, depth=DEPTH, size=SIZE, train=False)
        want = JaxVolumes(lf, depth=DEPTH, size=SIZE, train=False)
        assert got.series == want.series and got._index == want._index
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g["A_path"] == w["A_path"]
            for k in ("A", "B"):
                assert g[k].dtype == w[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k])
    got = VolumePatchDataset(lists["train"], depth=DEPTH, size=SIZE,
                             train=True, rng=np.random.default_rng(5))
    want = JaxVolumes(lists["train"], depth=DEPTH, size=SIZE, train=True,
                      rng=np.random.default_rng(5))
    for i in range(4):
        g, w = got[i], want[i]
        assert g["A_path"] == w["A_path"]
        np.testing.assert_array_equal(g["A"], w["A"])


# -- one float64 step ----------------------------------------------------------

def _flips_of(key):
    _, kf = jax.random.split(key)
    return tuple(bool(v) for v in jax.random.bernoulli(kf, 0.5, (2,)))


def _key_with(flips):
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        if _flips_of(key) == flips:
            return key
    raise AssertionError(flips)


def _window_batch(corpus, n):
    _, lists = corpus
    ds = VolumePatchDataset(lists["test"], depth=DEPTH, size=SIZE,
                            train=False)
    items = [ds[i] for i in range(n)]
    return {k: np.stack([it[k] for it in items]).astype(np.float64)
            for k in ("A", "B")}


def _assert_moments(model, opt, mu, convert):
    want = convert(mu)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    floor = MOMENT_FLOOR * max(float(np.linalg.norm(w.numpy()))
                               for w in want.values())
    for name, w in want.items():
        st = opt.state[named[name]]
        assert int(st["step"]) == 1
        err = np.linalg.norm(st["exp_avg"].numpy() - w.numpy())
        assert err <= MOMENT_TOL * max(float(np.linalg.norm(w.numpy())),
                                       floor), name


@pytest.fixture(scope="module", params=[(1, 1, (True, False)),
                                        (2, 2, (False, True))],
                ids=["accum1_b1", "accum2_b2"])
def one_step(request, jax_params, corpus, f64_norm):
    """JAX's and the port's float64 step from the same weights and batch,
    JAX's flips injected into the port's."""
    n_accum, n, flips = request.param
    gp, dp = f64(jax_params[0]), f64(jax_params[1])
    batch = _window_batch(corpus, n)
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        state = jax_steps.P2pState(gp, dp, tx.init(gp), tx.init(dp),
                                   _key_with(flips), None)
        cfg = dict(CFG, grad_accum=n_accum)
        fn = partial(jax_steps.p3d_train_step, jax_g(), jax_d(), tx, cfg)
        new, losses = jax.device_get(jax.jit(fn)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float64(LR)))
    finally:
        jax.config.update("jax_enable_x64", False)
    pstate = steps.init_p3d_state(port_g(gp), port_d(dp), seed=0)
    plosses = steps.p3d_train_step(
        pstate, dict(CFG, grad_accum=n_accum),
        {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
        flips=flips)
    return new, losses, pstate, plosses


def test_p3d_step_losses_match_jax(one_step):
    _, losses, _, plosses = one_step
    assert list(plosses) == ["loss_G", "loss_L1", "loss_GAN_A2B",
                             "loss_D_B"]
    assert set(plosses) == set(losses)
    for k in losses:
        np.testing.assert_allclose(float(plosses[k]), float(losses[k]),
                                   rtol=LOSS_RTOL, atol=1e-15, err_msg=k)


def test_p3d_step_adam_moments_match_jax(one_step):
    new, _, pstate, _ = one_step
    _assert_moments(pstate.g_model, pstate.g_opt, new.g_opt.mu,
                    generator3d_state_dict)
    _assert_moments(pstate.d_model, pstate.d_opt, new.d_opt.mu,
                    discriminator3d_state_dict)


def test_p3d_flips_come_from_the_state_generator(jax_params):
    """Without injected flips the step draws them from its generator: two
    states of one seed flip alike."""
    gp, dp = jax_params
    draws = [steps.p3d_flips(steps.init_p3d_state(
        port_g(gp, dtype=torch.float32), port_d(dp, dtype=torch.float32),
        seed=3).gen) for _ in range(2)]
    assert draws[0] == draws[1]


# -- the trainer ---------------------------------------------------------------

def _cfg(root, lists, tag, **kw):
    cfg = dict(name="P3d", size=SIZE, patch_depth=DEPTH, seed=0, n_cpu=1,
               n_epochs=1, decay_epoch=0, val_every=1,
               train_list=lists["train"], val_list=lists["val"],
               test_list=lists["test"], save_root=f"{root}/{tag}/model/",
               image_save=f"{root}/{tag}/img/")
    cfg.update(kw)
    return cfg


class SmallP3d(P3dTrainer):
    """The port's P3d trainer on the small nets of this file."""

    def _generator(self, seed):
        ds = DS[self.config.depth_downsample]
        return Generator3D(1, 1, depth_strides=ds, **SMALL
                           ).reset_parameters(seed)

    def _build_models(self):
        self.d_model = Discriminator3D(2).reset_parameters(self.config.seed
                                                           + 1)


class JaxSmallP3d(JaxP3dTrainer):
    """JAX's P3d trainer on the small nets, its state from jitted inits."""

    def _build_generator(self):
        return jax_g(self.config.depth_downsample)

    def _build_models(self):
        self.d_model = jax_d()

    def _init_state(self):
        tx = jax_steps.make_optimizer()
        gp, dp = self._small_params
        return jax_steps.P2pState(gp, dp, tx.init(gp), tx.init(dp),
                                  jax.random.PRNGKey(0), None), tx


@pytest.fixture(scope="module")
def jax_trainer(corpus, jax_params):
    root, lists = corpus
    JaxSmallP3d._small_params = jax_params
    t = JaxSmallP3d(jax_load_config(_cfg(root, lists, "jax",
                                         data_parallel=False)), quiet=True)
    return t


def test_p3d_trainer_validate_and_test_match_jax(corpus, jax_trainer,
                                                 jax_params):
    root, lists = corpus
    t = SmallP3d(load_config(_cfg(root, lists, "port")), torch.device("cpu"),
                 quiet=True)
    t._set_g_params(generator3d_state_dict(jax_params[0]))
    assert type(t)._eval_slices(torch.zeros(1, DEPTH, 3, 3, 1)).shape == \
        (1, 3, 3)
    got, want = t.validate(), jax_trainer.validate()
    assert abs(got[0] - float(want[0])) <= EVAL_PSNR_TOL
    assert abs(got[1] - float(want[1])) <= EVAL_TOL
    got, want = t.test(), jax_trainer.test()
    assert set(got) == set(want)
    for k, v in want.items():
        tol = EVAL_PSNR_TOL if "PSNR" in k else EVAL_TOL
        assert abs(got[k] - v) <= tol, k
    assert not os.path.exists(t.config.image_save)  # no DICOM by default


def test_build_trainer_builds_p3d_from_the_shipped_config(tmp_path):
    cfg = load_config(os.path.join(REPO, "configs", "P3d.yaml"))
    cfg.size, cfg.compute_dtype = SIZE, "float32"
    t = build_trainer(cfg, torch.device("cpu"), quiet=True)
    assert type(t) is P3dTrainer and t.ckpt_prefix == "P3d_p3d"
    assert isinstance(t.g_model, Generator3D) and len(t.g_model.body) == 6
    assert t.g_model.head.weight.shape == (32, 1, 3, 7, 7)
    with pytest.raises(KeyError, match="P3d"):
        build_trainer(load_config({"name": "Nope"}), torch.device("cpu"))


def test_jax_p3d_ckpt_resumes_tests_and_infers_in_port(corpus, one_step,
                                                       tmp_path):
    """JAX's state after its step, saved by JAX: the port resumes it (nets,
    Adam moments and count, epoch), and its G readers take it, as they take
    the port's own ``.pt``."""
    root, lists = corpus
    new = one_step[0]
    cfg = _cfg(tmp_path, lists, "resume", resume=True)
    path = jax_save(cfg["save_root"], "P3d_p3d", 1,
                    {"state": new, "epoch": 1, "lr": LR, "lr_d": LR})
    t = SmallP3d(load_config(cfg), torch.device("cpu"), quiet=True)
    assert t.start_epoch == 1
    want_g = generator3d_state_dict(new.g_params)
    for k, v in t.g_model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want_g[k].float().numpy())
    want_d = discriminator3d_state_dict(new.d_params)
    for k, v in t.d_model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want_d[k].float().numpy())
    named = dict(t.g_model.named_parameters())
    mu = generator3d_state_dict(new.g_opt.mu)
    for k, p in named.items():
        st = t.state.g_opt.state[p]
        assert int(st["step"]) == 1
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      mu[k].float().numpy())
    for k, v in generator_weights(path).items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      want_g[k].float().numpy())
    fresh = SmallP3d(load_config(_cfg(tmp_path, lists, "resume")),
                     torch.device("cpu"), quiet=True)
    assert fresh.load_inference_generator() == path
    pt = fresh._save(2)
    assert generator_weights(pt).keys() == want_g.keys()
    assert fresh.load_inference_generator() == pt


def _series(tmp_path):
    lst = make_corpus(str(tmp_path), n_patients=1, slices_per_patient=10,
                      size=SIZE, seed=4, lists=("train",))["train"]
    with open(lst) as f:
        series = os.path.dirname(f.readline().strip())
    return series, dict.fromkeys(("train", "val", "test"), lst)


def test_infer_series_p3d_blends_as_jax(tmp_path, jax_params):
    series, lists = _series(tmp_path)
    t = SmallP3d(load_config(_cfg(tmp_path, lists, "infer")),
                 torch.device("cpu"), quiet=True)
    t._set_g_params(generator3d_state_dict(jax_params[0]))
    from ctagan_tpu_torch.parallel.serve import load_series_fullrange

    volume, paths = load_series_fullrange(series, size=SIZE)
    want = jax_infer_3d(lambda p, x: jax_g().apply(p, x), jax_params[0],
                        volume, depth=DEPTH)
    got = infer_volume_3d(lambda x: t.g_model(x), volume, depth=DEPTH)
    assert np.abs(got - want).max() <= BLEND_TOL
    out = infer_series(t, series, t.config.image_save)
    assert sorted(os.listdir(out)) == sorted(os.path.basename(p)
                                             for p in paths)
    uids = set()
    for i, p in enumerate(paths):
        src, ds = read_dicom(p), read_dicom(os.path.join(
            out, os.path.basename(p)))
        assert (ds.rows, ds.cols) == (src.rows, src.cols)
        uids.add(ds.series_instance_uid)
        stored = ds.pixel_array().astype(np.float64)
        expect = (got[i].astype(np.float64) + 1.0) * 0.5 * 4095.0
        assert np.abs(stored - expect).max() <= 1.0
    assert len(uids) == 1 and read_dicom(paths[0]).series_instance_uid \
        not in uids
    # exact inference at world 1: the halo is the depth field, 6 + 2 × 2
    t.config.infer_depth_sharded = True
    out = infer_series(t, series, str(tmp_path / "exact"))
    halo = 6 + 2 * SMALL["n_residual_blocks"]
    ext = np.pad(volume, ((halo, halo), (0, 0), (0, 0)), mode="symmetric")
    with torch.no_grad():
        exact = t.g_model(torch.from_numpy(ext)[None, ..., None])[
            0, halo:-halo, :, :, 0].numpy()
    for i, p in enumerate(paths):
        stored = read_dicom(os.path.join(out, os.path.basename(
            p))).pixel_array().astype(np.float64)
        expect = (exact[i].astype(np.float64) + 1.0) * 0.5 * 4095.0
        assert np.abs(stored - expect).max() <= 1.0


def test_p3d_train_test_infer_entry_points_on_cpu(tmp_path):
    """``python -m ctagan_tpu_torch`` on ``configs/P3d.yaml`` (full width,
    f32, 32², depth 4) in one fresh interpreter without jax: ``--mode
    train`` saves ``P3d_p3d_e1_*.pt``, ``test`` scores it, ``infer
    --series`` writes the SE2 series."""
    series, lists = _series(tmp_path)
    with open(os.path.join(REPO, "configs", "P3d.yaml")) as f:
        text = f.read()
    cfg = tmp_path / "P3d.yaml"
    cfg.write_text(text + "".join(f"\n{k}_list: '{lists[k]}'"
                                  for k in ("train", "val", "test"))
                   + f"\nsize: {SIZE}\npatch_depth: {DEPTH}\n"
                   "compute_dtype: float32\nn_epochs: 1\ndecay_epoch: 0\n"
                   f"val_every: 1\nn_cpu: 1\nsave_root: '{tmp_path}/model/'\n"
                   f"image_save: '{tmp_path}/img/'\n")
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'yaml', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "torch.set_num_threads(2)\n"
            "from ctagan_tpu_torch.__main__ import main\n"
            f"base = ['--config', {str(cfg)!r}, '--device', 'cpu']\n"
            "main(base + ['--mode', 'train'])\n"
            "main(base + ['--mode', 'test'])\n"
            f"main(base + ['--mode', 'infer', '--series', {series!r}])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "training P3d (3-D pix2pix)" in res.stdout
    assert "loss_GAN_A2B" in res.stdout and "PSNR:" in res.stdout
    saved = [f for f in os.listdir(tmp_path / "model")
             if f.startswith("P3d_p3d_e1_")]
    assert len(saved) == 1
    assert "test: 2 slices" in res.stdout  # windows 0-3 and 4-7 of 10
    out = tmp_path / "img" / "volume" / "SE2"
    assert f"synthetic CTA written to: {out}" in res.stdout
    assert len(os.listdir(out)) == 10
