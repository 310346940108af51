"""Parity: the port's whole-series inference (``parallel/serve.py``,
``parallel/volume.py``) against the JAX package's.

- ``infer_series`` over one ``make_corpus`` series of 6 slices (a batch of
  4 and a tail of 2, padded as JAX pads it) against JAX's ``infer_series``
  on the same weights of a G of 2 residual blocks at base 16: the port's
  ``P2pTrainer`` (its G swapped for that one) finds a JAX ``.ckpt`` in its
  ``save_root`` by the checkpoint lookup; JAX's runs the weights given.
  In 2-D, in 2.5-D (``context_slices: 3``, the ends clamped), and on a
  series of 96-row slices at ``size: 64`` (resized down to infer and back
  up to write). The volumes equal; the fakes within 2e-5 of a float64
  forward of the same G, and within 2e-5 plus JAX's own f32 distance from
  that forward of JAX's (on these CT slices XLA's f32 G lands ~6.6e-5 from
  float64, the port's ~2.2e-6; measured); the SE2 stored values within 1,
  the same file names, one new SeriesInstanceUID for the whole series (not
  the source's).
- ``sliding_window`` and ``infer_volume_3d`` against JAX on the same
  callables (a per-tile and a per-window mean removal, so the blend
  matters), within 1e-5.
- ``infer_series`` of a 3-D generator with ``infer_depth_sharded`` runs
  JAX's branch in one process: a G whose depth field fits the series gives
  the forward of the symmetric-extended series, cropped; a ``depth_downsample``
  G prints JAX's message and takes the Hann windows.
- ``--mode infer --device cpu`` in a fresh interpreter.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.parallel import serve as jax_serve
from ctagan_tpu.parallel import volume as jax_volume
from ctagan_tpu.parallel.mesh import make_mesh
from ctagan_tpu.utils import checkpoint as jax_ckpt
from ctagan_tpu.utils.config import load_config as jax_load_config
from ctagan_tpu_torch.data import dicom
from ctagan_tpu_torch.data.fixtures import make_corpus
from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.parallel import serve, volume
from ctagan_tpu_torch.train.trainers import P2pTrainer
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_p2p import SMALL_G, jax_tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
N_SLICES = 6  # one batch of 4 and a padded tail of 2
FAKE_TOL = 2e-5
STORED_TOL = 1
BLEND_TOL = 1e-5
CASES = {"2d": (1, SIZE), "ctx3": (3, SIZE), "rows96": (1, 96)}


def _series(root, rows):
    make_corpus(root, n_patients=1, slices_per_patient=N_SLICES, size=rows,
                seed=4, lists=("train",))
    return os.path.join(root, "patient0", "ST0", "SE0")


def _jax_stub(cfg, g_params, ctx):
    """What JAX's infer_series reads of a trainer: its config, G, params and
    a one-device mesh (the port runs on one card)."""
    return SimpleNamespace(
        config=cfg, ckpt_prefix=f"{cfg.name}_p2p", family="p2p",
        g_eval=JaxGenerator(ctx, 1, **SMALL_G),
        g_model=JaxGenerator(ctx, 1, **SMALL_G),
        _g_params=lambda: g_params, mesh=make_mesh(n=1),
        load_generator=None)


@pytest.fixture(scope="module", params=list(CASES))
def inferred(request, tmp_path_factory):
    ctx, rows = CASES[request.param]
    root = str(tmp_path_factory.mktemp(f"infer_{request.param}"))
    series = _series(root, rows)
    g = Generator(ctx, 1, **SMALL_G).reset_parameters(7)
    params = jax.device_put(jax_tree(g))
    cfg = dict(name="P2p", size=SIZE, seed=0, context_slices=ctx,
               save_root=f"{root}/jax_model/")
    jcfg = jax_load_config(cfg)
    jax_dir = jax_serve.infer_series(_jax_stub(jcfg, params, ctx), series,
                                     f"{root}/jax_out")
    # the port finds JAX's checkpoint of these weights by the lookup
    jax_ckpt.save_checkpoint(f"{root}/port_model", "P2p_p2p", 3, {
        "state": {"g_params": jax.device_get(params), "g_ema": None},
        "epoch": 3, "lr": 1e-4, "lr_d": 1e-4})
    pt = P2pTrainer(load_config(dict(cfg, save_root=f"{root}/port_model/")),
                    torch.device("cpu"), quiet=True)
    pt.g_model = Generator(ctx, 1, fused_body=False, fused_body_grad="auto",
                           **SMALL_G)
    times = {}
    port_dir = serve.infer_series(pt, series, f"{root}/port_out", times)
    # the fakes of both, on the same loaded volume
    vol, paths = serve.load_series_fullrange(series, size=SIZE)
    jvol, jpaths = jax_serve.load_series_fullrange(series, size=SIZE)
    if ctx > 1:
        vol = serve.context_stack(vol, ctx)
    model = pt._eval_model()
    fake = volume.infer_volume(lambda x: model(x), vol)
    g64 = Generator(ctx, 1, fused_body=False, **SMALL_G).double()
    g64.load_state_dict(g.state_dict())
    fake64 = volume.infer_volume(lambda x: g64(x.double()), vol)
    jin = jvol
    if ctx > 1:
        half = ctx // 2
        idx = [np.clip(np.arange(len(jvol)) + o, 0, len(jvol) - 1)
               for o in range(-half, half + 1)]
        jin = np.stack([jvol[i] for i in idx], axis=-1)
    jg = JaxGenerator(ctx, 1, **SMALL_G)
    jfake = jax_volume.infer_volume(lambda p, x: jg.apply(p, x), params,
                                    jin, mesh=make_mesh(n=1))
    return dict(series=series, jax_dir=jax_dir, port_dir=port_dir,
                times=times, vol=(vol, jin, paths, jpaths),
                fake=(fake, jfake, fake64), g=g, trainer=pt)


def test_series_loads_as_jax_loads_it(inferred):
    vol, jin, paths, jpaths = inferred["vol"]
    assert paths == jpaths and len(paths) == N_SLICES
    np.testing.assert_array_equal(vol, jin)


def test_fakes_match_jax(inferred):
    fake, jfake, fake64 = inferred["fake"]
    assert fake.shape == jfake.shape == (N_SLICES, SIZE, SIZE)
    np.testing.assert_allclose(fake, fake64, rtol=0, atol=FAKE_TOL)
    jax_own = float(np.abs(jfake - fake64).max())
    np.testing.assert_allclose(fake, jfake, rtol=0, atol=jax_own + FAKE_TOL)


def test_trainer_loaded_the_jax_checkpoint(inferred):
    got = inferred["trainer"].g_model.state_dict()
    for k, v in inferred["g"].state_dict().items():
        assert torch.equal(got[k], v), k


def test_se2_series_matches_jax(inferred):
    jd, pd = inferred["jax_dir"], inferred["port_dir"]
    assert pd.endswith(os.path.join("volume", "SE2"))
    names = sorted(os.listdir(inferred["series"]))
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == names
    src_uid = dicom.read_dicom(os.path.join(inferred["series"], names[0])
                               ).series_instance_uid
    uids = set()
    for n in names:
        src = dicom.read_dicom(os.path.join(inferred["series"], n))
        got = dicom.read_dicom(os.path.join(pd, n))
        want = dicom.read_dicom(os.path.join(jd, n))
        assert (got.rows, got.cols) == (src.rows, src.cols)
        d = np.abs(got.pixel_array().astype(int)
                   - want.pixel_array().astype(int))
        assert int(d.max()) <= STORED_TOL, n
        uids.add(got.series_instance_uid)
    assert len(uids) == 1 and src_uid not in uids


def test_series_parts_are_timed(inferred):
    assert set(inferred["times"]) == {"load", "forward", "writeback"}
    assert all(v > 0 for v in inferred["times"].values())


def test_tail_is_padded_with_the_last_slice():
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 2.0

    vol = np.arange(6 * 2 * 2, dtype=np.float32).reshape(6, 2, 2)
    out = volume.infer_volume(fn, vol)
    np.testing.assert_array_equal(out, vol * 2.0)
    assert [tuple(s.shape) for s in seen] == [(4, 2, 2, 1)] * 2
    for i in (2, 3):  # the tail's padding repeats slice 5
        assert torch.equal(seen[1][i], seen[1][1])


@pytest.mark.parametrize("h,w,tile", [(64, 64, 64), (96, 80, 48),
                                      (40, 100, 32)])
def test_sliding_window_matches_jax(h, w, tile):
    img = np.random.default_rng(h + w).uniform(-1, 1, (h, w, 2)).astype(
        np.float32)
    got = volume.sliding_window(
        lambda x: x - x.mean(dim=(1, 2, 3), keepdim=True),
        torch.from_numpy(img), tile=tile)
    want = jax_volume.sliding_window(
        lambda p, x: x - jnp.mean(x, axis=(1, 2, 3), keepdims=True), None,
        jnp.asarray(img), tile=tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLEND_TOL)


@pytest.mark.parametrize("n,depth", [(11, 4), (8, 8), (3, 8)])
def test_infer_volume_3d_matches_jax(n, depth):
    vol = np.random.default_rng(n).uniform(-1, 1, (n, 16, 12)).astype(
        np.float32)
    got = volume.infer_volume_3d(
        lambda x: x - x.mean(dim=1, keepdim=True), vol, depth=depth)
    want = jax_volume.infer_volume_3d(
        lambda p, x: x - jnp.mean(x, axis=1, keepdims=True), None, vol,
        depth=depth)
    np.testing.assert_allclose(got, want, rtol=0, atol=BLEND_TOL)


def _stored(out_dir, name):
    return dicom.read_dicom(os.path.join(out_dir, name)).pixel_array(
    ).astype(np.float64)


def test_infer_series_runs_the_3d_depth_sharded_branch(tmp_path, capsys):
    """JAX's ``infer_depth_sharded`` branch in one process: with no
    residual block (depth field 6, the series' 6 slices) the exact forward
    of the symmetric-extended series, cropped; at ``depth_downsample: 2``
    JAX's message and the Hann windows of ``patch_depth`` slices."""
    from ctagan_tpu_torch.models.volumetric import Generator3D

    series = _series(str(tmp_path), SIZE)
    cfg = load_config({"infer_depth_sharded": True, "size": SIZE,
                       "patch_depth": 4})
    vol, paths = serve.load_series_fullrange(series, size=SIZE)
    for strides, tag in (((1, 1), "exact"), ((1, 2), "windows")):
        g = Generator3D(1, 1, n_residual_blocks=0, base_features=8,
                        depth_strides=strides).reset_parameters(5)
        stub = SimpleNamespace(family="p3d", config=cfg,
                               device=torch.device("cpu"), _eval_model=lambda: g,
                               load_inference_generator=lambda: None)
        out = serve.infer_series(stub, series, str(tmp_path / tag))
        with torch.no_grad():
            if tag == "exact":
                ext = np.pad(vol, ((6, 6), (0, 0), (0, 0)), mode="symmetric")
                want = g(torch.from_numpy(ext)[None, ..., None])[
                    0, 6:-6, :, :, 0].numpy()
            else:
                want = volume.infer_volume_3d(g, vol, depth=4)
        printed = capsys.readouterr().out
        assert ("infer_depth_sharded unavailable (depth-halo sharding "
                "requires depth_strides=(1, 1)); falling back to Hann depth "
                "windows" in printed) == (tag == "windows")
        assert sorted(os.listdir(out)) == sorted(
            os.path.basename(p) for p in paths)
        for i, p in enumerate(paths):
            expect = (want[i].astype(np.float64) + 1.0) * 0.5 * 4095.0
            assert np.abs(_stored(out, os.path.basename(p))
                          - expect).max() <= STORED_TOL


def test_infer_mode_on_the_cpu_in_a_fresh_interpreter(tmp_path):
    series = _series(str(tmp_path), SIZE)
    cfg = os.path.join(tmp_path, "P2p_small.yaml")
    with open(cfg, "w") as f:
        f.write(f"name: P2p\nsize: {SIZE}\nimage_save: '{tmp_path}/img/'\n"
                f"save_root: '{tmp_path}/model/'\n")
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from ctagan_tpu_torch.__main__ import main\n"
            f"sys.exit(main(['--config', {cfg!r}, '--mode', 'infer', "
            f"'--device', 'cpu', '--series', {series!r}]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = os.path.join(tmp_path, "img", "volume", "SE2")
    assert f"synthetic CTA written to: {out}" in res.stdout
    assert sorted(os.listdir(out)) == sorted(os.listdir(series))
    # without --series the mode refuses
    res = subprocess.run([sys.executable, "-m", "ctagan_tpu_torch",
                          "--config", cfg, "--mode", "infer", "--device",
                          "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and "--series" in res.stderr
