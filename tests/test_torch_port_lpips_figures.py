"""Parity: the port's LPIPS (``ops/lpips.py``), its figures
(``utils/figures.py``, ``TrainerBase.make_figures``) and ``test()`` on a
JAX ``.ckpt``, against the JAX package.

- ``lpips_distance`` and the AlexNet taps on seeded ``random_params``
  (the port's, drawn from a torch generator and converted to JAX's
  layouts), single slices and a batch, within 1e-5;
  ``load_weights_from_torch`` and ``combine_torch_checkpoints`` on the same
  files; ``make_lpips_fn``'s gate.
- The PNG codec: ``write_png_gray``'s bytes equal to JAX's, the read-back,
  ``to_uint8`` and ``make_panel`` equal.
- JAX's ``P2pTrainer`` (64², full-width G) saves a ``.ckpt`` with G made to
  differ from its seed; the port's ``P2pTrainer`` finds it in the same
  ``save_root`` and scores the same test list: the eight aggregates within
  1e-4 dB (PSNR, PSNRw) and 1e-5 (the others; ``METRIC_TOL`` says why);
  then with ``lpips_weights`` (seeded random weights) LPIPSw and LPIPS
  within 1e-5, the port's SE2 series written on that path too;
  ``make_figures``'s panels within 1 grey level of JAX's.
- ``--mode figures --device cpu`` in a fresh interpreter.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.ops import lpips as jax_lpips
from ctagan_tpu.train import P2pTrainer as JaxP2pTrainer
from ctagan_tpu.utils import figures as jax_figures
from ctagan_tpu.utils.config import load_config as jax_load_config
from ctagan_tpu_torch.data.fixtures import make_corpus
from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.ops import lpips
from ctagan_tpu_torch.train.trainers import P2pTrainer
from ctagan_tpu_torch.utils import figures
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_p2p import jax_tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
LPIPS_TOL = 1e-5
# test() against JAX's on the same checkpoint: test_torch_port_eval.py holds
# the metric suite to 1e-4 dB (PSNR) and 2e-6 (the others) on identical
# fakes; here each side runs its own full-width G (torch's CPU convs against
# XLA's, ~1e-6 apart per pixel), which moves UQI by up to 2.3e-6
# (measured), so the others are held to 1e-5
PSNR_TOL, METRIC_TOL = 1e-4, 1e-5
# the panel of a 64² slice: three images and three 2x zooms of a 64² crop
PANEL = (SIZE, 3 * SIZE + 3 * 2 * SIZE)
KEYS = ("MAEw", "PSNRw", "SSIMw", "UQIw", "MAE", "PSNR", "SSIM", "UQI")


def _weights_file(params, path):
    """``params`` in the combined weights file's keys, as
    ``combine_torch_checkpoints`` writes them."""
    out = {}
    for i, fi in enumerate((0, 3, 6, 8, 10)):
        out[f"features.{fi}.weight"] = params[f"conv{i}_w"]
        out[f"features.{fi}.bias"] = params[f"conv{i}_b"]
        out[f"lin{i}.model.1.weight"] = params[f"lin{i}_w"].reshape(
            1, -1, 1, 1)
    torch.save(out, path)
    return path


def _to_jax(params):
    """The port's LPIPS parameters (torch layouts) as JAX's (HWIO)."""
    out = {}
    for k, v in params.items():
        a = v.numpy()
        out[k] = jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return out


@pytest.fixture(scope="module")
def lp_params():
    return lpips.random_params(torch.Generator().manual_seed(0))


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(SIZE, SIZE), (2, SIZE, SIZE, 1),
                                   (1, 96, 80, 3)])
def test_lpips_distance_matches_jax(lp_params, shape):
    a, b = _images(shape, 1)
    b = np.clip(a + 0.3 * b, -1, 1)
    got = lpips.lpips_distance(lp_params, torch.from_numpy(a),
                               torch.from_numpy(b))
    want = jax_lpips.lpips_distance(_to_jax(lp_params), a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LPIPS_TOL)
    assert float(lpips.lpips_distance(lp_params, torch.from_numpy(a),
                                      torch.from_numpy(a)).max()) < 1e-6


def test_alexnet_taps_match_jax(lp_params):
    x, _ = _images((1, SIZE, SIZE, 3), 2)
    got = lpips.alexnet_features(lp_params,
                                 torch.from_numpy(x).permute(0, 3, 1, 2))
    want = jax_lpips.alexnet_features(_to_jax(lp_params), jnp.asarray(x))
    assert [t.shape[1] for t in got] == [64, 192, 384, 256, 256]
    for g, w in zip(got, want):  # 1e-5 of each tap's largest value
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_weights_files_load_as_jax_loads_them(lp_params, tmp_path):
    sd = {k: v.clone() for k, v in lp_params.items()}
    sd["lin2_w"] = sd["lin2_w"] - 0.01  # negative heads are clamped to 0
    path = _weights_file(sd, str(tmp_path / "w.pth"))
    got = lpips.load_weights_from_torch(path)
    want = jax_lpips.load_weights_from_torch(path)
    for k, v in _to_jax(got).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]))
    # the two-file build: torchvision's keys and the lpips package's heads
    raw = torch.load(path)
    alex = {k: v for k, v in raw.items() if k.startswith("features.")}
    heads = {f"lins.{k[3]}.model.1.weight": v for k, v in raw.items()
             if k.startswith("lin")}
    for name, obj in (("a.pth", alex), ("h.pth", heads)):
        torch.save(obj, str(tmp_path / name))
    lpips._main([str(tmp_path / "a.pth"), str(tmp_path / "h.pth"),
                 str(tmp_path / "out.pth")])
    fn = lpips.make_lpips_fn(str(tmp_path / "out.pth"))
    a, b = _images((SIZE, SIZE), 3)
    assert float(fn(torch.from_numpy(a), torch.from_numpy(b))) == float(
        lpips.lpips_distance(got, torch.from_numpy(a), torch.from_numpy(b)))
    assert lpips.make_lpips_fn("") is None and lpips.make_lpips_fn(None) is None
    with pytest.raises(FileNotFoundError, match="lpips_weights"):
        lpips.make_lpips_fn(str(tmp_path / "missing.pth"))


# -- figures -------------------------------------------------------------------

def test_png_bytes_and_panels_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    figures.write_png_gray(str(tmp_path / "p.png"), img)
    jax_figures.write_png_gray(str(tmp_path / "j.png"), img)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png"
                                                 ).read_bytes()
    np.testing.assert_array_equal(
        figures.read_png_gray(str(tmp_path / "j.png")), img)
    ims = [rng.uniform(-1.2, 1.2, (SIZE, SIZE)).astype(np.float32)
           for _ in range(3)]
    np.testing.assert_array_equal(figures.to_uint8(ims[0]),
                                  jax_figures.to_uint8(ims[0]))
    for zc in (None, (SIZE // 2, SIZE // 2), (5, 60)):
        np.testing.assert_array_equal(figures.make_panel(ims, zc),
                                      jax_figures.make_panel(ims, zc))
    with pytest.raises(ValueError):
        figures.write_png_gray(str(tmp_path / "f.png"), ims[0])


# -- test() and make_figures on a JAX checkpoint -------------------------------

@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """JAX's P2pTrainer and the port's on one corpus and one save_root that
    holds JAX's ``P2p_p2p_e2.ckpt`` (G differs from the seeded one)."""
    root = str(tmp_path_factory.mktemp("lpips_p2p"))
    lists = make_corpus(root, n_patients=2, slices_per_patient=3, size=SIZE,
                        seed=4, lists=("train",))
    cfg = dict(name="P2p", size=SIZE, seed=0, n_cpu=1,
               train_list=lists["train"], val_list=lists["train"],
               test_list=lists["train"], save_root=f"{root}/model/")
    jt = JaxP2pTrainer(jax_load_config(dict(
        cfg, data_parallel=False, image_save=f"{root}/jax_img/")),
        quiet=True)
    g = Generator(1, 1).reset_parameters(7)
    jt.state = jt.state.replace(g_params=jax.device_put(jax_tree(g)))
    jt._save(2)
    pt = P2pTrainer(load_config(dict(cfg, image_save=f"{root}/port_img/")),
                    torch.device("cpu"), quiet=True)
    return {"jax": jt, "port": pt, "root": root}


@pytest.fixture(scope="module")
def scored(trainers):
    jt, pt = trainers["jax"], trainers["port"]
    return {"jax": jt.test(write_dicom=False),
            "port": pt.test(write_dicom=False)}


@pytest.mark.parametrize("key", KEYS)
def test_test_on_a_jax_checkpoint_matches_jax(scored, key):
    got, want = scored["port"][key], scored["jax"][key]
    assert set(scored["port"]) == set(KEYS)
    tol = PSNR_TOL if "PSNR" in key else METRIC_TOL
    assert abs(got - want) <= tol, (key, got, want)


@pytest.fixture(scope="module")
def scored_lpips(trainers, lp_params, scored):
    path = _weights_file(
        lp_params, os.path.join(trainers["root"], "lpips_w.pth"))
    out = {}
    for side in ("jax", "port"):
        t = trainers[side]
        t.config.lpips_weights = path
        try:
            out[side] = t.test(write_dicom=side == "port")
        finally:
            t.config.lpips_weights = ""
    return out


@pytest.mark.parametrize("key", [*KEYS, "LPIPSw", "LPIPS"])
def test_test_with_lpips_matches_jax(scored_lpips, key):
    got, want = scored_lpips["port"][key], scored_lpips["jax"][key]
    tol = (LPIPS_TOL if "LPIPS" in key else
           PSNR_TOL if "PSNR" in key else METRIC_TOL)
    assert abs(got - want) <= tol, (key, got, want)


def test_lpips_path_writes_the_se2_series(trainers, scored_lpips):
    img = trainers["port"].config.image_save
    assert sorted(os.listdir(os.path.join(img, "ST1"))) == ["1", "2"]
    for p in ("1", "2"):
        assert len(os.listdir(os.path.join(img, "ST1", p, "SE2"))) == 3


def test_make_figures_matches_jax(trainers, scored):
    root = trainers["root"]
    want_dir = trainers["jax"].make_figures(os.path.join(root, "jax_fig"),
                                            limit=4)
    got_dir = trainers["port"].make_figures(os.path.join(root, "port_fig"),
                                            limit=4)
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) == [
        f"slice{i}.png" for i in range(4)]
    for n in names:
        got = figures.read_png_gray(os.path.join(got_dir, n)).astype(int)
        want = jax_figures.read_png_gray(os.path.join(want_dir, n)).astype(
            int)
        assert got.shape == want.shape == PANEL
        assert int(np.abs(got - want).max()) <= 1, n


def test_figures_mode_on_the_cpu_in_a_fresh_interpreter(tmp_path):
    lst = make_corpus(str(tmp_path), n_patients=1, slices_per_patient=2,
                      size=SIZE, seed=4, lists=("train",))["train"]
    cfg = os.path.join(tmp_path, "P2p_small.yaml")
    with open(cfg, "w") as f:
        f.write(f"name: P2p\nsize: {SIZE}\nn_cpu: 1\n"
                f"image_save: '{tmp_path}/img/'\n"
                f"save_root: '{tmp_path}/model/'\n")
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from ctagan_tpu_torch.__main__ import main\n"
            f"sys.exit(main(['--config', {cfg!r}, '--mode', 'figures', "
            f"'--device', 'cpu', '--test-list', {lst!r}]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = os.path.join(tmp_path, "img", "panels")
    assert f"panels: {out}" in res.stdout
    assert sorted(os.listdir(out)) == ["slice0.png", "slice1.png"]
    assert figures.read_png_gray(os.path.join(out, "slice0.png")).shape == \
        PANEL
