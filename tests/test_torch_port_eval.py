"""Parity: the port's eval ops against the JAX package's on the same inputs.

- The display-window transforms (``ops/windowing.py``) bit-equal to JAX's
  functions evaluated op by op on every stored value 0..4095, under three
  (WC, WW) pairs and with per-sample (N,) windows. Under ``jax.jit`` XLA
  turns JAX's division by the constant 255 into a multiply by its
  reciprocal (JAX's own windowing comments measure the drift); there the
  port is within one f32 ulp with the same masks.
- The metrics (``ops/metrics.py``), ``_masked_views``, ``_metric_suite``
  and ``evaluate_pair`` (``train/evaluation.py``) against JAX on identical
  f32 inputs: PSNR within 1e-4 dB, MAE, SSIM and UQI within 2e-6, the edge
  cases (no foreground, identical images, a constant image) included. Both
  sides sum in f32, in other orders (torch's cascade sums, XLA's loop), and
  over a 64² slice JAX's own f32 result of UQI lies up to ~1e-5 from the
  exact value (a float64 evaluation of the same formula, ``_ref64``), while
  the port's lies within ~2e-7 of it. So each comparison allows the stated
  tolerance plus JAX's own distance from the float64 value.
- ``DicomWriteback`` against JAX's on the same slices, the DICOM reader's
  path and window accessors, the config's new fields and the checkpoint
  naming.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.data import dicom as jax_dicom
from ctagan_tpu.ops import metrics as jax_metrics
from ctagan_tpu.ops import windowing as jax_win
from ctagan_tpu.train import evaluation as jax_eval
from ctagan_tpu.utils import checkpoint as jax_ckpt
from ctagan_tpu.utils.config import Config as JaxConfig
from ctagan_tpu_torch.data import dicom
from ctagan_tpu_torch.data.fixtures import make_corpus, synthetic_ct_pixels
from ctagan_tpu_torch.ops import metrics, windowing
from ctagan_tpu_torch.train import evaluation
from ctagan_tpu_torch.utils import checkpoint
from ctagan_tpu_torch.utils.config import Config, load_config

torch.set_num_threads(2)

PSNR_TOL = 1e-4  # dB
METRIC_TOL = 2e-6  # MAE, SSIM, UQI
ULP = float(np.spacing(np.float32(1.0)))  # 2^-23: the largest jit drift
WINDOWS = [(50.0, 400.0), (300.0, 1500.0), (40.0, 80.0)]
RAW = np.arange(4096, dtype=np.float32).reshape(64, 64)
FULL = np.asarray(jax_win.fullrange_normalize(RAW))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x)


# -- windowing ---------------------------------------------------------------

def _window_cases(wc, ww):
    """name -> (port result, JAX result) on every stored value."""
    jwin = jax_win.to_windowdata(FULL, wc, ww)
    pwin = windowing.to_windowdata(_t(FULL), wc, ww)
    jmask, pmask = jax_win.body_mask(jwin), windowing.body_mask(pwin)
    return {
        "window_limits": (torch.stack(windowing._window_limits(wc, ww)),
                          jnp.stack(jax_win._window_limits(wc, ww))),
        "window_normalize": (windowing.window_normalize(_t(RAW - 1024), wc,
                                                        ww),
                             jax_win.window_normalize(RAW - 1024, wc, ww)),
        "fullrange_normalize": (windowing.fullrange_normalize(_t(RAW)),
                                jax_win.fullrange_normalize(RAW)),
        "to_windowdata": (pwin, jwin),
        "body_mask": (pmask, jmask),
        "mask_background_to_air": (
            windowing.mask_background_to_air(pwin, pmask),
            jax_win.mask_background_to_air(jwin, jmask)),
    }


@pytest.mark.parametrize("fn", ["window_limits", "window_normalize",
                                "fullrange_normalize", "to_windowdata",
                                "body_mask", "mask_background_to_air"])
@pytest.mark.parametrize("wc,ww", WINDOWS)
def test_windowing_bit_equal_to_jax(fn, wc, ww):
    got, want = _window_cases(wc, ww)[fn]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("wc,ww", WINDOWS)
def test_windowing_within_an_ulp_of_jitted_jax(wc, ww):
    got = windowing.to_windowdata(_t(FULL), wc, ww).numpy()
    want = _np(jax.jit(jax_win.to_windowdata)(FULL, jnp.float32(wc),
                                              jnp.float32(ww)))
    assert np.abs(got - want).max() <= ULP
    np.testing.assert_array_equal(got >= 0.3, want >= 0.3)


def test_windowing_per_sample_windows():
    """(N,) windows broadcast over each sample's H, W, as JAX's vmap."""
    imgs = np.stack([FULL] * len(WINDOWS))
    wc, ww = (np.array(v, np.float32) for v in zip(*WINDOWS))
    got = windowing.to_windowdata(_t(imgs), _t(wc), _t(ww))
    want = jax.vmap(jax_win.to_windowdata)(imgs, wc, ww)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    for i, (c, w) in enumerate(WINDOWS):
        np.testing.assert_array_equal(
            got[i].numpy(), windowing.to_windowdata(_t(FULL), c, w).numpy())


def test_exact_zero_inside_the_mask_becomes_air():
    img = _t([[0.0, 0.5], [-0.25, 0.0]])
    mask = _t([[1.0, 1.0], [1.0, 0.0]])
    got = windowing.mask_background_to_air(img, mask)
    np.testing.assert_array_equal(got.numpy(), [[-1.0, 0.5], [-0.25, -1.0]])


# -- metrics -----------------------------------------------------------------

def _pair(seed, size=64):
    """A real full-range CT slice (air background −1) and a noisy fake."""
    rng = np.random.default_rng(seed)
    real = _np(jax_win.fullrange_normalize(
        synthetic_ct_pixels(rng, size, contrast=True).astype(np.float32)))
    fake = np.clip(real + rng.normal(0, 0.05, real.shape), -1, 1)
    return fake.astype(np.float32), real


def _edge(kind):
    fake, real = _pair(3)
    if kind == "no_foreground":
        real = np.full_like(real, -1.0)
    elif kind == "identical":
        fake = real.copy()
    elif kind == "constant":
        fake = np.full_like(fake, 0.25)
    return fake, real


METRICS = ["masked_psnr", "masked_mae", "ssim", "uqi"]
KINDS = ["noisy", "no_foreground", "identical", "constant"]


def _tol(name):
    return PSNR_TOL if "psnr" in name.lower() else METRIC_TOL


def _box64(x, win=7):
    v = np.lib.stride_tricks.sliding_window_view(x, (win, win), (-2, -1))
    return v.sum((-2, -1)) / (win * win)


def _ref64(name, fake, real):
    """The metric's formula in float64 over the (H, W) or (N, H, W) f32
    inputs: the exact value that both f32 implementations round toward."""
    f, r = np.asarray(fake, np.float64), np.asarray(real, np.float64)
    hw = (-2, -1)
    mask = r != -1.0
    n_fg = mask.sum(hw)
    if name in ("masked_psnr", "masked_mae"):
        err = (((f + 1) / 2 - (r + 1) / 2) ** 2 if name == "masked_psnr"
               else np.abs(f - r))
        fg = (err * mask).sum(hw) / np.maximum(n_fg, 1)
        val = np.where(n_fg > 0, fg, err.mean(hw) + 1e-10)
        if name == "masked_mae":
            return val / 2
        with np.errstate(divide="ignore"):
            psnr = 20 * np.log10(1 / (np.sqrt(val) + 1e-10))
        return np.where(val < 1e-10, 100.0, psnr)
    if name == "uqi":
        m = f.shape[-1] * f.shape[-2]
        mf, mr = f.mean(hw, keepdims=True), r.mean(hw, keepdims=True)
        vf = ((f - mf) ** 2).sum(hw) / (m - 1)
        vr = ((r - mr) ** 2).sum(hw) / (m - 1)
        cov = ((f - mf) * (r - mr)).sum(hw) / (m - 1)
        mf, mr = mf[..., 0, 0], mr[..., 0, 0]
        return 4 * mf * mr * cov / ((mf ** 2 + mr ** 2) * (vf + vr) + 1e-10)
    ux, uy = _box64(f), _box64(r)
    cn = 49 / 48
    vx, vy = cn * (_box64(f * f) - ux * ux), cn * (_box64(r * r) - uy * uy)
    vxy = cn * (_box64(f * r) - ux * uy)
    c1, c2 = 0.02 ** 2, 0.06 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    return s.mean(hw)


def _close(name, got, want, ref):
    """|got − want| <= tol + |want − ref|: the port within the tolerance of
    JAX, beyond JAX's own f32 rounding."""
    got, want, ref = (np.asarray(v, np.float64) for v in (got, want, ref))
    assert np.all(np.abs(got - want) <= _tol(name) + np.abs(want - ref)), (
        name, got, want, ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name, kind):
    fake, real = _edge(kind)
    got = getattr(metrics, name)(_t(fake), _t(real))
    want = float(getattr(jax_metrics, name)(fake, real))
    assert got.shape == ()
    _close(name, got, want, _ref64(name, fake, real))
    if kind == "identical" and name == "masked_psnr":
        assert float(got) == 100.0


@pytest.mark.parametrize("name", METRICS)
def test_batched_metric_matches_jax_vmap(name):
    pairs = [_edge(k) for k in KINDS]
    fakes, reals = (np.stack(x) for x in zip(*pairs))
    got = getattr(metrics, name)(_t(fakes), _t(reals))
    want = _np(jax.vmap(getattr(jax_metrics, name))(fakes, reals))
    assert got.shape == (len(KINDS),)
    _close(name, got, want, _ref64(name, fakes, reals))


def test_uniform_filter_is_a_box_sum_matching_jax():
    x = np.random.default_rng(5).uniform(-1, 1, (2, 40, 48)).astype(
        np.float32)
    got = metrics._uniform_filter(_t(x), 7)
    want = jax.vmap(lambda im: jax_metrics._uniform_filter(im, 7))(x)
    assert got.shape == (2, 34, 42)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
    src = open(metrics.__file__).read()
    assert "conv2d" not in src.replace("a ``conv2d``", "")


# -- eval suite --------------------------------------------------------------

@pytest.mark.parametrize("wc,ww", WINDOWS)
def test_masked_views_match_jax(wc, ww):
    fake, real = _pair(7)
    got = evaluation._masked_views(_t(fake), _t(real), wc, ww)
    want = jax_eval._masked_views(fake, real, wc, ww)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def _suite_cases():
    pairs = [_pair(s) for s in (11, 12)] + [_edge(k) for k in KINDS[1:]]
    fakes, reals = (np.stack(x) for x in zip(*pairs))
    wc = np.array([50, 300, 40, 50, 300], np.float32)
    ww = np.array([400, 1500, 80, 400, 1500], np.float32)
    return fakes, reals, wc, ww


SUITE = {"MAE": "masked_mae", "PSNR": "masked_psnr", "SSIM": "ssim",
         "UQI": "uqi"}


def _suite_ref64(fake, real, wc, ww):
    """The eight metrics in float64 on the port's masked views (bit-equal
    to JAX's, above)."""
    c_m, b_m, fake_m, real_m = (v.numpy() for v in evaluation._masked_views(
        _t(fake), _t(real), wc, ww))
    out = {}
    for key, name in SUITE.items():
        out[key + "w"] = _ref64(name, c_m, b_m)
        out[key] = _ref64(name, fake_m, real_m)
    return out


def _check_suite_row(got_row, want_dict, ref_dict):
    for i, key in enumerate(evaluation.METRIC_KEYS):
        _close(key, float(got_row[i]), float(want_dict[key]), ref_dict[key])


def test_metric_suite_matches_jitted_jax():
    fakes, reals, wc, ww = _suite_cases()
    got = evaluation._metric_suite(_t(fakes), _t(reals), _t(wc), _t(ww))
    assert got.shape == (8, len(wc))
    want = jax.jit(jax.vmap(jax_eval._metric_suite))(fakes, reals, wc, ww)
    ref = _suite_ref64(fakes, reals, _t(wc), _t(ww))
    for j in range(len(wc)):
        _check_suite_row(got[:, j], {k: v[j] for k, v in want.items()},
                         {k: v[j] for k, v in ref.items()})


def test_batched_suite_equals_per_slice_suite():
    fakes, reals, wc, ww = _suite_cases()
    got = evaluation._metric_suite(_t(fakes), _t(reals), _t(wc), _t(ww))
    for j in range(len(wc)):
        one = evaluation._metric_suite(_t(fakes[j]), _t(reals[j]),
                                       float(wc[j]), float(ww[j]))
        assert one.shape == (8,)
        np.testing.assert_allclose(got[:, j].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("j", range(5))
def test_evaluate_pair_matches_jax(j):
    fakes, reals, wc, ww = _suite_cases()
    got = evaluation.evaluate_pair(fakes[j], reals[j], float(wc[j]),
                                   float(ww[j]))
    want = jax_eval.evaluate_pair(fakes[j], reals[j], float(wc[j]),
                                  float(ww[j]))
    assert list(got) == list(evaluation.METRIC_KEYS)
    assert set(want) == set(got)
    _check_suite_row([got[k] for k in got], want,
                     _suite_ref64(fakes[j], reals[j], float(wc[j]),
                                  float(ww[j])))
    # with an LPIPS function both score LPIPSw and LPIPS on the same masked
    # views (here a mean square, which runs on either side's arrays)
    def sq(a, b):
        return ((a - b) ** 2).mean()

    got = evaluation.evaluate_pair(fakes[j], reals[j], 50.0, 400.0,
                                   lpips_fn=sq)
    want = jax_eval.evaluate_pair(fakes[j], reals[j], 50.0, 400.0,
                                  lpips_fn=sq)
    assert list(got) == [*evaluation.METRIC_KEYS, "LPIPSw", "LPIPS"]
    for key in ("LPIPSw", "LPIPS"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])


def test_aggregate_matches_jax():
    rows = [{"PSNR": 30.0 + i, "SSIM": 0.5 + i / 10} for i in range(5)]
    assert evaluation.aggregate(rows) == jax_eval.aggregate(rows)
    assert evaluation.aggregate([]) == {}


# -- DICOM -------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_ops_corpus")
    lists = make_corpus(str(root), n_patients=2, slices_per_patient=2,
                        size=32, seed=3, lists=("test",))
    with open(lists["test"]) as f:
        return [ln.strip() for ln in f if ln.strip()]


def test_read_dicom_takes_a_path_and_reads_the_window(corpus):
    path = corpus[0].replace("SE0", "SE1")
    by_path = dicom.read_dicom(path)
    with open(path, "rb") as f:
        by_bytes = dicom.read_dicom(f.read())
    want = jax_dicom.read_dicom(path)
    assert [(e.tag, e.value) for e in by_path.elements] == [
        (e.tag, e.value) for e in by_bytes.elements]
    assert (by_path.window_center, by_path.window_width) == (
        want.window_center, want.window_width) == (50.0, 400.0)
    by_path.set_str(dicom.TAG_WINDOW_CENTER, "300\\40", b"DS")
    by_path.set_str(dicom.TAG_WINDOW_WIDTH, "", b"DS")
    assert by_path.window_center == 300.0
    assert by_path.window_width is None
    assert by_path.get_ds(dicom.TAG_WINDOW_CENTER) == [300.0, 40.0]
    assert by_path.get_ds1(dicom.TAG_WINDOW_WIDTH, 400.0) == 400.0


@pytest.mark.parametrize("stored", [False, True])
def test_dicom_writeback_matches_jax(tmp_path, corpus, stored):
    """The same fakes through both writers: the same tree, copies equal to
    their sources, SE2 pixels equal, one fresh series UID per patient."""
    rng = np.random.default_rng(9)
    fakes = rng.uniform(-1, 1, (len(corpus), 32, 32)).astype(np.float32)
    if stored:  # de-normalized on the device, as test() hands them over
        fakes = ((fakes + 1.0) * 0.5 * 4095.0).astype(np.int16)
    trees = {}
    for name, cls in (("port", evaluation.DicomWriteback),
                      ("jax", jax_eval.DicomWriteback)):
        wb = cls(str(tmp_path / name))
        for path, fake in zip(corpus, fakes):
            wb.write(path, fake)
        root = str(tmp_path / name)
        trees[name] = sorted(os.path.relpath(os.path.join(d, f), root)
                             for d, _, fs in os.walk(root) for f in fs)
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]) == 3 * len(corpus)
    uids = set()
    for rel in trees["port"]:
        got = open(tmp_path / "port" / rel, "rb").read()
        if "SE2" not in rel:
            patient = int(rel.split(os.sep)[1])
            src = [p for p in corpus if p.endswith(rel.split(os.sep)[-1])
                   and f"patient{patient - 1}" in p][0]
            se = rel.split(os.sep)[2]
            assert got == open(src.replace("SE0", se), "rb").read()
            continue
        ds, want = dicom.read_dicom(got), jax_dicom.read_dicom(
            str(tmp_path / "jax" / rel))
        np.testing.assert_array_equal(ds.pixel_array(), want.pixel_array())
        uids.add((rel.split(os.sep)[1], ds.series_instance_uid))
    assert len(uids) == 2 and len({u for _, u in uids}) == 2


# -- config and checkpoint names ---------------------------------------------

NEW_FIELDS = ["save_root", "image_save", "val_every", "eval_batch",
              "fused_body", "checkpoint_every_iters", "resume",
              "collapse_guard", "collapse_drop_db", "collapse_lrd_backoff",
              "lpips_weights", "checkpoint_backend"]


@pytest.mark.parametrize("name", NEW_FIELDS)
def test_config_defaults_match_jax(name):
    assert getattr(Config(), name) == getattr(JaxConfig(), name)


@pytest.mark.parametrize("bad", [{"collapse_drop_db": 0.0},
                                 {"collapse_lrd_backoff": 0.0},
                                 {"collapse_lrd_backoff": 1.5},
                                 {"checkpoint_backend": "pickle"}])
def test_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        load_config(bad)


def test_config_lpips_raises_and_backend_is_accepted():
    # LPIPS is ported: the config takes the path, and a configured file
    # that does not exist raises where test() builds the metric, as JAX's
    from ctagan_tpu_torch.ops.lpips import make_lpips_fn

    assert load_config({"lpips_weights": "alex.npz"}).lpips_weights == \
        "alex.npz"
    with pytest.raises(FileNotFoundError, match="lpips_weights"):
        make_lpips_fn("/nonexistent/alex.npz")
    assert load_config({"checkpoint_backend": "orbax"}).checkpoint_backend \
        == "orbax"


@pytest.mark.parametrize("epoch,psnr,ssim", [(5, None, None),
                                             (45, 32.63581234, 0.93912),
                                             (7, -1.5, 0.25)])
def test_checkpoint_names_follow_jax_under_the_port_suffix(tmp_path, epoch,
                                                           psnr, ssim):
    got = checkpoint.checkpoint_name("HdGan_hd1", epoch, psnr, ssim)
    want = jax_ckpt.checkpoint_name("HdGan_hd1", epoch, psnr, ssim)
    assert got == want[: -len(".ckpt")] + ".pt"
    for name in (got, want):
        (tmp_path / name).write_bytes(b"x")
    # the port lists JAX's file too, its own first on an equal epoch
    assert checkpoint.find_checkpoints(str(tmp_path), "HdGan_hd1") == [
        (str(tmp_path / got), epoch), (str(tmp_path / want), epoch)]
    assert jax_ckpt.find_checkpoints(str(tmp_path), "HdGan_hd1") == [
        (str(tmp_path / want), epoch)]


def test_checkpoint_save_is_atomic_and_found_newest_first(tmp_path):
    payload = {"state": {"w": torch.arange(4.0)}, "epoch": 3, "lr": 1e-4,
               "lr_d": 2e-4}
    for epoch in (3, 10, 7):
        checkpoint.save_checkpoint(str(tmp_path), "P", epoch, payload)
    assert sorted(os.listdir(tmp_path)) == ["P_e10.pt", "P_e3.pt", "P_e7.pt"]
    assert [e for _, e in checkpoint.find_checkpoints(str(tmp_path), "P")] \
        == [10, 7, 3]
    assert checkpoint.find_latest_checkpoint(str(tmp_path), "Q") is None
    got = checkpoint.load_checkpoint(str(tmp_path / "P_e3.pt"))
    assert torch.equal(got["state"]["w"], payload["state"]["w"])
    assert (got["epoch"], got["lr"], got["lr_d"]) == (3, 1e-4, 2e-4)
    # JAX's orbax directories are not read yet
    with pytest.raises(NotImplementedError, match="M6"):
        checkpoint.load_checkpoint(str(tmp_path / "P_e1.ocp"))
