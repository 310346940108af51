"""Parity: the port's eval path and checkpoint loop against the JAX
package's ``HdTrainerStage1``, on one seeded ``make_corpus`` corpus at 128²
(three patients of two slices; patient 1's SE1 headers rewritten to WC 300 / WW 1500, so
each slice scores in its own window) with JAX's G weights converted.

- ``validate()`` and ``test()`` aggregates within 1e-2 dB (PSNR) and 1e-3
  (the others) of JAX's: the same formulas in f32 over another generator
  implementation (the full-width G in torch against XLA, sums in other
  orders).
- The SE2 tree equal to JAX's writeback: the same files and patient
  numbering, SE0/SE1 copies byte-equal to the sources, SE2 stored pixels
  within ±1 (a fake that lands on a truncation boundary).
- ``eval_batch`` 2 against 1 within 1e-6, on one CPU thread (the
  comment at ``BATCH_TOL`` says why).
- Checkpoints: a ``resume`` round trip with every tensor equal, a truncated
  newest checkpoint quarantined, the collapse guard (as
  ``tests/test_collapse_guard.py`` holds JAX's), and the loop's epoch-end,
  mid-epoch and emergency saves.
- ``python -m ctagan_tpu_torch --mode test --device cpu`` end to end, and
  its refusal without a card.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ctagan_tpu.train import HdTrainerStage1 as JaxHdTrainerStage1
from ctagan_tpu.utils.config import load_config as jax_load_config
from ctagan_tpu_torch.__main__ import main
from ctagan_tpu_torch.data import dicom
from ctagan_tpu_torch.data.fixtures import make_corpus
from ctagan_tpu_torch.models.convert import generator_state_dict
from ctagan_tpu_torch.train.trainers import HdTrainerStage1
from ctagan_tpu_torch.utils.checkpoint import find_checkpoints
from ctagan_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128  # JAX's RegNet needs 128² (64² pads an empty axis)
N_TEST = 6  # three patients of two slices
PSNR_TOL = 1e-2  # dB, trainer aggregates against JAX
AGG_TOL = 1e-3   # the other aggregates
# eval_batch 2 against 1, both runs on one intra-op thread. The port scores
# each slice of a batch in the same order as a batch of one (its metric
# sums are bit-equal on the same fakes), but the CPU conv and norm kernels
# that the generator runs split a batch of two across their threads, and
# with a split that does not fall on the batch (3 or 5 threads) a slice's
# fake moves by a few f32 ulps (up to 7.9e-7 measured), and the val PSNR
# with it (1.6e-7 dB measured on a seeded G at 3 threads; 1.55e-5 dB in
# the one failed whole run). On one thread the arithmetic does not depend
# on the batch.
BATCH_TOL = 1e-6
KEYS = ("MAEw", "PSNRw", "SSIMw", "UQIw", "MAE", "PSNR", "SSIM", "UQI")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_corpus")
    lists = make_corpus(str(root), n_patients=3, slices_per_patient=2,
                        size=SIZE, seed=5, lists=("train",))
    with open(lists["train"]) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    for p in paths:
        if "patient1" in p:
            b = p.replace("SE0", "SE1")
            ds = dicom.read_dicom(b)
            ds.set_str(dicom.TAG_WINDOW_CENTER, "300", b"DS")
            ds.set_str(dicom.TAG_WINDOW_WIDTH, "1500", b"DS")
            dicom.write_dicom(ds, b)
    out = {"train": lists["train"], "root": str(root)}
    for name, chunk in (("val", paths[::3]), ("test", paths)):
        out[name] = os.path.join(str(root), f"{name}.txt")
        with open(out[name], "w") as f:
            f.write("\n".join(chunk) + "\n")
    return out


def _cfg(corpus, tag, **kw):
    base = os.path.join(corpus["root"], tag)
    cfg = dict(name="HdGan", size=SIZE, seed=0, n_cpu=2, batchSize=1,
               train_list=corpus["train"], val_list=corpus["val"],
               test_list=corpus["test"], save_root=base + "_model/",
               image_save=base + "_img/")
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def jax_run(corpus):
    """JAX's trainer, built once: its G weights, validate() and test()."""
    t = JaxHdTrainerStage1(jax_load_config(
        _cfg(corpus, "jax", data_parallel=False)), quiet=True)
    val = t.validate()
    agg = t.test(write_dicom=True)
    g = generator_state_dict(jax.device_get(t._g_params()))
    return {"g": g, "val": val, "test": agg,
            "img": t.config.image_save}


@pytest.fixture(scope="module")
def port(corpus, jax_run):
    t = HdTrainerStage1(load_config(_cfg(corpus, "port")),
                        torch.device("cpu"), quiet=True)
    t.g_model.load_state_dict(jax_run["g"], strict=True)
    return t


@pytest.fixture(scope="module")
def port_run(port):
    return {"val": port.validate(), "test": port.test(write_dicom=True)}


def _near(key, got, want, psnr_tol=PSNR_TOL, tol=AGG_TOL):
    assert abs(got - want) <= (psnr_tol if "PSNR" in key else tol), (
        key, got, want)


@pytest.mark.parametrize("i,key", enumerate(["PSNR", "SSIM"]))
def test_validate_matches_jax(jax_run, port_run, i, key):
    _near(key, port_run["val"][i], float(jax_run["val"][i]))


@pytest.mark.parametrize("key", KEYS)
def test_test_aggregates_match_jax(jax_run, port_run, key):
    assert set(port_run["test"]) == set(KEYS) == set(jax_run["test"])
    _near(key, port_run["test"][key], jax_run["test"][key])


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_se2_tree_matches_jax_writeback(corpus, jax_run, port_run, port):
    got_root, want_root = port.config.image_save, jax_run["img"]
    tree = _tree(got_root)
    assert tree == _tree(want_root)
    assert len(tree) == 3 * N_TEST
    assert {rel.split(os.sep)[1] for rel in tree} == {"1", "2", "3"}
    uids = {}
    for rel in tree:
        got = open(os.path.join(got_root, rel), "rb").read()
        if "SE2" not in rel:
            assert got == open(os.path.join(want_root, rel), "rb").read()
            continue
        ds = dicom.read_dicom(got)
        want = dicom.read_dicom(os.path.join(want_root, rel))
        diff = np.abs(ds.pixel_array().astype(np.int32)
                      - want.pixel_array().astype(np.int32))
        assert diff.max() <= 1, rel
        uids.setdefault(rel.split(os.sep)[1], set()).add(
            ds.series_instance_uid)
    assert all(len(u) == 1 for u in uids.values())
    assert len(set.union(*uids.values())) == 3


def test_se0_se1_copies_are_the_sources(corpus, port_run, port):
    with open(corpus["test"]) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    root = port.config.image_save
    for p in paths:
        patient = int(p.split("patient")[1].split(os.sep)[0]) + 1
        name = os.path.basename(p)
        for se in ("SE0", "SE1"):
            copy = os.path.join(root, "ST0", str(patient), se, name)
            assert open(copy, "rb").read() == open(
                p.replace("SE0", se), "rb").read()


def _single_threaded_eval(port, eval_batch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    port.config.eval_batch = eval_batch
    try:
        return port.validate(), port.test(write_dicom=False)
    finally:
        port.config.eval_batch = 1
        torch.set_num_threads(threads)


def test_eval_batch_2_matches_1(port):
    val1, agg1 = _single_threaded_eval(port, 1)
    val, agg = _single_threaded_eval(port, 2)
    for i in range(2):
        assert abs(val[i] - val1[i]) <= BATCH_TOL
    for key in KEYS:
        assert abs(agg[key] - agg1[key]) <= BATCH_TOL, key


# -- checkpoints -------------------------------------------------------------

def _fresh(corpus, tmp_path, **kw):
    cfg = _cfg(corpus, "unused", save_root=str(tmp_path / "model") + "/",
               image_save=str(tmp_path / "img") + "/", **kw)
    return HdTrainerStage1(load_config(cfg), torch.device("cpu"), quiet=True)


def _stir(t, seed):
    """Give every net new weights and every optimizer a state."""
    gen = torch.Generator().manual_seed(seed)
    st = t.state
    for model, opt in ((st.g_model, st.g_opt), (st.r_model, st.r_opt),
                       (st.d_model, st.d_opt)):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        for group in opt.param_groups:
            group["lr"] = 1e-3
        opt.step()
        opt.zero_grad(set_to_none=True)
    torch.rand(3, generator=st.gen)


def _tensors(t):
    flat = {}

    def walk(prefix, obj):
        if isinstance(obj, torch.Tensor):
            flat[prefix] = obj.detach().cpu().clone()
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}/{k}", v)

    walk("", t._checkpoint_state())
    return flat


def test_resume_restores_every_tensor(corpus, tmp_path):
    a = _fresh(corpus, tmp_path)
    _stir(a, 1)
    a.lr, a.lr_d = 7e-5, 3e-5
    a._save(3)
    want = _tensors(a)
    b = _fresh(corpus, tmp_path, resume=True)
    assert (b.start_epoch, b.lr, b.lr_d) == (3, 7e-5, 3e-5)
    got = _tensors(b)
    assert set(got) == set(want) and len(want) > 100
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a torn newest checkpoint is set aside and the next newest taken
    src = tmp_path / "model" / "HdGan_hd1_e3.pt"
    torn = tmp_path / "model" / "HdGan_hd1_e4.pt"
    torn.write_bytes(src.read_bytes()[: src.stat().st_size // 2])
    c = _fresh(corpus, tmp_path, resume=True)
    assert c.start_epoch == 3
    assert (tmp_path / "model" / "HdGan_hd1_e4.pt.corrupt").exists()
    assert not torn.exists()
    for k, v in _tensors(c).items():
        assert torch.equal(v, want[k]), k


def test_load_generator_takes_a_pth_or_a_port_checkpoint(corpus, tmp_path,
                                                         jax_run):
    t = _fresh(corpus, tmp_path)
    pth = tmp_path / "G.pth"
    torch.save(jax_run["g"], pth)
    t.load_generator(str(pth))
    for k, v in t.g_model.state_dict().items():
        assert torch.equal(v, jax_run["g"][k]), k
    _stir(t, 2)
    path = t._save(1)
    want = {k: v.clone() for k, v in t.g_model.state_dict().items()}
    t.load_generator(str(pth))
    t.load_generator(path)
    for k, v in t.g_model.state_dict().items():
        assert torch.equal(v, want[k]), k
    # a JAX checkpoint (flax msgpack) of JAX's G is read too; JAX's orbax
    # directories are not read yet
    from ctagan_tpu.models import torch_import
    from ctagan_tpu.utils import checkpoint as jax_ckpt

    tree = torch_import.import_generator(
        {k: v.numpy() for k, v in jax_run["g"].items()})
    jax_path = jax_ckpt.save_checkpoint(str(tmp_path), "HdGan_hd1", 4, {
        "state": {"g_params": tree}, "epoch": 4, "lr": 1e-4, "lr_d": 1e-4})
    t.load_generator(jax_path)
    for k, v in t.g_model.state_dict().items():
        assert torch.equal(v, jax_run["g"][k]), k
    with pytest.raises(NotImplementedError, match="M6"):
        t.load_generator(str(tmp_path / "HdGan_hd1_e1.ocp"))


def _zero_g(t):
    with torch.no_grad():
        for p in t.g_model.parameters():
            p.zero_()


def test_guard_restores_best_and_backs_off_dlr(corpus, tmp_path):
    t = _fresh(corpus, tmp_path)
    t._save(1, 30.0, 0.9)
    best = {k: v.clone() for k, v in t.g_model.state_dict().items()}
    assert t._collapse_guard(1, 30.0, 0.9) is False  # first val: the best
    _zero_g(t)
    t.lr_d = 1e-4
    t._save(2, 20.0, 0.5)  # the collapsed epoch's own checkpoint
    assert t._collapse_guard(2, 20.0, 0.5) is True  # 10 dB >= 6
    for k, v in t.g_model.state_dict().items():
        assert torch.equal(v, best[k]), k
    assert t.lr_d == pytest.approx(5e-5)
    _zero_g(t)  # a second collapse: the same target, D lr halved again
    t._save(3, 19.0, 0.5)
    assert t._collapse_guard(3, 19.0, 0.5) is True
    assert t.lr_d == pytest.approx(2.5e-5)


def test_guard_holds_below_threshold_and_when_off(corpus, tmp_path):
    t = _fresh(corpus, tmp_path)
    t._save(1, 30.0, 0.9)
    t._collapse_guard(1, 30.0, 0.9)
    _zero_g(t)
    t.lr_d = 1e-4
    assert t._collapse_guard(2, 28.0, 0.9) is False  # 2 dB: GAN jitter
    assert t.lr_d == pytest.approx(1e-4)
    assert all(float(p.detach().abs().sum()) == 0.0
               for p in t.g_model.parameters())
    t._save(3, 31.0, 0.92)
    assert t._collapse_guard(3, 31.0, 0.92) is False
    assert t._best_val[0] == 31.0
    off = _fresh(corpus, tmp_path, collapse_guard=False)
    off._collapse_guard(1, 30.0, 0.9)
    off.lr_d = 1e-4
    assert off._collapse_guard(2, 10.0, 0.1) is False
    assert off.lr_d == pytest.approx(1e-4)


def _loop_trainer(corpus, tmp_path, fail_at=None, **kw):
    """A trainer whose step and validation are stubs and whose saves are
    recorded: the loop's schedule of checkpoints, without the nets' work."""
    t = _fresh(corpus, tmp_path, n_epochs=3, decay_epoch=1, val_every=2,
               checkpoint_every_iters=4, **kw)
    saves, vals = [], [(25.0, 0.8), (24.0, 0.7)]

    def step(batch, lr, lr_d):
        if fail_at is not None and t.steps_done + 1 == fail_at:
            raise RuntimeError("stalled device")
        return {"loss": torch.tensor(0.0)}

    t._step = step
    t.validate = lambda: vals.pop(0)
    t._save = lambda epoch, psnr=None, ssim_v=None: saves.append(
        (epoch, psnr, ssim_v, t.steps_done))
    t._collapse_guard = lambda *a: False
    return t, saves


def test_loop_saves_each_epoch_stamps_validations_and_mid_epoch(corpus,
                                                                tmp_path):
    t, saves = _loop_trainer(corpus, tmp_path)  # 6 steps an epoch, 4 epochs
    t.train()
    assert saves == [(1, None, None, 4), (1, None, None, 6),
                     (2, None, None, 10), (2, 25.0, 0.8, 12),
                     (3, None, None, 16), (3, None, None, 18),
                     (4, None, None, 22), (4, 24.0, 0.7, 24)]


def test_loop_emergency_checkpoint_and_max_steps(corpus, tmp_path):
    t, saves = _loop_trainer(corpus, tmp_path, fail_at=8)
    with pytest.raises(RuntimeError, match="stalled"):
        t.train()
    # epoch 1's mid-epoch save and its end, then the emergency save when
    # step 8 raises
    assert saves == [(1, None, None, 4), (1, None, None, 6),
                     (2, None, None, 7)]
    cut, saves = _loop_trainer(corpus, tmp_path)
    cut.train(max_steps=11)  # epoch 2 cut short: no epoch-end save for it
    assert cut.steps_done == 11
    assert saves == [(1, None, None, 4), (1, None, None, 6),
                     (2, None, None, 10)]


# -- the entry point -------------------------------------------------------

def _yaml(corpus, tmp_path):
    with open(os.path.join(REPO, "configs", "HdGan.yaml")) as f:
        text = f.read()
    path = tmp_path / "HdGan_test.yaml"
    path.write_text(
        text + "".join(f"\n{k}_list: '{corpus[k]}'"
                       for k in ("train", "val", "test"))
        + f"\nsize: {SIZE}\nn_cpu: 2\nsave_root: '{tmp_path}/model/'\n"
        f"image_save: '{tmp_path}/img/'\n")
    return str(path)


def test_test_entry_point_runs_on_cpu(corpus, tmp_path, jax_run):
    """``--mode test --device cpu`` in a fresh interpreter without jax,
    flax or yaml, on JAX's weights: JAX's aggregates, the SE2 series."""
    pth = tmp_path / "G.pth"
    torch.save(jax_run["g"], pth)
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
        [sys.executable, "-c", code, "--config", _yaml(corpus, tmp_path),
         "--mode", "test", "--device", "cpu", "--generator-ckpt", str(pth)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    printed = dict(ln.split(": ", 1) for ln in res.stdout.splitlines()
                   if ln.split(":")[0] in KEYS)
    assert set(printed) == set(KEYS)
    for key in KEYS:
        _near(key, float(printed[key]), jax_run["test"][key])
    assert "LPIPSw/LPIPS: not computed" in res.stdout
    assert f"test: {N_TEST} slices in" in res.stdout
    se2 = [f for d, _, fs in os.walk(tmp_path / "img") for f in fs
           if f"{os.sep}SE2" in d]
    assert len(se2) == N_TEST


def test_test_mode_needs_a_card_unless_told_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path cannot be reached")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--config", _yaml(corpus, tmp_path), "--mode", "test"])
    assert not (tmp_path / "img").exists()
