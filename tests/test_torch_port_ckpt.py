"""Parity: the port's reader of the JAX package's flax msgpack checkpoints,
and every path that takes one.

- The pure-Python decoder (``utils/msgpack.py``) against
  ``flax.serialization.msgpack_restore`` on files JAX's ``save_checkpoint``
  wrote: every leaf equal in dtype, shape and bytes, and the scalar fields,
  for HD stage 1, HD stage 2 (the multi-scale D), P2p with its EMA and
  CycleGAN with both replay pools; a tree with bf16 leaves, chunked arrays
  (flax's ``MAX_CHUNK_SIZE`` lowered in this process), numpy scalars,
  complex numbers and ints of every width; a full-width P2p checkpoint of
  JAX's trainer decoded in a fresh interpreter where ``msgpack``, ``flax``
  and ``jax`` cannot be imported, with its CPU seconds printed.
- (``test_torch_port_ckpt_resume.py``: a float64 step resumed from a JAX
  checkpoint against JAX's.)
- The trainer: ``resume`` from a JAX ``.ckpt`` (a torn newer file
  quarantined; an orbax directory raises), ``find_checkpoints`` over both
  suffixes, the stage-2 bootstrap from a JAX stage-1 file,
  ``load_generator``.
- ``--mode serve``'s generator (``__main__.serving_generator``, what the
  entry point serves) from a JAX ``.ckpt``, a port ``.pt`` and a reference
  ``.pth``, against what JAX's ``train.py`` serve branch serves
  (``load_generator`` then ``_g_params()``, the EMA): before the repair the
  entry point served seeded weights with a checkpoint in ``save_root`` and
  could not load a port ``.pt``.
- ``--mode train_test --device cpu`` in a fresh interpreter.
"""
import os
import subprocess
import sys

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import torch_import
from ctagan_tpu.train import P2pTrainer as JaxP2pTrainer
from ctagan_tpu.train import replay_buffer as jax_rb
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu.utils import checkpoint as jax_ckpt
from ctagan_tpu.utils.config import load_config as jax_load_config
from ctagan_tpu_torch.__main__ import serving_generator
from ctagan_tpu_torch.data.fixtures import make_corpus
from ctagan_tpu_torch.models import Discriminator, Generator, RegNet
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
)
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.train.trainers import (
    HdTrainerStage2,
    P2pTrainer,
    generator_weights,
)
from ctagan_tpu_torch.utils import checkpoint
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_p2p import jax_tree, small_g

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64  # P2p and CycleGAN; the RegNet families at 128
REG_SIZE = 128


def _payload(state, epoch=3, lr=1e-4, lr_d=2e-4):
    return {"state": jax.device_get(state), "epoch": epoch, "lr": lr,
            "lr_d": lr_d}


def _assert_same_tree(got, want, path="payload"):
    """Every leaf of the port's decode equal to flax's restore."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert got.view(torch.int16).numpy().tobytes() == want.tobytes(), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# -- JAX family states of small nets -----------------------------------------

def _ms_tree(d):
    """A port MultiScaleDiscriminator's weights as JAX's tree."""
    sd = {k: v.detach().numpy() for k, v in d.state_dict().items()}
    scales = sorted({k.split(".")[0] for k in sd})
    return {"params": {sc: torch_import.import_nlayer_discriminator(
        {k[len(sc) + 1:]: v for k, v in sd.items() if k.startswith(sc + ".")}
    )["params"] for sc in scales}}


def _jax_state(family):
    """A JAX family state of small seeded nets (the port's, converted), its
    Adam states from optax's init, CycleGAN's pools partly filled."""
    from ctagan_tpu_torch.models import MultiScaleDiscriminator

    tx = jax_steps.make_optimizer()
    key = jax.random.PRNGKey(0)
    g = jax_tree(small_g(0))
    if family in ("hd1", "hd2"):
        r = jax_tree(RegNet().reset_parameters(1))
        d = (jax_tree(Discriminator().reset_parameters(2)) if family == "hd1"
             else _ms_tree(MultiScaleDiscriminator(1, num_d=2)
                           .reset_parameters(2)))
        return jax_steps.RegState(g, r, d, tx.init(g), tx.init(r),
                                  tx.init(d), key)
    if family == "p2p_ema":
        d = jax_tree(Discriminator(2).reset_parameters(1))
        return jax_steps.P2pState(g, d, tx.init(g), tx.init(d), key, g)
    gb = jax_tree(small_g(1))
    da, db = (jax_tree(Discriminator().reset_parameters(k)) for k in (2, 3))
    rng = np.random.default_rng(3)
    pools = []
    for n in (7, 50):
        data = np.zeros((50, SIZE, SIZE, 1), np.float32)
        data[:n] = rng.uniform(-1, 1, data[:n].shape)
        pools.append(jax_rb.ReplayBuffer(jnp.asarray(data),
                                         jnp.asarray(n, jnp.int32)))
    return jax_steps.CycState(g, gb, da, db, tx.init((g, gb)), tx.init(da),
                              tx.init(db), *pools, key, g, gb)


@pytest.mark.parametrize("family", ["hd1", "hd2", "p2p_ema", "cyc_pools"])
def test_reader_matches_flax_on_jax_checkpoints(tmp_path, family):
    state = _jax_state(family)
    path = jax_ckpt.save_checkpoint(str(tmp_path), f"X_{family}", 3,
                                    _payload(state), 31.5, 0.875)
    with open(path, "rb") as f:
        want = flax_ser.msgpack_restore(f.read())
    got = checkpoint.load_jax_checkpoint(path)
    _assert_same_tree(got, want)
    assert (got["epoch"], got["lr"], got["lr_d"]) == (3, 1e-4, 2e-4)
    if family == "cyc_pools":
        assert [int(got["state"][k]["size"]) for k in
                ("fake_a_buffer", "fake_b_buffer")] == [7, 50]
        assert set(got["state"]["g_opt"]["mu"]) == {"0", "1"}


def test_reader_bf16_chunks_scalars_and_every_int_width(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {
        "bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
        "bf16_big": jnp.asarray(rng.standard_normal((700,)), jnp.bfloat16),
        "f32_big": rng.standard_normal((1000,)).astype(np.float32),
        "f64": rng.standard_normal((2, 2)),
        "i8": np.array([-128, 127], np.int8),
        "u64": np.array([2 ** 64 - 1], np.uint64),
        "empty": np.zeros((0, 4), np.float32),
        "scalar0d": np.array(5, np.int32),
        "np_scalars": {"f": np.float32(1.5), "i": np.int64(-7),
                       "b": np.bool_(True)},
        "py": {"ints": [0, 127, -32, -33, 255, 65535, 2 ** 32 - 1, 2 ** 40,
                        -2 ** 40, -129, -2 ** 31], "f": 0.1, "t": True,
               "n": None, "s": "é" * 40, "c": 1 - 2j, "b": b"\x00" * 300},
    }
    # chunk every array above 512 bytes, as flax chunks above 1 GiB
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 512)
    data = flax_ser.to_bytes(tree)
    assert data.count(b"__msgpack_chunked_array__") == 2
    want = flax_ser.msgpack_restore(data)
    got = checkpoint_unpackb(data)
    _assert_same_tree(got, want)
    assert got["bf16_big"].shape == (700,)


def checkpoint_unpackb(data):
    from ctagan_tpu_torch.utils.msgpack import unpackb

    return unpackb(data)


# -- the full-width trainer: one JAX P2pTrainer with its EMA, shared ---------

@pytest.fixture(scope="module")
def p2p(tmp_path_factory):
    """JAX's P2pTrainer at 64² (full-width G, ``ema_decay``), its G and EMA
    made to differ, saved as ``P2p_p2p_e2.ckpt``."""
    root = tmp_path_factory.mktemp("ckpt_p2p")
    lists = make_corpus(str(root), n_patients=2, slices_per_patient=2,
                        size=SIZE, seed=4, lists=("train",))
    cfg = dict(name="P2p", size=SIZE, seed=0, n_cpu=1,
               train_list=lists["train"], val_list=lists["train"],
               test_list=lists["train"], save_root=f"{root}/jax_model/",
               image_save=f"{root}/img/", ema_decay=0.999)
    jt = JaxP2pTrainer(jax_load_config(dict(cfg, data_parallel=False)),
                       quiet=True)
    g = Generator(1, 1).reset_parameters(7)
    jt.state = jt.state.replace(g_params=jax.device_put(jax_tree(g)))
    path = jt._save(2)
    return {"jax": jt, "cfg": cfg, "root": str(root), "ckpt": path,
            "g": g.state_dict()}


def _port_cfg(p2p, tag, **kw):
    cfg = dict(p2p["cfg"], save_root=os.path.join(p2p["root"], tag) + "/")
    cfg.update(kw)
    return load_config(cfg)


def _assert_state_dict(model_sd, want_sd):
    assert set(model_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(model_sd[k].cpu(), v.cpu()), k


def test_full_width_checkpoint_decodes_in_a_fresh_interpreter(p2p):
    code = (
        "import sys, time\n"
        "for m in ('msgpack', 'flax', 'jax', 'ctagan_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from ctagan_tpu_torch.utils.checkpoint import load_jax_checkpoint\n"
        "t = time.perf_counter()\n"
        f"p = load_jax_checkpoint({p2p['ckpt']!r})\n"
        "secs = time.perf_counter() - t\n"
        "n = sum(1 for _ in p['state']['g_params']['params'])\n"
        "print(f'decoded {secs:.3f}', p['epoch'], n)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    secs = float(res.stdout.split()[1])
    size_mb = os.path.getsize(p2p["ckpt"]) / 1e6
    print(f"full-width P2p .ckpt, {size_mb:.1f} MB: decoded in {secs:.3f} s "
          "(CPU)")
    assert res.stdout.split()[2:4] == ["2", "15"]  # epoch; G's 15 modules
    assert secs < 30.0


def test_trainer_resumes_from_a_jax_checkpoint(p2p):
    jt = p2p["jax"]
    cfg = _port_cfg(p2p, "resume", resume=True)
    os.makedirs(cfg.save_root)
    dst = os.path.join(cfg.save_root, os.path.basename(p2p["ckpt"]))
    os.symlink(p2p["ckpt"], dst)
    # a newer file torn by a crash: quarantined, the next newest read
    torn = os.path.join(cfg.save_root, "P2p_p2p_e5.ckpt")
    with open(p2p["ckpt"], "rb") as f:
        head = f.read(4096)
    with open(torn, "wb") as f:
        f.write(head)
    t = P2pTrainer(cfg, torch.device("cpu"), quiet=True)
    assert os.path.exists(torn + ".corrupt") and not os.path.exists(torn)
    assert (t.start_epoch, t.lr, t.lr_d) == (2, jt.lr, jt.lr_d)
    st = jax.device_get(jt.state)
    _assert_state_dict(t.g_model.state_dict(),
                       generator_state_dict(st.g_params))
    _assert_state_dict(t.state.g_ema.state_dict(),
                       generator_state_dict(st.g_ema))
    _assert_state_dict(t.d_model.state_dict(),
                       discriminator_state_dict(st.d_params))
    assert not t.state.g_opt.state  # JAX's count is 0: no Adam state yet
    # an orbax directory is not read yet, and is not quarantined
    ocp = os.path.join(cfg.save_root, "P2p_p2p_e9.ocp")
    os.makedirs(ocp)
    with pytest.raises(NotImplementedError, match="orbax"):
        P2pTrainer(cfg, torch.device("cpu"), quiet=True)
    assert os.path.isdir(ocp)


def test_find_checkpoints_lists_both_suffixes_newest_first(tmp_path):
    for name in ("H_hd1_e2.ckpt", "H_hd1_e3.pt", "H_hd1_e3_30.5_0.9.ckpt",
                 "H_hd1_e1.ocp", "G_hd1_e9.pt", "H_hd1_e4.pth"):
        (tmp_path / name).write_bytes(b"x")
    got = checkpoint.find_checkpoints(str(tmp_path), "H_hd1")
    assert [os.path.basename(p) for p, _ in got] == [
        "H_hd1_e3.pt", "H_hd1_e3_30.5_0.9.ckpt", "H_hd1_e2.ckpt",
        "H_hd1_e1.ocp"]
    assert [e for _, e in got] == [3, 3, 2, 1]
    # JAX lists its own
    assert [os.path.basename(p) for p, _ in jax_ckpt.find_checkpoints(
        str(tmp_path), "H_hd1")] == ["H_hd1_e3_30.5_0.9.ckpt",
                                     "H_hd1_e2.ckpt", "H_hd1_e1.ocp"]
    assert checkpoint.find_latest_of_family(str(tmp_path), "hd1")[1] == 9


def test_stage2_bootstraps_from_a_jax_stage1_checkpoint(tmp_path):
    g, r = Generator(1, 1).reset_parameters(11), RegNet().reset_parameters(12)
    d = Discriminator().reset_parameters(13)
    state = {"g_params": jax_tree(g), "r_params": jax_tree(r),
             "d_params": jax_tree(d), "rng": np.zeros(2, np.uint32),
             "g_ema": None}
    jax_ckpt.save_checkpoint(str(tmp_path), "Other_hd1", 4,
                             _payload(state))
    # an older port file of the family loses to the newer JAX one
    torch.save({"state": {}, "epoch": 1}, tmp_path / "HdGan_hd1_e1.pt")
    cfg = load_config(dict(name="HdGan2", size=REG_SIZE, seed=0,
                           save_root=str(tmp_path) + "/"))
    t = HdTrainerStage2(cfg, torch.device("cpu"), quiet=True)
    d0 = {k: v.clone() for k, v in t.d_model.state_dict().items()}
    t.bootstrap_from_stage1()
    _assert_state_dict(t.g_model.state_dict(), g.state_dict())
    _assert_state_dict(t.r_model.state_dict(), r.state_dict())
    _assert_state_dict(t.d_model.state_dict(), d0)  # D stays the seeded one


def test_load_generator_reads_every_format(p2p, tmp_path):
    st = jax.device_get(p2p["jax"].state)
    want = generator_state_dict(st.g_params)
    _assert_state_dict(generator_weights(p2p["ckpt"]), want)
    pth = str(tmp_path / "g.pth")
    torch.save(p2p["g"], pth)
    _assert_state_dict(generator_weights(pth), p2p["g"])
    cyc = {"g_a2b_params": st.g_params, "g_b2a_params": st.g_ema}
    path = jax_ckpt.save_checkpoint(str(tmp_path), "C_cyc", 1,
                                    _payload(cyc))
    _assert_state_dict(generator_weights(path), want)  # CycleGAN's A2B


# -- --mode serve ----------------------------------------------------------------

def _jax_served(jt, ckpt_or_none):
    """What JAX's train.py serve branch serves: generator_ckpt or the newest
    checkpoint through load_generator, then _g_params() (the EMA)."""
    if ckpt_or_none:
        jt.load_generator(ckpt_or_none)
    return generator_state_dict(jax.device_get(jt._g_params()))


@pytest.mark.parametrize("source", ["jax_ckpt", "pth", "port_pt", "none"])
def test_serve_serves_what_jax_serves(p2p, tmp_path, source):
    cfg = _port_cfg(p2p, f"serve_{source}")
    os.makedirs(cfg.save_root)
    if source == "jax_ckpt":  # found in save_root, as JAX's lookup finds it
        os.symlink(p2p["ckpt"], os.path.join(cfg.save_root,
                                             "P2p_p2p_e2.ckpt"))
        want = _jax_served(p2p["jax"], p2p["ckpt"])
    elif source == "pth":  # generator_ckpt, a reference state dict
        cfg.generator_ckpt = str(tmp_path / "g.pth")
        torch.save(p2p["g"], cfg.generator_ckpt)
        want = _jax_served(p2p["jax"], cfg.generator_ckpt)
    elif source == "port_pt":  # the port's own payload in save_root
        t = P2pTrainer(cfg, torch.device("cpu"), quiet=True)
        t.g_model.load_state_dict(p2p["g"])
        t._save(6)
        want = p2p["g"]
    else:  # nothing: seeded weights
        want = P2pTrainer(cfg, torch.device("cpu"),
                          quiet=True).g_model.state_dict()
    g, path = serving_generator(cfg, torch.device("cpu"))
    assert (path is None) == (source == "none")
    assert g.fused_body is True  # the serving route
    _assert_state_dict(g.state_dict(), want)


# -- a resumed float64 step against JAX's ------------------------------------

# -- the entry point -------------------------------------------------------------

def test_train_test_mode_on_the_cpu_in_a_fresh_interpreter(tmp_path):
    lst = make_corpus(str(tmp_path), n_patients=1, slices_per_patient=2,
                      size=SIZE, seed=4, lists=("train",))["train"]
    cfg = os.path.join(tmp_path, "P2p_small.yaml")
    with open(cfg, "w") as f:
        f.write(f"name: P2p\nsize: {SIZE}\nseed: 0\nn_cpu: 1\nn_epochs: 1\n"
                f"decay_epoch: 0\nsave_root: '{tmp_path}/model/'\n"
                f"image_save: '{tmp_path}/img/'\nval_every: 1\n")
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from ctagan_tpu_torch.__main__ import main\n"
            f"sys.exit(main(['--config', {cfg!r}, '--mode', 'train_test', "
            "'--device', 'cpu', '--train-list', "
            f"{lst!r}, '--val-list', {lst!r}, '--test-list', {lst!r}]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "P2p_p2p_e1_" in " ".join(os.listdir(tmp_path / "model"))
    assert "test: 2 slices" in res.stdout and "PSNR:" in res.stdout
    assert len(os.listdir(tmp_path / "img" / "ST1" / "1" / "SE2")) == 2
