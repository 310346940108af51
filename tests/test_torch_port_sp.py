"""The port's sp plan (``parallel/spatial.py``, ``parallel/halo.py``,
``parallel/mesh.py``) on the CPU, in float64, with gloo ranks in child
processes that ``torchrun`` starts (the launch of
``tests/test_torch_port_fsdp.py``), and JAX's own sp path
(``ctagan_tpu/parallel/spatial.py``, ``ctagan_tpu/parallel/halo.py``) on
conftest's virtual devices in a child process.

- (a) ``plan_from_spec``: ``{sp: 2}`` at world 2 and ``{dp: 2, sp: 2}`` at
  world 4 give JAX's kind, ``batch_scale`` and mesh axes; ``--mode train``
  starts dp × sp ranks; Cyc, Reg, HD and P3d (whose sp step is the depth
  plan's) reach the plan's world check.
- (b) ``halo_conv`` (each kind of conv of G and D) and ``SumOverGroup``
  pass ``gradcheck`` on two ranks, as functions of an input every rank
  holds, and each conv's rows equal the whole image's conv; a strip too
  short for a layer raises on every rank.
- (c) ``infer_spatial_sharded`` on four ranks within 1e-6 of JAX's on a
  4-device mesh (G of 2 blocks at base 16, 128², halos 16 and 32 = the
  strip), and at 32 within 1e-12 of one process's forward of the
  symmetric-extended image, cropped; JAX's validation errors; ``halo=4``
  differs from the extended image's forward.
- (d) One P2p step under ``{sp: 2}`` (``noise_level: 0``): every net and
  Adam's first moments within 1e-6 of JAX's ``make_sp_mesh(n=2)`` +
  ``shard_p2p_state_sp`` + ``sp_train_step_fn``, and within 1e-12 of the
  port's one-process step.
- (e) Two steps with augmentation, the EMA and ``grad_accum: 2`` under
  ``{sp: 2}``, and under ``{dp: 2, sp: 2}`` on four ranks, against one
  process within 1e-12, every weight bit-identical across the ranks.
- (f) A P2p trainer's ``.pt`` written under ``{sp: 2}`` (rank 0) resumes
  bit-equal at world 1.
"""
import copy
import os
import pickle
import shutil
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
from ctagan_tpu.parallel import halo as jax_halo
from ctagan_tpu.parallel import spatial as jax_spatial
from ctagan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ctagan_tpu.parallel.mesh import plan_from_spec as jax_plan_from_spec
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.__main__ import dp_ranks
from ctagan_tpu_torch.models import Discriminator, Generator
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
)
from ctagan_tpu_torch.parallel import halo, spatial
from ctagan_tpu_torch.parallel.mesh import plan_from_spec
from ctagan_tpu_torch.train import trainers
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_dp import (
    CHILD_ENV,
    JAX_TOL,
    MOMENT_FLOOR,
    PORT_TOL,
    _rel,
)
from tests.test_torch_port_fsdp import _held, _same, _torchrun
from tests.test_torch_port_p2p import (
    CFG,
    LR,
    _p2p_cfg,
    f64,
    jax_small_g,
    jax_tree,
    pair_batch,
    small_g,
)

torch.set_num_threads(2)

SP2, HYBRID = (1, 2), (2, 2)
SIZE = 64  # the steps' images: strips of 32 rows on two ranks
FWD_G = dict(n_residual_blocks=2, base_features=16)
FWD_SIZE, FWD_HALOS, FWD_NEG = 128, (16, 32), 4
# the halo from which the forward equals the extended image's everywhere
# (JAX's tests hold it at the strip, 32 here); 16 is below the receptive
# field, and is held to JAX's sharded forward alone
FWD_FIELD = 32
FWD_TOL = 1e-6  # the tp file's forward tolerance
CONVERT = {"g": generator_state_dict, "d": discriminator_state_dict}
# the gradcheck's kinds of conv (``halo_conv``'s arguments), on 16 rows
CONV_KINDS = {
    "7x7 reflect": dict(k=7, reflect=3), "3x3 reflect": dict(k=3, reflect=1),
    "3x3 s2 zero": dict(k=3, stride=2, padding=1),
    "transposed": dict(k=3, transposed=True),
    "4x4 s2 p1": dict(k=4, stride=2, padding=1),
    "4x4 s1 p1": dict(k=4, stride=1, padding=1),
    "4x4 s1 p1 twice": dict(k=4, stride=1, padding=1, twice=True),
}

# one rank's work: the cases under their plan, the gradchecks, the sharded
# forwards, the checkpoint drill; run by the children and, without a group
# and without a plan, by the one-process child
_RANK = r'''
import copy
import hashlib
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ctagan_tpu_torch.parallel import dist, halo, spatial, tensor
from ctagan_tpu_torch.parallel.mesh import shard_rows
from ctagan_tpu_torch.train import steps


def run_case(case, plan=None):
    """The case's steps on this rank's rows of its global batch (every row
    without a group), on copies of its nets; with ``plan`` = (dp, sp) the
    state under the sp plan. Returns the weights (nets, then EMAs), Adam's
    first moments by name and each step's losses."""
    nets = copy.deepcopy(case["nets"])
    state = getattr(steps, case["init"])(*nets, **case["init_kw"])
    dp, sp = plan if plan is not None else (dist.world(), 1)
    if plan is not None:
        spatial.shard_state_sp(state, spatial.make_sp_mesh(dp, sp))
    n = len(next(iter(case["batch"].values())))
    rows = shard_rows(n, dist.rank() // sp, dp)
    batch = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    losses = [{k: float(v) for k, v in steps.p2p_train_step(
        state, case["cfg"], batch, case["lr"]).items()}
        for _ in range(case["steps"])]
    emas = [state.g_ema] if state.g_ema is not None else []
    mu = {p: opt.state[p]["exp_avg"] for opt in (state.g_opt, state.d_opt)
          for p in opt.state}
    return {"weights": [{k: v.detach().clone()
                         for k, v in m.state_dict().items()}
                        for m in nets + emas],
            "moments": [{k: mu[p].clone() for k, p in m.named_parameters()}
                        for m in nets],
            "losses": losses}


def _conv_ref(x, w, b, kind):
    """The whole image's conv of ``kind`` (NHWC)."""
    y = x.permute(0, 3, 1, 2)
    if kind.get("transposed"):
        y = F.conv_transpose2d(y, w, b, stride=2, padding=1,
                               output_padding=1)
    elif kind.get("reflect"):
        r = kind["reflect"]
        y = F.conv2d(F.pad(y, (r, r, r, r), mode="reflect"), w, b)
    else:
        for _ in range(2 if kind.get("twice") else 1):
            y = F.conv2d(y, w, b, stride=kind["stride"],
                         padding=kind["padding"])
    return y.permute(0, 2, 3, 1)


def gradchecks(kinds):
    """Each kind of ``halo_conv`` and ``SumOverGroup`` as a function of an
    input every rank holds (``copy_to_tp`` in, the ranks' rows placed in
    the whole output and summed by ``reduce_from_tp``): gradcheck, and the
    rows against the whole image's conv. Returns {kind: (ok, err)}."""
    mesh = spatial.make_sp_mesh(1, dist.world())
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(1, 8 * mesh.n, 4, 2, dtype=torch.float64, generator=gen)
    out = {}
    for name, kind in kinds.items():
        k = kind["k"]
        shape = (2, 3, k, k) if kind.get("transposed") else (
            3 if not kind.get("twice") else 2, 2, k, k)
        w = torch.rand(shape, dtype=torch.float64, generator=gen) - 0.5
        b = torch.rand(shape[1] if kind.get("transposed") else shape[0],
                       dtype=torch.float64, generator=gen)
        ref = _conv_ref(x, w, b, kind)
        args = {a: kind[a] for a in ("stride", "padding", "reflect",
                                     "transposed") if a in kind}

        def rows(xf):
            h = spatial.strip(tensor.copy_to_tp(xf, mesh.group), mesh)
            for _ in range(2 if kind.get("twice") else 1):
                h = spatial.halo_conv(h, w, b, mesh, **args)
            return h

        # this rank's output rows: the anchors in its strip, up to the
        # image's last row (all_gather of the counts keeps it collective)
        mine = rows(x).shape[1]
        t = torch.zeros(mesh.n, dtype=torch.float64)
        t[mesh.index] = mine
        dist.all_reduce_sum_(t, mesh.group)
        counts = [int(c) for c in t.tolist()]
        lo = sum(counts[:mesh.index])

        def whole(xf):
            h = rows(xf).permute(0, 3, 1, 2)
            h = F.pad(h, (0, 0, lo, ref.shape[1] - lo - mine))
            return tensor.reduce_from_tp(h.permute(0, 2, 3, 1), mesh.group)

        ok = torch.autograd.gradcheck(whole, (x.clone().requires_grad_(),))
        err = float((rows(x) - ref[:, lo:lo + mine]).abs().max())
        out[name] = (ok, err, counts)
    # SumOverGroup: s = Σ_r x·w_r read by every rank's part s·u_r
    ws = [torch.rand(3, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(9 + r))
          for r in range(mesh.n)]
    us = [torch.rand(3, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(19 + r))
          for r in range(mesh.n)]
    r = mesh.index

    def summed(v):
        s = dist.sum_over_group(tensor.copy_to_tp(v, mesh.group) * ws[r],
                                mesh.group)
        return tensor.reduce_from_tp(torch.tanh(s) * us[r], mesh.group)

    v = torch.rand(3, dtype=torch.float64, generator=gen)
    want = torch.tanh(sum(v * w for w in ws)) * sum(us)
    out["SumOverGroup"] = (
        torch.autograd.gradcheck(summed, (v.clone().requires_grad_(),)),
        float((summed(v) - want).abs().max()), None)
    return out


def row_check():
    """Three 4×4 stride-1 convs over 3 rows a rank: each takes a row from
    the last rank's strip, so after two of them the last rank holds one
    row, fewer than the two the third needs from it; every rank must
    raise, not only the last. Returns the message or None."""
    mesh = spatial.make_sp_mesh(1, dist.world())
    gen = torch.Generator().manual_seed(1)
    h = spatial.strip(torch.rand(1, 3 * mesh.n, 4, 2, dtype=torch.float64,
                                 generator=gen), mesh)
    w = torch.rand(2, 2, 4, 4, dtype=torch.float64, generator=gen)
    try:
        for _ in range(3):
            h = spatial.halo_conv(h, w, None, mesh, stride=1, padding=1)
    except ValueError as e:
        return str(e)
    return None


def forwards(spec):
    """``infer_spatial_sharded`` of ``spec["g"]`` on ``spec["x"]`` over
    every rank, for each halo."""
    mesh = spatial.make_sp_mesh(1, dist.world())
    return {h: halo.infer_spatial_sharded(spec["g"], spec["x"], mesh, halo=h)
            for h in spec["halos"]}


def digest(obj):
    """``obj`` (a checkpoint state) with each tensor replaced by its dtype,
    shape and the SHA-256 of its bytes: equal digests, equal bits."""
    if isinstance(obj, dict):
        return {k: digest(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [digest(v) for v in obj]
    if torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous().reshape(-1)
        return (str(t.dtype), tuple(obj.shape), hashlib.sha256(
            t.view(torch.uint8).numpy().tobytes()).hexdigest())
    return obj


def run_ckpt(spec):
    """(f): a P2p trainer under ``{sp: 2}``: a step of the batch, a save
    (rank 0 writes), its state as its :func:`digest`."""
    from ctagan_tpu_torch.train.trainers import P2pTrainer
    from ctagan_tpu_torch.utils.config import load_config

    t = P2pTrainer(load_config(dict(spec["cfg"], mesh={"sp": 2})),
                   torch.device("cpu"), quiet=True)
    t._step({k: torch.from_numpy(v) for k, v in spec["batch"].items()},
            t.lr, t.lr_d)
    return {"kind": t.plan.kind, "sp": t.state.sp.n, "path": t._save(1),
            "state": digest(t._checkpoint_state())}


if __name__ == "__main__":
    torch.set_num_threads(1)
    todo = torch.load(sys.argv[1], weights_only=False)
    dist.init(torch.device("cpu"))
    try:
        out = {name: run_case(case, todo["plan"])
               for name, case in todo["cases"].items()}
        if "forward" in todo:
            out["forward"] = forwards(todo["forward"])
        if "gradcheck" in todo:
            out["gradcheck"] = gradchecks(todo["gradcheck"])
            out["row_check"] = row_check()
        if "ckpt" in todo:
            out["ckpt"] = run_ckpt(todo["ckpt"])
        torch.save(out, f"{sys.argv[2]}.{dist.rank()}")
    finally:
        dist.shutdown()
'''
_ns = {"__name__": "sp_rank"}
exec(compile(_RANK, "sp_rank", "exec"), _ns)
digest = _ns["digest"]


# -- (a) the plan ---------------------------------------------------------------

@pytest.mark.parametrize("spec,world", [({"sp": 2}, 2), ({"sp": 4}, 4),
                                        ({"dp": 2, "sp": 2}, 4)], ids=str)
def test_sp_plan_is_jaxs(spec, world):
    want = jax_plan_from_spec(spec, jax.devices()[:world])
    got = plan_from_spec(spec, world)
    axes = dict(zip(want.mesh.axis_names, want.mesh.devices.shape))
    assert (got.kind, got.batch_scale) == (want.kind, want.batch_scale)
    assert got.describe().startswith(
        f"mesh plan: {axes} (kind=sp, batch x{want.batch_scale}); ")
    assert (got.dp, got.sp) == (spec.get("dp", 1), spec["sp"])
    assert [got.batch_rank(r) for r in range(world)] == [
        r // spec["sp"] for r in range(world)]
    with pytest.raises(ValueError, match=f"process group has {world + 1}"):
        plan_from_spec(spec, world + 1)
    with pytest.raises(ValueError, match=f"needs {world} devices, have 1"):
        plan_from_spec(spec, 1)


def test_train_starts_dp_times_sp_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    for mesh, n in (({"sp": 2}, 2), ({"sp": 4}, 4), ({"dp": 2, "sp": 2}, 4)):
        assert dp_ranks(load_config({"mesh": mesh}), cuda, None) == n
    with pytest.raises(SystemExit, match="needs 8 devices, have 4"):
        dp_ranks(load_config({"mesh": {"dp": 2, "sp": 4}}), cuda, None)


@pytest.mark.parametrize("cls", ["CycTrainer", "RegTrainer",
                                 "HdTrainerStage1", "HdTrainerStage2",
                                 "P3dTrainer"])
def test_families_under_sp_reach_the_plan(cls, tmp_path):
    """Cyc, Reg, HD and P3d build under the sp plan (P3d on the depth
    plan's step: the sp placement splits a volume's depth), which at world
    1 refuses as JAX's does."""
    cfg = load_config(_p2p_cfg(tmp_path, "unused.txt", mesh={"sp": 2}))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        getattr(trainers, cls)(cfg, torch.device("cpu"), quiet=True)


# -- (c) validation ------------------------------------------------------------

@pytest.mark.parametrize("size,n,h", [(256, 4, 30), (256, 4, 128),
                                      (200, 4, 32)], ids=str)
def test_halo_validation_is_jaxs(size, n, h):
    g = Generator(1, 1, fused_body=False, **FWD_G)
    img = np.zeros((size, size), np.float32)
    with pytest.raises(ValueError) as want:
        jax_halo.infer_spatial_sharded(
            JaxGenerator(1, 1, **FWD_G), None, img,
            mesh=jax_make_mesh(n=n), halo=h)
    with pytest.raises(ValueError) as got:
        halo.infer_spatial_sharded(g, img, spatial.SpMesh(n, 0, None),
                                   halo=h)
    assert str(got.value) == str(want.value)


# -- the runs -----------------------------------------------------------------------

def _p2p_case(aug):
    """P2p at SIZE²: without augmentation one step of a batch of 2; with
    it (the EMA, ``grad_accum: 2``) two steps."""
    cfg = dict(CFG, grad_accum=1)
    if aug:
        cfg.update(noise_level=1, grad_accum=2)
    return dict(nets=[small_g(0).double(),
                      Discriminator(2).reset_parameters(1).double()],
                init="init_p2p_state", init_kw={"ema": aug}, cfg=cfg,
                batch=pair_batch(2, SIZE), lr=LR, steps=2 if aug else 1)


def _hybrid_case():
    """The augmented case on a global batch of 4: two rows a dp column of
    ``{dp: 2, sp: 2}``."""
    return dict(_p2p_case(True), batch=pair_batch(4, SIZE))


def _fwd_g():
    return Generator(1, 1, fused_body=False, **FWD_G).reset_parameters(
        3).double()


def _fwd_x():
    """An image that f32 holds exactly (JAX's sharded forward casts it)."""
    return np.random.default_rng(4).uniform(
        -1, 1, (FWD_SIZE, FWD_SIZE)).astype(np.float32).astype(np.float64)


def _jax_step(case):
    """JAX's sp P2p step of ``case`` on a ``{sp: 2}`` mesh of conftest's
    virtual devices, in float64, from the case's weights: (new state,
    losses)."""
    mesh = jax_spatial.make_sp_mesh(n=2)
    jax.config.update("jax_enable_x64", True)
    try:
        g, d = (f64(jax_tree(m)) for m in case["nets"])
        tx = jax_steps.make_optimizer()
        state = jax_spatial.shard_p2p_state_sp(jax_steps.P2pState(
            g, d, tx.init(g), tx.init(d), jax.random.PRNGKey(0)), mesh)
        step = jax_spatial.sp_train_step_fn(jax_small_g(),
                                            JaxDiscriminator(2), tx,
                                            case["cfg"])
        batch = jax_spatial.shard_batch_sp(case["batch"], mesh)
        return jax.device_get(step(state, batch, jnp.float64(LR)))
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_forwards():
    """JAX's ``infer_spatial_sharded`` of the forward G on a 4-device mesh
    for each halo (and the negative control's), float64 weights."""
    g = _fwd_g()
    jax.config.update("jax_enable_x64", True)
    try:
        params = f64(jax_tree(g))
        jg = JaxGenerator(1, 1, **FWD_G)
        return {h: np.asarray(jax_halo.infer_spatial_sharded(
            jg, params, _fwd_x(), mesh=jax_make_mesh(n=4), halo=h))
            for h in FWD_HALOS + (FWD_NEG,)}
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_child(out):
    """A child's JAX work: the sp step and the forwards, pickled to
    ``out``."""
    res = {"forward": _jax_forwards(), "p2p": _jax_step(_p2p_case(False))}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _launch(tmp, name, n, todo):
    """The rank script over ``n`` gloo ranks (``n`` None: one process
    without a group) on ``todo``; each rank's results in
    ``tmp``/<name>.<rank>."""
    torch.save(todo, tmp / f"{name}.pt")
    return subprocess.Popen(
        ([sys.executable] if n is None else _torchrun(n))
        + [str(tmp / "rank.py"), str(tmp / f"{name}.pt"), str(tmp / name)],
        env=dict(os.environ, **CHILD_ENV))


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Two ranks under ``{sp: 2}`` (P2p with and without augmentation, the
    gradchecks, the checkpoint drill), four under ``{dp: 2, sp: 2}`` (the
    hybrid case, the sharded forwards), one process on each case's global
    batch and a JAX child (the sp step, the forwards), all started at
    once; the world-1 resume here after them."""
    tmp = tmp_path_factory.mktemp("sp")
    (tmp / "rank.py").write_text(_RANK)
    cases = {"p2p": _p2p_case(False), "p2p_aug": _p2p_case(True)}
    ckpt_root = tmp / "ckpt"
    ckpt_cfg = _p2p_cfg(ckpt_root, "unused.txt", size=SIZE)
    ckpt_batch = {k: v.astype(np.float32)
                  for k, v in pair_batch(2, SIZE).items()}
    procs = [
        _launch(tmp, "w2", 2, {
            "plan": SP2, "cases": cases, "gradcheck": CONV_KINDS,
            "ckpt": {"cfg": ckpt_cfg, "batch": ckpt_batch}}),
        _launch(tmp, "w4", 4, {
            "plan": HYBRID, "cases": {"p2p": _hybrid_case()},
            "forward": {"g": _fwd_g(), "x": _fwd_x(),
                        "halos": FWD_HALOS + (FWD_NEG,)}}),
        _launch(tmp, "one", None, {"plan": None, "cases": dict(
            cases, hybrid=_hybrid_case())}),
        subprocess.Popen(
            [sys.executable, "-c", "from tests.test_torch_port_sp import "
             f"_jax_child; _jax_child({str(tmp / 'jax')!r})"],
            env=dict(os.environ, **CHILD_ENV,
                     XLA_FLAGS="--xla_force_host_platform_device_count=8"))]
    try:
        for p in procs:
            assert p.wait(timeout=900) == 0
    finally:
        for p in procs:
            p.kill()
    with open(tmp / "jax", "rb") as f:
        jax_res = pickle.load(f)
    w2, w4 = ([torch.load(f"{tmp / w}.{r}", weights_only=False)
               for r in range(n)] for w, n in (("w2", 2), ("w4", 4)))
    one = torch.load(f"{tmp / 'one'}.0", weights_only=False)
    back = trainers.P2pTrainer(load_config(dict(ckpt_cfg, resume=True)),
                               torch.device("cpu"), quiet=True)
    g = _fwd_g()
    with torch.no_grad():
        ext = {h: g(torch.from_numpy(np.pad(_fwd_x(), ((h, h), (0, 0)),
                                            mode="symmetric"))[None, :, :,
                                                               None]
                    )[0, h:-h, :, 0].numpy()
               for h in FWD_HALOS + (FWD_NEG,)}
    yield {"w2": w2, "w4": w4, "one": one, "jax": jax_res, "ext": ext,
           "world1": (back.start_epoch, digest(back._checkpoint_state()))}
    shutil.rmtree(tmp, ignore_errors=True)


# -- (b) the Functions ----------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CONV_KINDS) + ["SumOverGroup"])
def test_halo_conv_and_sum_pass_gradcheck_on_two_ranks(sp_runs, kind):
    for rank in sp_runs["w2"]:
        ok, err, counts = rank["gradcheck"][kind]
        assert ok and err <= 1e-14, (kind, err)
    if kind.startswith("4x4 s1"):  # the last rank owns fewer rows
        n_out = 15 if kind == "4x4 s1 p1" else 14
        assert counts == [8, n_out - 8]


def test_short_strip_raises_on_every_rank(sp_runs):
    for rank in sp_runs["w2"]:
        assert rank["row_check"] is not None
        assert rank["row_check"].startswith(
            "sp: a strip of 1 rows is shorter than the rows a layer needs "
            "from a neighbour")


# -- (c) the sharded forward --------------------------------------------------------

@pytest.mark.parametrize("h", FWD_HALOS)
def test_sharded_forward_matches_jax_and_the_extended_image(sp_runs, h):
    want = sp_runs["jax"]["forward"][h]
    for rank in sp_runs["w4"]:
        got = rank["forward"][h]
        assert got.shape == want.shape == (FWD_SIZE, FWD_SIZE)
        assert np.abs(got - want).max() <= FWD_TOL
        if h >= FWD_FIELD:  # the halo covers the receptive field
            assert np.abs(got - sp_runs["ext"][h]).max() <= PORT_TOL
        assert np.array_equal(got, sp_runs["w4"][0]["forward"][h])


def test_too_small_halo_differs_from_the_extended_image(sp_runs):
    for rank in sp_runs["w4"]:
        got = rank["forward"][FWD_NEG]
        assert np.abs(got - sp_runs["ext"][FWD_NEG]).max() > 1e-3
        assert np.abs(got - sp_runs["jax"]["forward"][FWD_NEG]).max() \
            <= FWD_TOL


# -- (d), (e) the steps ---------------------------------------------------------------

@pytest.mark.parametrize("net", ["g", "d"])
def test_sp_step_matches_jax_sp_step(sp_runs, net):
    new, want_losses = sp_runs["jax"]["p2p"]
    params, opt, i = {"g": ("g_params", "g_opt", 0),
                      "d": ("d_params", "d_opt", 1)}[net]
    for rank in sp_runs["w2"]:
        got = rank["p2p"]
        for k, v in want_losses.items():
            np.testing.assert_allclose(got["losses"][0][k], float(v),
                                       rtol=1e-9, atol=1e-15, err_msg=k)
        for tree, have in ((getattr(new, params), got["weights"][i]),
                           (getattr(new, opt).mu, got["moments"][i])):
            want = {k: v.numpy() for k, v in CONVERT[net](tree).items()}
            floor = MOMENT_FLOOR * max(np.linalg.norm(w)
                                       for w in want.values())
            for k, w in want.items():
                assert _rel(have[k].numpy(), w, floor) <= JAX_TOL, (k, net)


@pytest.mark.parametrize("case", ["p2p", "p2p_aug", "hybrid"])
def test_sp_step_matches_one_process(sp_runs, case):
    ranks, name = ((sp_runs["w4"], "p2p") if case == "hybrid"
                   else (sp_runs["w2"], case))
    for rank in ranks:
        _held(rank[name], sp_runs["one"][case], PORT_TOL)
    # the replicated weights, moments and losses bit-identical on the ranks
    for rank in ranks[1:]:
        for key in ("weights", "moments"):
            for wa, wb in zip(rank[name][key], ranks[0][name][key]):
                assert all(torch.equal(wa[k], wb[k]) for k in wa)
        assert rank[name]["losses"] == ranks[0][name]["losses"]


# -- (f) checkpoints ----------------------------------------------------------------

def test_pt_written_under_sp_resumes_at_world_1(sp_runs):
    ranks = [r["ckpt"] for r in sp_runs["w2"]]
    assert [(r["kind"], r["sp"]) for r in ranks] == [("sp", 2)] * 2
    assert ranks[0]["path"] and ranks[1]["path"] is None  # rank 0 wrote it
    assert ranks[0]["path"].endswith(".pt") and "_e1" in ranks[0]["path"]
    _same(ranks[1]["state"], ranks[0]["state"])
    start_epoch, state = sp_runs["world1"]
    assert start_epoch == 1
    _same(state, ranks[0]["state"])
