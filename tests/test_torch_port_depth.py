"""The port's depth plan (``parallel/volume.py``, ``parallel/mesh.py``) on
the CPU, in float64, with gloo ranks in child processes that ``torchrun``
starts (the launch of ``tests/test_torch_port_sp.py``), and JAX's own depth
path (``ctagan_tpu/parallel/volume.py``) on conftest's virtual devices in a
child process, at JAX's own test sizes (``Generator3D`` of 1 and 2 blocks
at base 8, 16 to 64 slices of 32²).

- (a) ``plan_from_spec``: ``{depth: 8}``, ``{dp: 2, depth: 4}`` give JAX's
  kind and ``batch_scale``, ``{depth: 2, sp: 2}`` JAX's error; ``--mode
  train`` starts dp × depth ranks.
- (b) The depth-halo convs (stride 1, down with depth stride 2,
  transposed up with depth strides 1 and 2), the norm's two sums and D's
  pooled logit pass ``gradcheck`` on two ranks, as functions of an input
  every rank holds; each slab's output equals the whole volume's.
- (c) ``infer_volume_depth_sharded`` on four ranks within 1e-6 of JAX's on
  a 4-device mesh (halo 8, 32 slices), on eight at the default halo (64
  slices), and within 1e-12 of one process's forward of the
  symmetric-extended volume, cropped; JAX's three validation errors; a
  halo of 2 differs from the extended forward (and matches JAX's).
- (d) One P3d step under ``{depth: 2}`` with JAX's flips injected: G, D
  and Adam's first moments within 1e-6 of JAX's ``make_depth_mesh(n=2)``
  + ``shard_p3d_state_depth`` + ``depth_train_step_fn``, and within 1e-12
  of the port's one-process step.
- (e) Two steps with ``grad_accum: 2`` and the EMA under ``{depth: 2}``,
  under ``{dp: 2, depth: 2}`` on four ranks, under P3d's ``{sp: 2}`` and
  with ``depth_downsample: 2`` under ``{depth: 2}``: within 1e-12 of one
  process, every weight bit-identical across the ranks.
- (f) A P3d trainer's ``.pt`` written under ``{depth: 2}`` (rank 0) resumes
  bit-equal at world 1.
- (g) A P2p trainer's step under ``{depth: 2}`` equals the same step under
  ``{sp: 2}`` bit for bit (the 2-D families take the sp step there).
- (h) An indivisible D raises JAX's message under the depth and the sp
  plan, and so does a slab that a depth stride would leave fractional.

JAX's ``instance_norm3d`` takes f32 statistics whatever the input type; the
JAX child swaps it, in that process only, for the same two-pass formula,
sharded branch included, with ``promote_types(x.dtype, f32)`` statistics,
as ``tests/test_torch_port_p3d.py`` does for its float64 checks.
"""
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

from ctagan_tpu.models import volumetric as jax_vol
from ctagan_tpu.parallel import volume as jax_volume
from ctagan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ctagan_tpu.parallel.mesh import plan_from_spec as jax_plan_from_spec
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.__main__ import dp_ranks
from ctagan_tpu_torch.models.convert import (
    discriminator3d_state_dict,
    generator3d_state_dict,
)
from ctagan_tpu_torch.models.volumetric import Generator3D
from ctagan_tpu_torch.parallel import spatial, volume
from ctagan_tpu_torch.parallel.mesh import plan_from_spec
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_dp import (
    CHILD_ENV,
    JAX_TOL,
    MOMENT_FLOOR,
    PORT_TOL,
    _rel,
)
from tests.test_torch_port_fsdp import _held, _same, _torchrun
from tests.test_torch_port_p2p import _p2p_cfg, pair_batch
from tests.test_torch_port_p3d import (
    CFG,
    LR,
    SMALL,
    _key_with,
    f64,
    jax_d,
    jax_g,
)

torch.set_num_threads(2)

SIZE, DEPTH = 32, 16  # the steps' volumes: slabs of 8 on two ranks
FWD_G = dict(n_residual_blocks=1, base_features=8)  # depth field 8
FWD_HALO, FWD_NEG = 8, 2
FWD_SLICES = {4: 32, 8: 64}  # the sharded forwards' series, by ranks
FWD_TOL = 1e-6
FLIPS = (True, False)
CONVERT = {"g": generator3d_state_dict, "d": discriminator3d_state_dict}
# the gradchecks' layers: the context's method, the weight's shape and
# the stride / output padding (NCDHW, a 2-channel input of 8 slices of 2²)
LAYERS = {
    "conv s1": ("conv3d", (3, 2, 3, 3, 3), (1, 1, 1)),
    "down s2": ("conv3d", (3, 2, 3, 3, 3), (2, 2, 2)),
    "transposed s1": ("conv_transpose3d", (2, 3, 3, 3, 3), (1, 2, 2)),
    "transposed s2": ("conv_transpose3d", (2, 3, 3, 3, 3), (2, 2, 2)),
    "norm": ("norm3d", None, None),
    "logit": ("pool_logit3d", None, None),
}

# one rank's work: the cases under their plan, the gradchecks, the sharded
# forwards, the checkpoint drills; run by the children and, without a
# group and without a plan, by the one-process child
_RANK = r'''
import copy
import hashlib
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import sp_scope
from ctagan_tpu_torch.models.volumetric import (
    Discriminator3D,
    Generator3D,
    instance_norm3d,
)
from ctagan_tpu_torch.parallel import dist, spatial, tensor, volume
from ctagan_tpu_torch.parallel.mesh import shard_rows
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.train.trainers import P2pTrainer, P3dTrainer
from ctagan_tpu_torch.utils.config import load_config

SMALL = dict(n_residual_blocks=2, base_features=8)
DS = {1: (1, 1), 2: (1, 2), 4: (2, 2)}


class SmallP3d(P3dTrainer):
    """The P3d trainer on the small nets of the test file."""

    def _generator(self, seed):
        return Generator3D(1, 1, depth_strides=DS[self.config.depth_downsample],
                           **SMALL).reset_parameters(seed)

    def _build_models(self):
        self.d_model = Discriminator3D(2).reset_parameters(self.config.seed
                                                           + 1)


def run_case(case, plan=None):
    """The case's steps on this rank's rows of its global batch (every row
    without a group), on copies of its nets; with ``plan`` = (dp, n) the
    state under the depth plan, or with the case's ``axis`` "spatial"
    under the sp mesh P3d takes. Returns the weights (nets, then EMAs),
    Adam's first moments by name and each step's losses."""
    nets = copy.deepcopy(case["nets"])
    state = steps.init_p3d_state(*nets, seed=0, ema=case["ema"])
    dp, n = plan if plan is not None else (dist.world(), 1)
    if plan is not None:
        make = (spatial.make_sp_mesh if case.get("axis") == "spatial"
                else volume.make_dp_depth_mesh)
        volume.shard_p3d_state_depth(state, make(dp, n))
    rows = shard_rows(len(case["batch"]["A"]), dist.rank() // n, dp)
    batch = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    losses = [{k: float(v) for k, v in steps.p3d_train_step(
        state, case["cfg"], batch, case["lr"], flips=case["flips"]).items()}
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


def _whole_layer(x, method, w, b, stride):
    """The one-process layer of ``method`` on the whole NCDHW volume."""
    if method == "conv3d":
        return F.conv3d(x, w, b, stride=stride, padding=1)
    if method == "conv_transpose3d":
        return F.conv_transpose3d(x, w, b, stride=stride, padding=1,
                                  output_padding=tuple(s - 1 for s in stride))
    if method == "norm3d":
        return instance_norm3d(x)
    return x.mean(dim=(2, 3, 4))


def gradchecks(layers):
    """Each layer of the depth context as a function of an input every
    rank holds (``copy_to_tp`` in, the ranks' slices placed in the whole
    output and summed by ``reduce_from_tp``; the logit, alike on every
    rank, weighed by a rank's own factor): gradcheck, and this rank's
    slices against the whole volume's layer. Returns {layer: (ok, err)}."""
    mesh = volume.make_depth_mesh()
    ctx = volume._DepthTraining(mesh)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(1, 2, 4 * mesh.n, 2, 2, dtype=torch.float64,
                   generator=gen)
    out = {}
    for name, (method, shape, stride) in layers.items():
        w = b = None
        if shape is not None:
            w = torch.rand(shape, dtype=torch.float64, generator=gen) - 0.5
            b = torch.rand(shape[1] if method == "conv_transpose3d"
                           else shape[0], dtype=torch.float64, generator=gen)
        ref = _whole_layer(x, method, w, b, stride)
        u = 1.0 + mesh.index  # the logit's factor on this rank

        def part(xf):
            slab = spatial.strip(tensor.copy_to_tp(xf, mesh.group), mesh, 2)
            if method == "norm3d":
                return ctx.norm3d(slab, 1e-5)
            if method == "pool_logit3d":
                return ctx.pool_logit3d(slab)
            pad = (1, 1, 1) if method == "conv3d" else tuple(
                s - 1 for s in stride)
            return getattr(ctx, method)(slab, w, b, stride, pad)

        mine = part(x).shape[2] if method != "pool_logit3d" else 0
        lo = mesh.index * mine

        def whole(xf):
            y = part(xf)
            if method == "pool_logit3d":
                return tensor.reduce_from_tp(y * u, mesh.group)
            y = F.pad(y, (0, 0, 0, 0, lo, ref.shape[2] - lo - mine))
            return tensor.reduce_from_tp(y, mesh.group)

        ok = torch.autograd.gradcheck(whole, (x.clone().requires_grad_(),))
        if method == "pool_logit3d":
            err = float((part(x) - ref).abs().max())
        else:
            err = float((part(x) - ref[:, :, lo:lo + mine]).abs().max())
        out[name] = (ok, err)
    return out


def forwards(spec):
    """``infer_volume_depth_sharded`` of ``spec["g"]`` on ``spec["x"]``
    over every rank, for each halo (None: the default)."""
    mesh = volume.make_depth_mesh()
    return {h: volume.infer_volume_depth_sharded(spec["g"], spec["x"], mesh,
                                                 halo=h)
            for h in spec["halos"]}


def fractional(spec):
    """G with depth strides (2, 2) (``depth_downsample: 4``) on this rank's
    slab of a volume of ``spec["depth"]`` slices under the depth plan: a
    slab of one slice meets the second stride 2 on every rank. Returns
    the message or None."""
    state = steps.init_p3d_state(copy.deepcopy(spec["g"]),
                                 copy.deepcopy(spec["d"]))
    volume.shard_p3d_state_depth(state, volume.make_depth_mesh())
    try:
        steps.p3d_train_step(state, {"P2P_lamda": 1.0, "Adv_lamda": 1.0},
                             {k: torch.from_numpy(v)
                              for k, v in spec["batch"].items()}, 1e-4,
                             flips=(False, False))
    except ValueError as e:
        return str(e)
    return None


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
    """(f): the P3d trainer under ``{depth: 2}``: a step of the batch, a
    save (rank 0 writes), its state as its :func:`digest`; (g): a P2p
    trainer's step under ``{depth: 2}`` and under ``{sp: 2}``, each
    state's digest."""
    t = SmallP3d(load_config(dict(spec["cfg"], mesh={"depth": 2})),
                 torch.device("cpu"), quiet=True)
    t._step({k: torch.from_numpy(v) for k, v in spec["batch"].items()},
            t.lr, t.lr_d)
    out = {"kind": t.plan.kind, "depth": t.state.depth.n,
           "path": t._save(1), "state": digest(t._checkpoint_state())}
    for mesh in ({"depth": 2}, {"sp": 2}):
        p2p = P2pTrainer(load_config(dict(spec["p2p_cfg"], mesh=mesh)),
                         torch.device("cpu"), quiet=True)
        p2p._step({k: torch.from_numpy(v)
                   for k, v in spec["p2p_batch"].items()}, p2p.lr, p2p.lr_d)
        out[f"p2p_{next(iter(mesh))}"] = (
            p2p.plan.kind, p2p.state.sp.n, digest(p2p._checkpoint_state()))
    return out


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
            out["fractional"] = fractional(todo["fractional"])
        if "ckpt" in todo:
            out["ckpt"] = run_ckpt(todo["ckpt"])
        torch.save(out, f"{sys.argv[2]}.{dist.rank()}")
    finally:
        dist.shutdown()
'''
_ns = {"__name__": "depth_rank"}
exec(compile(_RANK, "depth_rank", "exec"), _ns)
digest, SmallP3d = _ns["digest"], _ns["SmallP3d"]


# -- the nets and the batches -------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    """JAX's seeded G (2 blocks, base 8), D and the forward's G (1 block),
    each from one jitted init, in float64."""
    a = jnp.zeros((1, 4, SIZE, SIZE, 1))
    gp = jax.jit(jax_g().init)(jax.random.PRNGKey(0), a)
    dp = jax.jit(jax_d().init)(jax.random.PRNGKey(1),
                               jnp.zeros((1, 4, SIZE, SIZE, 2)))
    fp = jax.jit(_jax_fwd_g().init)(jax.random.PRNGKey(2), a)
    return tuple(f64(jax.device_get(t)) for t in (gp, dp, fp))


def _jax_fwd_g(**kw):
    return jax_vol.Generator3D(1, 1, tap_head=False, tap_tail=False,
                               **FWD_G, **kw)


def _port_g(gp, ds=(1, 1), **kw):
    g = Generator3D(1, 1, depth_strides=ds, **(kw or SMALL)).double()
    g.load_state_dict(generator3d_state_dict(gp), strict=True)
    return g


def _port_d(dp):
    from ctagan_tpu_torch.models.volumetric import Discriminator3D

    d = Discriminator3D(2).double()
    d.load_state_dict(discriminator3d_state_dict(dp), strict=True)
    return d


def _batch(n, depth=DEPTH, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (n, depth, SIZE, SIZE, 1))
            for k in ("A", "B")}


def _series(slices, seed=4):
    """A series that f32 holds exactly (JAX's sharded forward casts it)."""
    return np.random.default_rng(seed).uniform(
        -1, 1, (slices, SIZE, SIZE)).astype(np.float32).astype(np.float64)


def _case(params, aug, ds=1, n=2, axis="depth"):
    """P3d at 16 × 32²: one step of a batch of 2 with JAX's flips; with
    ``aug`` two steps with the EMA and ``grad_accum: 2``, the flips drawn
    from the state's generator."""
    gp, dp, _ = params
    return dict(nets=[_port_g(gp, {1: (1, 1), 2: (1, 2)}[ds]), _port_d(dp)],
                ema=aug, cfg=dict(CFG, grad_accum=2 if aug else 1),
                batch=_batch(n), lr=LR, steps=2 if aug else 1,
                flips=None if aug else FLIPS, axis=axis)


# -- JAX's runs, in a child process --------------------------------------------

def _norm3d_f64(x, eps=1e-5, spatial_axis=None, halo=0):
    """JAX's ``instance_norm3d``, its sharded branch included, with
    ``promote_types(x.dtype, f32)`` statistics."""
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    if spatial_axis is None:
        mean = jnp.mean(xf, axis=(1, 2, 3), keepdims=True)
        var = jnp.var(xf, axis=(1, 2, 3), keepdims=True)
        return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)
    d = xf.shape[1]
    idx = jax.lax.axis_index(spatial_axis)
    nproc = jax.lax.psum(1, spatial_axis)
    sl = jnp.arange(d)
    ghost = ((sl < halo) & (idx != 0)) | ((sl >= d - halo)
                                           & (idx != nproc - 1))
    w = jnp.where(ghost, 0.0, 1.0).astype(xf.dtype)[None, :, None, None,
                                                      None]
    s1 = jax.lax.psum(jnp.sum(xf * w, axis=(1, 2, 3), keepdims=True),
                      spatial_axis)
    n = jax.lax.psum(jnp.sum(w) * xf.shape[2] * xf.shape[3], spatial_axis)
    mean = s1 / n
    s2 = jax.lax.psum(jnp.sum(((xf - mean) ** 2) * w, axis=(1, 2, 3),
                              keepdims=True), spatial_axis)
    return ((xf - mean) * jax.lax.rsqrt(s2 / n + eps)).astype(x.dtype)


def _jax_child(params_file, out):
    """JAX's sharded forwards (4 devices at halo 8 and 2, all 8 at the
    default halo) and its depth step on ``make_depth_mesh(n=2)``, float64,
    pickled to ``out``."""
    with open(params_file, "rb") as f:
        gp, dp, fp = pickle.load(f)
    jax_vol.instance_norm3d = _norm3d_f64
    jax.config.update("jax_enable_x64", True)
    g = _jax_fwd_g()
    res = {"forward": {
        h: np.asarray(jax_volume.infer_volume_depth_sharded(
            g, fp, _series(FWD_SLICES[4]), mesh=jax_make_mesh(n=4), halo=h))
        for h in (FWD_HALO, FWD_NEG)}}
    res["forward"][None] = np.asarray(jax_volume.infer_volume_depth_sharded(
        g, fp, _series(FWD_SLICES[8]), mesh=jax_make_mesh()))
    mesh = jax_volume.make_depth_mesh(n=2)
    tx = jax_steps.make_optimizer()
    state = jax_volume.shard_p3d_state_depth(jax_steps.P2pState(
        gp, dp, tx.init(gp), tx.init(dp), _key_with(FLIPS), None), mesh)
    step = jax_volume.depth_train_step_fn(jax_g(), jax_d(), tx, CFG)
    batch = jax_volume.shard_batch_depth(_batch(2), mesh)
    res["p3d"] = jax.device_get(step(state, batch, jnp.float64(LR)))
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
def depth_runs(tmp_path_factory, jax_params):
    """Two ranks under ``{depth: 2}`` twice (the step cases and the
    checkpoint drills; ``depth_downsample: 2``, P3d's ``{sp: 2}``, the
    gradchecks and the fractional slab), four under ``{dp: 2, depth:
    2}`` (the hybrid case, the forwards at halo 8 and 2), eight (the
    forward at the default halo), one process on each case's global batch
    and a JAX child, all started at once; the world-1 resume here after
    them."""
    tmp = tmp_path_factory.mktemp("depth")
    (tmp / "rank.py").write_text(_RANK)
    with open(tmp / "params", "wb") as f:
        pickle.dump(jax_params, f)
    cases = {"p3d": _case(jax_params, False),
             "p3d_aug": _case(jax_params, True),
             "ds2": _case(jax_params, True, ds=2),
             "sp": dict(_case(jax_params, True), axis="spatial")}
    hybrid = _case(jax_params, True, n=4)
    ckpt_root = tmp / "ckpt"
    ckpt_cfg = dict(name="P3d", size=SIZE, patch_depth=DEPTH, seed=0,
                    n_cpu=1, n_epochs=1, decay_epoch=0, train_list="unused",
                    val_list="unused", test_list="unused",
                    save_root=f"{ckpt_root}/model/",
                    image_save=f"{ckpt_root}/img/")
    p2p_batch = {k: v.astype(np.float32)
                 for k, v in pair_batch(1, 64).items()}
    fwd_g = _port_g(jax_params[2], **FWD_G)
    procs = [
        _launch(tmp, "w2b", 2, {
            "plan": (1, 2), "cases": {k: cases[k] for k in ("ds2", "sp")},
            "gradcheck": LAYERS,
            "fractional": {"g": _port_g(jax_params[0], (2, 2)),
                           "d": _port_d(jax_params[1]),
                           "batch": _batch(1, depth=4)}}),
        _launch(tmp, "w2", 2, {
            "plan": (1, 2),
            "cases": {k: cases[k] for k in ("p3d", "p3d_aug")},
            "ckpt": {"cfg": ckpt_cfg, "batch": {
                k: v[:1].astype(np.float32) for k, v in _batch(1).items()},
                "p2p_cfg": _p2p_cfg(tmp / "p2p", "unused.txt", size=64),
                "p2p_batch": p2p_batch}}),
        _launch(tmp, "w4", 4, {
            "plan": (2, 2), "cases": {"hybrid": hybrid},
            "forward": {"g": fwd_g, "x": _series(FWD_SLICES[4]),
                        "halos": (FWD_HALO, FWD_NEG)}}),
        _launch(tmp, "w8", 8, {
            "plan": None, "cases": {},
            "forward": {"g": fwd_g, "x": _series(FWD_SLICES[8]),
                        "halos": (None,)}}),
        _launch(tmp, "one", None, {"plan": None, "cases": dict(
            cases, hybrid=hybrid)}),
        subprocess.Popen(
            [sys.executable, "-c", "from tests.test_torch_port_depth import "
             f"_jax_child; _jax_child({str(tmp / 'params')!r}, "
             f"{str(tmp / 'jax')!r})"],
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
    runs = {w: [torch.load(f"{tmp / w}.{r}", weights_only=False)
                for r in range(n)] for w, n in (("w2", 2), ("w2b", 2),
                                                ("w4", 4), ("w8", 8))}
    one = torch.load(f"{tmp / 'one'}.0", weights_only=False)
    back = SmallP3d(load_config(dict(ckpt_cfg, resume=True)),
                    torch.device("cpu"), quiet=True)
    ext = {}
    with torch.no_grad():
        for h, slices in ((FWD_HALO, 32), (FWD_NEG, 32), (None, 64)):
            pad = 6 + 2 * FWD_G["n_residual_blocks"] if h is None else h
            x = np.pad(_series(slices), ((pad, pad), (0, 0), (0, 0)),
                       mode="symmetric")
            ext[h] = fwd_g(torch.from_numpy(x)[None, ..., None])[
                0, pad:-pad, :, :, 0].numpy()
    yield {**runs, "one": one, "jax": jax_res, "ext": ext,
           "world1": (back.start_epoch, digest(back._checkpoint_state()))}
    shutil.rmtree(tmp, ignore_errors=True)


# -- (a) the plan -----------------------------------------------------------------

@pytest.mark.parametrize("spec,world", [({"depth": 8}, 8),
                                        ({"dp": 2, "depth": 4}, 8),
                                        ({"depth": 2}, 2)], ids=str)
def test_depth_plan_is_jaxs(spec, world):
    want = jax_plan_from_spec(spec, jax.devices()[:world])
    got = plan_from_spec(spec, world)
    axes = dict(zip(want.mesh.axis_names, want.mesh.devices.shape))
    assert (got.kind, got.batch_scale) == (want.kind, want.batch_scale) \
        == ("depth", spec.get("dp", 1))
    assert got.describe().startswith(
        f"mesh plan: {axes} (kind=depth, batch x{want.batch_scale}); ")
    assert (got.dp, got.depth) == (spec.get("dp", 1), spec["depth"])
    assert [got.batch_rank(r) for r in range(world)] == [
        r // spec["depth"] for r in range(world)]
    with pytest.raises(ValueError, match=f"process group has {world + 1}"):
        plan_from_spec(spec, world + 1)
    with pytest.raises(ValueError, match=f"needs {world} devices, have 1"):
        plan_from_spec(spec, 1)


def test_depth_with_another_model_axis_raises_jaxs_error():
    spec = {"depth": 2, "sp": 2}
    with pytest.raises(ValueError) as want:
        jax_plan_from_spec(spec)
    with pytest.raises(ValueError) as got:
        plan_from_spec(spec, 4)
    assert str(got.value) == str(want.value)
    assert "at most one" in str(got.value)


def test_train_starts_dp_times_depth_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    for mesh, n in (({"depth": 2}, 2), ({"depth": 4}, 4),
                    ({"dp": 2, "depth": 2}, 4)):
        assert dp_ranks(load_config({"mesh": mesh}), cuda, None) == n
    with pytest.raises(SystemExit, match="needs 8 devices, have 4"):
        dp_ranks(load_config({"mesh": {"depth": 8}}), cuda, None)


# -- (b) the layers ------------------------------------------------------------------

@pytest.mark.parametrize("layer", list(LAYERS))
def test_depth_layers_pass_gradcheck_on_two_ranks(depth_runs, layer):
    for rank in depth_runs["w2b"]:
        ok, err = rank["gradcheck"][layer]
        assert ok and err <= 1e-14, (layer, err)


# -- (c) the sharded forward -------------------------------------------------------

@pytest.mark.parametrize("h", [FWD_HALO, None], ids=["halo8_4ranks",
                                                     "default_8ranks"])
def test_sharded_forward_matches_jax_and_the_extended_volume(depth_runs, h):
    ranks = depth_runs["w4" if h == FWD_HALO else "w8"]
    want = depth_runs["jax"]["forward"][h]
    for rank in ranks:
        got = rank["forward"][h]
        assert got.shape == want.shape == (len(want), SIZE, SIZE)
        assert got.dtype == np.float64
        assert np.abs(got - want).max() <= FWD_TOL
        assert np.abs(got - depth_runs["ext"][h]).max() <= PORT_TOL
        assert np.array_equal(got, ranks[0]["forward"][h])


def test_too_small_halo_differs_from_the_extended_volume(depth_runs):
    for rank in depth_runs["w4"]:
        got = rank["forward"][FWD_NEG]
        assert np.abs(got - depth_runs["ext"][FWD_NEG]).max() > 1e-3
        assert np.abs(got - depth_runs["jax"]["forward"][FWD_NEG]).max() \
            <= FWD_TOL


@pytest.mark.parametrize("slices,n,halo,strides", [
    (30, 4, None, (1, 1)), (16, 4, 8, (1, 1)), (32, 4, 8, (2, 1))],
    ids=["divide", "halo", "depth_strides"])
def test_sharded_forward_validation_is_jaxs(jax_params, slices, n, halo,
                                            strides):
    vol = np.zeros((slices, SIZE, SIZE), np.float32)
    with pytest.raises(ValueError) as want:
        jax_volume.infer_volume_depth_sharded(
            _jax_fwd_g(depth_strides=strides), jax_params[2], vol,
            mesh=jax_make_mesh(n=n), halo=halo)
    g = _port_g(jax_params[2], strides, **FWD_G)
    # JAX raises the strides' error inside its forward; the port's forward
    # does too, after the exchange: a mesh of one has none to make
    port_n = n if strides == (1, 1) else 1
    with pytest.raises(ValueError) as got:
        volume.infer_volume_depth_sharded(
            g, vol, spatial.SpMesh(port_n, 0, None, axis="depth"), halo=halo)
    assert str(got.value) == str(want.value)


# -- (d), (e) the steps --------------------------------------------------------------

@pytest.mark.parametrize("net", ["g", "d"])
def test_depth_step_matches_jax_depth_step(depth_runs, net):
    new, want_losses = depth_runs["jax"]["p3d"]
    params, opt, i = {"g": ("g_params", "g_opt", 0),
                      "d": ("d_params", "d_opt", 1)}[net]
    for rank in depth_runs["w2"]:
        got = rank["p3d"]
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


@pytest.mark.parametrize("case", ["p3d", "p3d_aug", "ds2", "sp", "hybrid"])
def test_depth_step_matches_one_process(depth_runs, case):
    ranks = depth_runs[{"hybrid": "w4", "ds2": "w2b", "sp": "w2b"}.get(
        case, "w2")]
    for rank in ranks:
        _held(rank[case], depth_runs["one"][case], PORT_TOL)
    # the replicated weights, moments and losses bit-identical on the ranks
    for rank in ranks[1:]:
        for key in ("weights", "moments"):
            for wa, wb in zip(rank[case][key], ranks[0][case][key]):
                assert all(torch.equal(wa[k], wb[k]) for k in wa)
        assert rank[case]["losses"] == ranks[0][case]["losses"]


# -- (f), (g) the trainers ---------------------------------------------------------

def test_pt_written_under_depth_resumes_at_world_1(depth_runs):
    ranks = [r["ckpt"] for r in depth_runs["w2"]]
    assert [(r["kind"], r["depth"]) for r in ranks] == [("depth", 2)] * 2
    assert ranks[0]["path"] and ranks[1]["path"] is None  # rank 0 wrote it
    assert ranks[0]["path"].endswith(".pt") and "_e1" in ranks[0]["path"]
    _same(ranks[1]["state"], ranks[0]["state"])
    start_epoch, state = depth_runs["world1"]
    assert start_epoch == 1
    _same(state, ranks[0]["state"])


def test_p2p_under_depth_is_the_sp_step(depth_runs):
    for rank in depth_runs["w2"]:
        depth, sp = rank["ckpt"]["p2p_depth"], rank["ckpt"]["p2p_sp"]
        assert depth[:2] == ("depth", 2) and sp[:2] == ("sp", 2)
        _same(depth[2], sp[2])


# -- (h) the batch ------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["depth", "spatial"])
def test_indivisible_depth_raises_jaxs_message(axis):
    batch = _batch(1, depth=12)
    if axis == "depth":
        mesh = jax_volume.make_depth_mesh()
        with pytest.raises(ValueError) as want:
            jax_volume.shard_batch_depth(batch, mesh)
        assert "D divisible" in str(want.value)
    else:
        from ctagan_tpu.parallel import spatial as jax_spatial

        with pytest.raises(ValueError) as want:
            jax_spatial.shard_batch_sp(batch, jax_spatial.make_sp_mesh())
        assert "needs H divisible" in str(want.value)
    port = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError) as got:
        volume.shard_batch_depth(port, spatial.SpMesh(8, 0, None,
                                                      axis=axis))
    assert str(got.value) == str(want.value)


def test_fractional_slab_raises_on_every_rank(depth_runs):
    """``depth_downsample: 4`` at 4 slices under ``{depth: 2}``: the second
    depth stride 2 meets a slab of one slice on every rank (GSPMD would
    pad it)."""
    for rank in depth_runs["w2b"]:
        assert rank["fractional"] is not None
        assert rank["fractional"].startswith(
            "depth: the level of 2 slices splits into slabs of 1 over 2 "
            "ranks, which a conv of depth stride 2 cannot split alike")


def test_generator3d_refuses_depth_strides_under_the_inference_context(
        jax_params):
    """JAX's ``Generator3D`` check, raised by the port's own forward under
    the sharded inference's context (a mesh of one: no exchange)."""
    from ctagan_tpu_torch.models.layers import sp_scope
    from ctagan_tpu_torch.parallel.halo import _HaloNorm

    g = _port_g(jax_params[2], (1, 2), **FWD_G)
    x = torch.zeros(1, 8, SIZE, SIZE, 1, dtype=torch.float64)
    with sp_scope(_HaloNorm(spatial.SpMesh(1, 0, None, axis="depth"), 2,
                            8)):
        with pytest.raises(ValueError, match=r"depth-halo sharding "
                           r"requires depth_strides=\(1, 1\)"):
            g(x)
    assert g(x).shape == x.shape  # without the context it runs
