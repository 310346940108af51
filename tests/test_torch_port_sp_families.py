"""The sp plan's other 2-D families (``parallel/spatial.py``; RegGAN, HD
stage 1 and 2, CycleGAN) on the CPU, in float64, with gloo ranks in child
processes that ``torchrun`` starts once for the module (the launch of
``tests/test_torch_port_sp.py``), and JAX's ``reg_train_step`` in a child
of its own.

- (a) ``gradcheck`` on two ranks, as functions of an input every rank
  holds, of ``halo_rows`` with the edge fill, ``halo_resize`` up 2× and
  4× and down 2× and 4×, the gather/strip pair (with ``gradgradcheck``,
  and the edge fill's too), the pyramid's ``avg_pool_same`` and
  ``center_crop``, the smoothness loss's part and the strip warp; each
  against the whole image's value.
- (b) The ResUNet on strips: its flow and gradients under ``{sp: 2}`` at
  128² (the bottleneck's level and the 7th run whole) and under
  ``{sp: 4}`` at 256² within 1e-12 of one process; the rule picks the
  same levels on every rank from shapes alone.
- (c) HD stage 1 under ``{sp: 2}`` within 1e-6 of JAX's
  ``reg_train_step`` and within 1e-12 of the port's one process.
- (d) RegGAN (``reg_downsample: 2``; ``warp_max_disp: 4`` with the EMA),
  HD stage 1 with augmentation, ``grad_accum: 2``, ``aligned_aug`` and
  ``d_refwd: false``, HD stage 2 with ``num_d: 2`` over both pyramids and
  ``FM_lamda > 0`` (the avg-pool one with ``r1_gamma > 0`` and
  ``Corr_lamda2 > 0``), and CycleGAN
  with ``grad_accum: 2`` under ``{sp: 2}`` and ``{dp: 2, sp: 2}``: within
  1e-12 of one process, the replicas bit-identical after every step, the
  CycleGAN pools bit-identical on the ranks and within 1e-12 of one
  process's (the fakes in them are G's output on strips, rounded apart
  from one process's). Stage 2's window-masked SR_loss2 and the R1
  penalty are f32 losses by design (JAX's casts), so the case that weighs
  them is held within 1e-6; the other stage-2 case weighs SR_loss2 0.
- (e) A ``.pt`` written under ``{sp: 2}`` by HD stage 1 and by CycleGAN
  resumes at world 1 bit-equal.
- (f) Strips too short for a layer past the ResUNet's rule raise on every
  rank.

G of 2 residual blocks at base 16, the ResUNet's flow head scaled so that
its flows are a few pixels (``tests/test_torch_port_reggan.py``).
"""
import os
import pickle
import shutil
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.models import (
    Discriminator,
    Generator,
    MultiScaleDiscriminator,
    RegNet,
)
from ctagan_tpu_torch.models.reg import BOTTLENECK, WHOLE_NONE, whole_from
from ctagan_tpu_torch.train import trainers
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_dp import CHILD_ENV, JAX_TOL, MOMENT_FLOOR, _rel
from tests.test_torch_port_fsdp import _same, _torchrun
from tests.test_torch_port_p2p import (
    LR,
    f64,
    jax_small_g,
    jax_tree,
    pair_batch,
    run_jax,
    small_g,
)
from tests.test_torch_port_reggan import CFG as REG_CFG
from tests.test_torch_port_reggan import (
    CONVERT,
    FLOW_HEAD_SCALE,
    LR_D,
    _hd_batch,
    _nets,
)
from tests.test_torch_port_sp import digest

torch.set_num_threads(2)

SP2, HYBRID = (1, 2), (2, 2)
ONE_CHILDREN = 3
PORT_TOL = 1e-12
SIZE = 128  # the ResUNet's seven pools
CYC_SIZE = 64
# (rows of the image, sp ranks) of the ResUNet runs, and the level the rule
# runs whole from at each
REG_RUNS = {"sp2_128": (128, 2), "sp4_256": (256, 4)}
RULE = {(128, 2): 7, (256, 4): 7, (512, 4): BOTTLENECK,
        (512, 2): WHOLE_NONE, (96, 2): 5}

# one rank's work; run by the children and, without a group and without a
# plan, by the one-process children
_RANK = r'''
import copy
import hashlib
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models.layers import avg_pool_same, center_crop, max_pool
from ctagan_tpu_torch.ops.resize import interpolate_bilinear
from ctagan_tpu_torch.models.reg import whole_from
from ctagan_tpu_torch.ops.warp import smoothing_loss, warp2d
from ctagan_tpu_torch.parallel import dist, spatial
from ctagan_tpu_torch.parallel.mesh import shard_rows
from ctagan_tpu_torch.train import steps


def _weights_digest(nets):
    h = hashlib.sha256()
    for m in nets:
        for v in m.state_dict().values():
            h.update(v.detach().contiguous().view(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def run_case(case, plan=None):
    """The case's steps on this rank's rows of its global batch (every row
    without a group), on copies of its nets; with ``plan`` = (dp, sp) the
    state under the sp plan. Returns the weights (nets, then EMAs), Adam's
    first moments by net, each step's losses and weights' digest, and a
    CycleGAN state's pools."""
    nets = copy.deepcopy(case["nets"])
    state = getattr(steps, case["init"])(*nets, **case["init_kw"])
    dp, sp = plan if plan is not None else (dist.world(), 1)
    if plan is not None:
        spatial.shard_state_sp(state, spatial.make_sp_mesh(dp, sp))
    n = len(next(iter(case["batch"].values())))
    rows = shard_rows(n, dist.rank() // sp, dp)
    batch = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    step = getattr(steps, case["step"])
    losses, digests = [], []
    for _ in range(case["steps"]):
        out = step(state, case["cfg"], batch, case["lr"], **case["step_kw"])
        losses.append({k: float(v) for k, v in out.items()})
        digests.append(_weights_digest(nets))
    emas = [getattr(state, a) for a in state.EMA_NETS
            if getattr(state, a) is not None]
    opt_of = {net: getattr(state, opt)
              for opt, names in state.OPT_NETS.items() for net in names}
    nets_of = [a for names in state.OPT_NETS.values() for a in names]
    mu = [{k: opt_of[a].state[p]["exp_avg"].clone()
           for k, p in getattr(state, a).named_parameters()}
          for a in nets_of]
    res = {"weights": [{k: v.detach().clone() for k, v in
                        getattr(state, a).state_dict().items()}
                       for a in nets_of] + [
                           {k: v.detach().clone()
                            for k, v in m.state_dict().items()}
                           for m in emas],
           "moments": mu, "losses": losses, "digests": digests}
    if hasattr(state, "fake_a_buffer"):
        res["pools"] = [(b.data.clone(), b.size) for b in
                        (state.fake_a_buffer, state.fake_b_buffer)]
    return res


def _spread(x, mesh):
    """``x``, which every rank holds alike, as a twice-differentiable input
    of the block: its gradient summed over the ranks."""
    return dist.sum_over_group(x / mesh.n, mesh.group)


def _join(y, mesh):
    """The ranks' parts (their rows placed in zeros of the whole shape, or
    their parts of a loss) summed over the block."""
    return dist.sum_over_group(y, mesh.group)


def _place(y, lo, whole_rows):
    """A strip's rows ``lo``.. placed in zeros of ``whole_rows`` rows."""
    return F.pad(y.permute(0, 3, 1, 2),
                 (0, 0, lo, whole_rows - lo - y.shape[1])).permute(0, 2, 3, 1)


def _resize_ref(x, size):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def gradchecks():
    """Each Function of the slice as a function of inputs every rank
    holds: {name: (gradcheck ok, gradgradcheck ok or None, max error of
    the rows against the whole image's)}."""
    mesh = spatial.make_sp_mesh(1, dist.world())
    gen = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64)
    x = torch.rand(1, 8 * mesh.n, 5, 2, generator=gen, **f64)
    lo8 = 8 * mesh.index
    out = {}

    def check(name, fn, inputs, ref, rows, lo, twice=False):
        """``fn`` of this rank's strips -> its rows from ``lo`` of a whole
        output of ``rows`` rows (or, ``rows`` None, its part of a loss)."""
        def whole(*xs):
            y = fn(*(_spread(t, mesh) for t in xs))
            return _join(y if rows is None else _place(y, lo, rows), mesh)

        ins = tuple(t.clone().requires_grad_() for t in inputs)
        ok = torch.autograd.gradcheck(whole, ins)
        ok2 = torch.autograd.gradgradcheck(whole, ins) if twice else None
        err = float((whole(*inputs) - ref).abs().max())
        out[name] = (ok, ok2, err)

    def halo_edge(t):
        return spatial.halo_rows(spatial.strip(t, mesh), mesh, 1, 1, 1,
                                 fill="edge")

    xp = F.pad(x.permute(0, 3, 1, 2), (0, 0, 1, 1), mode="replicate"
               ).permute(0, 2, 3, 1)
    # the rank's 10 rows of the edge-padded whole: a whole of 8n + 2 rows,
    # whose overlapping rows the join sums, so hold each rank's own
    check("halo_rows edge", halo_edge, (x,),
          _join(_place(xp[:, lo8:lo8 + 10], lo8, 8 * mesh.n + 2), mesh),
          8 * mesh.n + 2, lo8, twice=True)
    for name, (rows, size) in {
            "resize up 2x": (8, (16, 7)), "resize up 4x": (8, (32, 5)),
            "resize down 2x": (8, (4, 5)), "resize down 4x": (8, (2, 3))
    }.items():
        def resize(t, size=size):
            with spatial.training_scope(mesh):
                return interpolate_bilinear(spatial.strip(t, mesh), size)

        check(name, resize, (x,),
              _resize_ref(x, (size[0] * mesh.n, size[1])),
              size[0] * mesh.n, size[0] * mesh.index)

    def pair(t):  # the strip gathered whole, squared, this rank's strip
        whole = dist.gather_whole(spatial.strip(t, mesh), mesh.group)
        return spatial.strip(torch.sin(whole) * whole.sum(), mesh)

    check("gather/strip pair", pair, (x,), torch.sin(x) * x.sum(),
          8 * mesh.n, lo8, twice=True)

    def pool(t):
        with spatial.training_scope(mesh):
            return avg_pool_same(spatial.strip(t, mesh))

    check("avg_pool_same", pool, (x,), avg_pool_same(x), 4 * mesh.n,
          4 * mesh.index)
    y = torch.rand(1, 8 * mesh.n, 8 * mesh.n, 1, generator=gen, **f64)

    def crop(t):  # a centre crop to half: an outer strip holds none of it
        with spatial.training_scope(mesh):
            return center_crop(spatial.strip(t, mesh), 4 * mesh.n)

    check("center_crop", crop, (y,), center_crop(y, 4 * mesh.n),
          4 * mesh.n, 4 * mesh.index)
    flow = (torch.rand(1, 8 * mesh.n, 5, 2, generator=gen, **f64) - 0.5) * 4

    def smooth(f):
        with spatial.training_scope(mesh):
            return smoothing_loss(spatial.strip(f, mesh))

    check("smoothing part", smooth, (flow,), smoothing_loss(flow), None, 0)
    src = torch.rand(1, 8 * mesh.n, 5, 1, generator=gen, **f64)

    def warp(s, f):
        with spatial.training_scope(mesh):
            return warp2d(spatial.strip(s, mesh), spatial.strip(f, mesh))

    check("strip warp", warp, (src, flow), warp2d(src, flow), 8 * mesh.n,
          lo8)
    return out


def regnet(spec):
    """The ResUNet on this rank's strips of ``spec["x"]`` (a, b) under
    ``{sp: n}`` (the world), a loss part of its flow against ``spec["c"]``:
    the flow's rows, every parameter's gradient summed over the block, the
    inputs' gradients' rows, the level the rule picked."""
    mesh = spatial.make_sp_mesh(1, dist.world())
    r = spec["r"]
    a, b = (spatial.strip(t, mesh).clone().requires_grad_()
            for t in spec["x"])
    with spatial.training_scope(mesh):
        flow = r(a, b)
        c = spatial.strip(spec["c"], mesh)
        loss = (flow * c).sum() / spec["c"].numel()
    params = list(r.parameters())
    grads = torch.autograd.grad(loss, params + [a, b])
    g = [t.clone() for t in grads[:len(params)]]
    dist.all_reduce_mean_(g, mesh.group, mean=False)
    return {"flow": flow.detach(), "grads": g,
            "input_grads": [t.clone() for t in grads[len(params):]],
            "rule": whole_from(a.shape[1]), "index": mesh.index}


def short_strips():
    """Strips too short for a layer that no rule gathers: a max pool of an
    odd strip, a resize down by 2 from an odd row and D on 16 rows a rank
    (after three stride-2 convs its 4x4 stride-1 conv needs two rows from
    the last rank's one). The messages, every rank's."""
    from ctagan_tpu_torch.models import Discriminator

    mesh = spatial.make_sp_mesh(1, dist.world())
    f64 = dict(dtype=torch.float64)
    out = []
    d = Discriminator().reset_parameters(3).double()
    for fn in (lambda: max_pool(torch.zeros(1, 3, 4, 1, **f64), 2),
               lambda: spatial.halo_resize(torch.zeros(1, 3, 4, 1, **f64),
                                           spatial.SpMesh(2, 1, None),
                                           (1, 4)),
               lambda: d(torch.zeros(1, 8, 16, 1, **f64))):
        try:
            with spatial.training_scope(mesh):
                fn()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def digest(obj):
    if isinstance(obj, dict):
        return {k: digest(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [digest(v) for v in obj]
    if torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous().reshape(-1)
        return (str(t.dtype), tuple(obj.shape), hashlib.sha256(
            t.view(torch.uint8).numpy().tobytes()).hexdigest())
    return obj


def run_ckpt(specs):
    """(e): each trainer under ``{sp: 2}``: a step of its batch, a save
    (rank 0 writes), its state as its :func:`digest`."""
    from ctagan_tpu_torch.train import trainers
    from ctagan_tpu_torch.utils.config import load_config

    out = {}
    for name, spec in specs.items():
        t = getattr(trainers, spec["cls"])(
            load_config(dict(spec["cfg"], mesh={"sp": 2})),
            torch.device("cpu"), quiet=True)
        t._step({k: torch.from_numpy(v) for k, v in spec["batch"].items()},
                t.lr, t.lr_d)
        out[name] = {"kind": t.plan.kind, "sp": t.state.sp.n,
                     "path": t._save(1),
                     "state": digest(t._checkpoint_state())}
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    todo = torch.load(sys.argv[1], weights_only=False)
    dist.init(torch.device("cpu"))
    try:
        out = {name: run_case(case, todo["plan"])
               for name, case in todo["cases"].items()}
        for name, spec in todo.get("regnet", {}).items():
            out[name] = regnet(spec)
        if "gradcheck" in todo:
            out["gradcheck"] = gradchecks()
            out["short"] = short_strips()
        if "ckpt" in todo:
            out["ckpt"] = run_ckpt(todo["ckpt"])
        torch.save(out, f"{sys.argv[2]}.{dist.rank()}")
    finally:
        dist.shutdown()
'''


# -- the cases ------------------------------------------------------------------

def _reg_nets(d=None):
    g, r, d0 = _nets()
    return [g.double(), r.double(), (d or d0).double()]


def _msd(pyramid):
    return MultiScaleDiscriminator(1, num_d=2, pyramid=pyramid
                                   ).reset_parameters(2)


def _reg_case(cfg, batch, steps=2, dual=True, stage2=False, d=None,
              ema=False):
    kw = {"dual_window_mode": dual, "stage2": stage2}
    if dual:
        kw["lr_d"] = LR_D
    return dict(nets=_reg_nets(d), init="init_reg_state",
                init_kw={"ema": ema}, step="reg_train_step", step_kw=kw,
                cfg={**REG_CFG, "Corr_lamda2": 0.0, **cfg}, batch=batch,
                lr=LR, steps=steps)


def _cyc_case(n):
    nets = [small_g(0).double(), small_g(1).double(),
            Discriminator().reset_parameters(2).double(),
            Discriminator().reset_parameters(3).double()]
    return dict(nets=nets, init="init_cyc_state",
                init_kw=dict(size=CYC_SIZE, buffer_size=3, ema=True),
                step="cyc_train_step", step_kw={},
                cfg={"Adv_lamda": 1.0, "Cyc_lamda": 10.0, "noise_level": 1,
                     "aligned_aug": False, "grad_accum": 2},
                batch=pair_batch(n, CYC_SIZE), lr=LR, steps=3)


AUG = dict(noise_level=1)
STAGE2 = dict(AUG, FM_lamda=1.0)


def _cases(n):
    """Each family's cases on a global batch of ``n`` (a row a dp column
    under ``{dp: 2, sp: 2}``)."""
    return {
        "reg_ds2": dict(_reg_case(dict(AUG, reg_downsample=2),
                                  pair_batch(n, 2 * SIZE), steps=1,
                                  dual=False)),
        "reg_wr4": _reg_case(dict(AUG, warp_max_disp=4, ema_decay=0.9),
                             pair_batch(n, SIZE), dual=False, ema=True),
        "hd1_aug": _reg_case(dict(AUG, grad_accum=2, aligned_aug=True,
                                  d_refwd=False), _hd_batch(2 * n)),
        "hd2_crop": _reg_case(STAGE2, _hd_batch(n), stage2=True,
                              d=_msd("center_crop")),
        "hd2_avg_r1_sr2": _reg_case(
            dict(STAGE2, r1_gamma=1.0, Corr_lamda2=2.0), _hd_batch(n),
            stage2=True, d=_msd("avg_pool")),
        "cyc_accum2": _cyc_case(2 * n),
    }


# SR_loss2 and the R1 penalty are f32 losses by design (JAX's casts): the
# case that weighs them is held within 1e-6, the rest within PORT_TOL
F32_CASES = {"hd2_avg_r1_sr2": JAX_TOL}


def _hd1_case():
    """HD stage 1, one step of one pair without augmentation: against
    JAX's step."""
    return _reg_case({}, _hd_batch(1), steps=1)


def _regnet_spec(size, seed):
    rng = np.random.default_rng(seed)
    r = RegNet().reset_parameters(1)
    with torch.no_grad():
        r.offset_map.output.conv2d.weight.mul_(FLOW_HEAD_SCALE)
    x = [torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 1)))
         for _ in range(2)]
    return {"r": r.double(), "x": x,
            "c": torch.from_numpy(rng.standard_normal((1, size, size, 2)))}


def _regnet_one(spec):
    """One process's flow and gradients of :func:`_regnet_spec`."""
    r = spec["r"]
    a, b = (t.clone().requires_grad_() for t in spec["x"])
    flow = r(a, b)
    loss = (flow * spec["c"]).sum() / spec["c"].numel()
    grads = torch.autograd.grad(loss, list(r.parameters()) + [a, b])
    n = len(list(r.parameters()))
    return {"flow": flow.detach(), "grads": list(grads[:n]),
            "input_grads": list(grads[n:])}


def _ckpt_specs(root):
    base = dict(seed=0, n_cpu=1, n_epochs=1, decay_epoch=1, val_every=1,
                train_list="unused.txt", val_list="unused.txt",
                test_list="unused.txt")
    f32 = {k: v.astype(np.float32) for k, v in _hd_batch(1).items()}
    return {
        "hd1": {"cls": "HdTrainerStage1",
                "cfg": dict(base, name="HdGan", size=SIZE,
                            save_root=f"{root}/hd1/model/",
                            image_save=f"{root}/hd1/img/"),
                "batch": f32},
        "cyc": {"cls": "CycTrainer",
                "cfg": dict(base, name="CycleGan", size=CYC_SIZE,
                            save_root=f"{root}/cyc/model/",
                            image_save=f"{root}/cyc/img/"),
                "batch": {k: v.astype(np.float32) for k, v in
                          pair_batch(1, CYC_SIZE).items()}},
    }


def _jax_child(out):
    """JAX's HD stage-1 step of :func:`_hd1_case` in float64, pickled to
    ``out``: (new state, losses)."""
    case = _hd1_case()
    nets = _nets()
    gp, rp, dp = (f64(jax_tree(net)) for net in nets)
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        state = jax_steps.RegState(gp, rp, dp, tx.init(gp), tx.init(rp),
                                   tx.init(dp), jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_enable_x64", False)
    res = run_jax(partial(jax_steps.reg_train_step, jax_small_g(),
                          JaxRegNet(), JaxDiscriminator(), tx, case["cfg"],
                          dual_window_mode=True, lr_d=np.float64(LR_D)),
                  state, case["batch"])
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _launch(tmp, name, n, todo):
    torch.save(todo, tmp / f"{name}.pt")
    return subprocess.Popen(
        ([sys.executable] if n is None else _torchrun(n))
        + [str(tmp / "rank.py"), str(tmp / f"{name}.pt"), str(tmp / name)],
        env=dict(os.environ, **CHILD_ENV))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks under ``{sp: 2}`` (every case, the gradchecks, the ResUNet
    at 128², the short strips, the checkpoint drill), four under ``{dp: 2,
    sp: 2}`` (every case on twice the batch, the ResUNet under ``{sp: 4}``
    at 256²), one process on each case's global batch (ONE_CHILDREN
    children) and the JAX child, all started at once; the world-1 resumes
    here after them."""
    tmp = tmp_path_factory.mktemp("sp_families")
    (tmp / "rank.py").write_text(_RANK)
    cases2 = dict(_cases(1), hd1=_hd1_case())
    cases4 = _cases(2)
    assert sorted(cases4) == CASES
    specs = _ckpt_specs(tmp)
    regs = {k: _regnet_spec(*REG_RUNS[k][:1], seed=5) for k in REG_RUNS}
    # one process's runs of every case, over ONE_CHILDREN children
    jobs = sorted({**cases2, **{f"{k}@4": v for k, v in cases4.items()}
                   }.items())
    procs = [
        _launch(tmp, "w2", 2, {"plan": SP2, "cases": cases2,
                               "regnet": {"sp2_128": regs["sp2_128"]},
                               "gradcheck": True, "ckpt": specs}),
        _launch(tmp, "w4", 4, {"plan": HYBRID, "cases": cases4,
                               "regnet": {"sp4_256": regs["sp4_256"]}}),
        *(_launch(tmp, f"one{i}", None, {"plan": None, "cases": dict(
            jobs[i::ONE_CHILDREN])}) for i in range(ONE_CHILDREN)),
        subprocess.Popen(
            [sys.executable, "-c", "from tests.test_torch_port_sp_families "
             f"import _jax_child; _jax_child({str(tmp / 'jax')!r})"],
            env=dict(os.environ, **CHILD_ENV))]
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
    one = {}
    for i in range(ONE_CHILDREN):
        one.update(torch.load(f"{tmp / f'one{i}'}.0", weights_only=False))
    world1 = {}
    for name, spec in specs.items():
        back = getattr(trainers, spec["cls"])(
            load_config(dict(spec["cfg"], resume=True)),
            torch.device("cpu"), quiet=True)
        world1[name] = (back.start_epoch, digest(back._checkpoint_state()))
    reg_one = {k: _regnet_one(v) for k, v in regs.items()}
    yield {"w2": w2, "w4": w4, "one": one, "jax": jax_res,
           "world1": world1, "reg_one": reg_one}
    shutil.rmtree(tmp, ignore_errors=True)


def _held(got, want, tol):
    """Losses within ``tol`` (relative beyond 1); Adam's first moments per
    tensor within ``tol`` of the tensor's norm, floored at MOMENT_FLOOR of
    the net's largest; the weights per tensor within ``tol`` of their norm,
    but the biases whose gradient is rounding alone (below the floor)
    within 1e-4 of a step (``tests/test_torch_port_fsdp.py::_held``); an
    EMA (after the nets) as the generator it shadows."""
    for lg, lw in zip(got["losses"], want["losses"], strict=True):
        assert lg.keys() == lw.keys()
        for k in lw:
            assert abs(lg[k] - lw[k]) <= tol * max(1.0, abs(lw[k])), k
    n = len(want["moments"])
    for i, (wg, ww) in enumerate(zip(got["weights"], want["weights"],
                                     strict=True)):
        mw = want["moments"][i if i < n else i - n]
        floor = MOMENT_FLOOR * max(float(v.norm()) for v in mw.values())
        assert set(wg) == set(ww) == set(mw)
        for k, w in mw.items():
            if i < n:
                assert _rel(got["moments"][i][k].numpy(), w.numpy(),
                            floor) <= tol, (i, k)
            if float(w.norm()) > floor:
                assert _rel(wg[k].numpy(), ww[k].numpy(), 0.0) <= tol, (i, k)
            else:
                assert float((wg[k] - ww[k]).abs().max()) <= 1e-4 * LR, (i, k)


# -- (a) the Functions --------------------------------------------------------------

GRADCHECKS = ["halo_rows edge", "resize up 2x", "resize up 4x",
              "resize down 2x", "resize down 4x", "gather/strip pair",
              "avg_pool_same", "center_crop", "smoothing part",
              "strip warp"]


@pytest.mark.parametrize("name", GRADCHECKS)
def test_functions_pass_gradcheck_on_two_ranks(runs, name):
    for rank in runs["w2"]:
        ok, ok2, err = rank["gradcheck"][name]
        assert ok and err <= 1e-14, (name, err)
        if name in ("halo_rows edge", "gather/strip pair"):
            assert ok2, name  # twice differentiable


# -- (b) the ResUNet ----------------------------------------------------------------

@pytest.mark.parametrize("run", list(REG_RUNS))
def test_resunet_on_strips_matches_one_process(runs, run):
    size, n = REG_RUNS[run]
    ranks = runs["w2" if n == 2 else "w4"]
    want = runs["reg_one"][run]
    scale = max(float(g.abs().max()) for g in want["grads"])
    assert float(want["flow"].abs().max()) > 0.5  # flows of pixels
    for rank in ranks:
        got = rank[run]
        h, lo = size // n, size // n * got["index"]
        assert got["rule"] == RULE[(size, n)]
        assert float((got["flow"] - want["flow"][:, lo:lo + h]).abs().max()
                     ) <= PORT_TOL * float(want["flow"].abs().max())
        for g, w in zip(got["grads"], want["grads"], strict=True):
            assert float((g - w).abs().max()) <= PORT_TOL * scale
        for g, w in zip(got["input_grads"], want["input_grads"]):
            assert float((g - w[:, lo:lo + h]).abs().max()) <= \
                PORT_TOL * float(w.abs().max())


@pytest.mark.parametrize("shape", list(RULE), ids=str)
def test_deep_level_rule_is_alike_on_every_rank_from_shapes(runs, shape):
    size, n = shape
    assert whole_from(size // n) == RULE[shape]
    for run, (s, m) in REG_RUNS.items():
        ranks = runs["w2" if m == 2 else "w4"]
        assert len({rank[run]["rule"] for rank in ranks}) == 1


# -- (c) HD stage 1 against JAX --------------------------------------------------

@pytest.mark.parametrize("net", ["g", "r", "d"])
def test_hd1_sp_step_matches_jax_reg_train_step(runs, net):
    new, want_losses = runs["jax"]
    i = "grd".index(net)
    for rank in runs["w2"]:
        got = rank["hd1"]
        for k, v in want_losses.items():
            np.testing.assert_allclose(got["losses"][0][k], float(v),
                                       rtol=1e-9, atol=1e-15, err_msg=k)
        for tree, have in ((getattr(new, f"{net}_params"),
                            got["weights"][i]),
                           (getattr(new, f"{net}_opt").mu,
                            got["moments"][i])):
            want = {k: v.numpy() for k, v in CONVERT[net](tree).items()}
            floor = MOMENT_FLOOR * max(np.linalg.norm(w)
                                       for w in want.values())
            for k, w in want.items():
                assert _rel(have[k].numpy(), w, floor) <= JAX_TOL, (k, net)


def test_hd1_sp_step_matches_one_process(runs):
    for rank in runs["w2"]:
        _held(rank["hd1"], runs["one"]["hd1"], PORT_TOL)


# -- (d) the families ------------------------------------------------------------------

CASES = ["cyc_accum2", "hd1_aug", "hd2_avg_r1_sr2", "hd2_crop", "reg_ds2",
         "reg_wr4"]


@pytest.mark.parametrize("mesh", ["sp2", "dp2_sp2"])
@pytest.mark.parametrize("case", CASES)
def test_family_step_matches_one_process(runs, case, mesh):
    ranks = runs["w2"] if mesh == "sp2" else runs["w4"]
    want = runs["one"][case if mesh == "sp2" else f"{case}@4"]
    tol = F32_CASES.get(case, PORT_TOL)
    for rank in ranks:
        _held(rank[case], want, tol)
    # the replicated state bit-identical on the ranks after every step
    for rank in ranks[1:]:
        assert rank[case]["digests"] == ranks[0][case]["digests"]
        assert rank[case]["losses"] == ranks[0][case]["losses"]
    if case.startswith("cyc"):  # the pools: whole fakes, one process's
        for rank in ranks:
            for j, ((got, size), (w, w_size)) in enumerate(zip(
                    rank[case]["pools"], want["pools"], strict=True)):
                assert size == w_size and got.shape == w.shape
                assert torch.equal(got, ranks[0][case]["pools"][j][0])
                assert float((got - w).abs().max()) <= PORT_TOL


# -- (e) checkpoints ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["hd1", "cyc"])
def test_pt_written_under_sp_resumes_at_world_1(runs, name):
    ranks = [r["ckpt"][name] for r in runs["w2"]]
    assert [(r["kind"], r["sp"]) for r in ranks] == [("sp", 2)] * 2
    assert ranks[0]["path"] and ranks[1]["path"] is None  # rank 0 wrote it
    assert ranks[0]["path"].endswith(".pt") and "_e1" in ranks[0]["path"]
    _same(ranks[1]["state"], ranks[0]["state"])
    start_epoch, state = runs["world1"][name]
    assert start_epoch == 1
    _same(state, ranks[0]["state"])


# -- (f) short strips ---------------------------------------------------------------

def test_short_strips_past_the_rule_raise_on_every_rank(runs):
    msgs = [rank["short"] for rank in runs["w2"]]
    for pool, resize, d in msgs:
        assert pool.startswith("sp: a max pool of a strip of 3 rows")
        assert resize.startswith("sp: a strip of 3 rows from row 3 cannot")
        assert d.startswith("sp: a strip of 1 rows is shorter than the rows "
                            "a layer needs from a neighbour")
