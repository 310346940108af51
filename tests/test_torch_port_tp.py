"""The port's tp plan (``parallel/tensor.py``, ``parallel/mesh.py``) on the
CPU, in float64, with gloo ranks in child processes that ``torchrun``
starts (the launch of ``tests/test_torch_port_fsdp.py``), and JAX's own tp
path (``ctagan_tpu/parallel/tensor.py``) on conftest's virtual devices, its
P2p and CycleGAN steps and its forwards in a child process while this one
jits its HD stage-1 step.

- (a) ``plan_from_spec``: ``{tp: 2}`` at world 2 and ``{dp: 2, tp: 2}`` at
  world 4 give JAX's kind, ``batch_scale`` and mesh axes; ``--mode train``
  starts dp × tp ranks.
- (b) The rules: ``tp_param_rules`` and ``reg_param_rules`` are JAX's
  ``tp_param_specs`` and ``reg_param_specs`` leaf for leaf, through
  ``models/convert.py``'s key map.
- (c) ``copy_to_tp`` / ``reduce_from_tp`` pass ``gradcheck`` on two ranks
  (a replicated input, a different weight a rank).
- (d) ``infer_tensor_sharded`` on ``{tp: 2}`` and ``{dp: 2, tp: 2}``
  within 1e-6 of JAX's on the same meshes (G of 3 blocks at base 16,
  64²).
- (e) One step of P2p, HD stage 1 (R split too) and CycleGAN under ``{tp:
  2}`` (``noise_level: 0``): every net and Adam's first moments within
  1e-6 of JAX's ``shard_state_tp`` + jitted step, and within 1e-12 of the
  port's one-process step; with augmentation P2p (EMA, two steps),
  CycleGAN (``grad_accum: 2``, the EMAs), P3d (unsharded, as in JAX) and
  P2p again under ``{dp: 2, tp: 2}`` on four ranks against one process
  within 1e-12; every weight bit-identical across the ranks.
- (f) A rank's resting state: its slices and their moments, the rest
  whole, as the rules count them.
- (g) A P2p trainer's ``.pt`` written under ``{tp: 2}`` (rank 0) is in the
  one-process layout: it resumes bit-equal at world 1 and under ``{dp:
  2}``.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.parallel import tensor as jax_tensor
from ctagan_tpu.parallel.mesh import plan_from_spec as jax_plan_from_spec
from ctagan_tpu.train import replay_buffer as jax_rb
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.__main__ import dp_ranks
from ctagan_tpu_torch.models import Discriminator, Generator, RegNet
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
    regnet_state_dict,
)
from ctagan_tpu_torch.models.volumetric import Discriminator3D, Generator3D
from ctagan_tpu_torch.parallel import tensor
from ctagan_tpu_torch.parallel.mesh import plan_from_spec
from ctagan_tpu_torch.train.trainers import P2pTrainer
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_dp import (
    CHILD_ENV,
    HD_CFG,
    JAX_TOL,
    LR_D,
    MOMENT_FLOOR,
    PORT_TOL,
    _hd_batch,
    _rel,
    _reg_nets,
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

TP2, HYBRID = (1, 2), (2, 2)
FWD_G = dict(n_residual_blocks=3, base_features=16)
FWD_SIZE = 64
CKPT_SIZE = 32
CONVERT = {"g": generator_state_dict, "r": regnet_state_dict,
           "d": discriminator_state_dict}
CYC_CFG = {"Adv_lamda": 1.0, "Cyc_lamda": 10.0, "noise_level": 0,
           "aligned_aug": False, "grad_accum": 1}

# one rank's work: the cases under their plan, the pair's gradcheck, the
# sharded forward, the checkpoint drill; run by the children and, without
# a group and without a plan, by the test process
_RANK = r'''
import copy
import hashlib
import sys

import numpy as np
import torch

from ctagan_tpu_torch.parallel import dist, tensor
from ctagan_tpu_torch.parallel.mesh import shard_rows
from ctagan_tpu_torch.train import steps


def _rest(state):
    """Per net (in ``_nets`` order): its parameters' elements as held, and
    its optimizer's moment elements."""
    out = []
    for opt, net in tensor._nets(state):
        held = sum(p.numel() for p in net.parameters())
        moments = 0 if opt is None else sum(
            v.numel() for p in net.parameters()
            for k, v in opt.state.get(p, {}).items()
            if k.startswith("exp_avg"))
        out.append((held, moments))
    return out


def run_case(case, plan=None):
    """The case's steps on this rank's rows of its global batch (every row
    without a group), on copies of its nets; with ``plan`` = (dp, tp) the
    state split first. Returns the weights (nets, then EMAs) and Adam's
    first moments by name in the one-process layout, each step's losses,
    and with ``plan`` whether the state was split and the resting state
    (bytes, :func:`_rest`) after the steps."""
    nets = copy.deepcopy(case["nets"])
    state = getattr(steps, case["init"])(*nets, **case["init_kw"])
    out = {}
    dp, tp = plan if plan is not None else (dist.world(), 1)
    if plan is not None:
        tensor.shard_state_tp(state, tensor.make_tp_mesh(dp, tp))
    n = len(next(iter(case["batch"].values())))
    rows = shard_rows(n, dist.rank() // tp, dp)
    batch = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    step = getattr(steps, case["step"])
    losses = [{k: float(v) for k, v in step(
        state, case["cfg"], batch, case["lr"], **case["step_kw"]).items()}
        for _ in range(case["steps"])]
    if plan is not None:
        out.update(split=tensor.is_sharded(state), rest=_rest(state),
                   bytes=tensor.state_bytes_per_rank(state))
    with tensor.unsharded_state(state):
        emas = [getattr(state, e) for e in state.EMA_NETS
                if getattr(state, e) is not None]
        mu = {p: opt.state[p]["exp_avg"] for opt in vars(state).values()
              if isinstance(opt, torch.optim.Adam) for p in opt.state}
        out.update(
            weights=[{k: v.detach().clone() for k, v in m.state_dict().items()}
                     for m in nets + emas],
            moments=[{k: mu[p].clone() for k, p in m.named_parameters()}
                     for m in nets],
            losses=losses)
    return out


def gradcheck_pair():
    """``reduce_from_tp(tanh(copy_to_tp(x) @ W_r))``, x replicated and W_r
    this rank's: gradcheck, and the forward against the sum over every
    rank's W_r computed here."""
    x = torch.rand(3, 4, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    ws = [torch.rand(4, 5, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1 + r))
          for r in range(dist.world())]
    group = tensor.make_tp_mesh(1, dist.world()).group

    def fn(x):
        return tensor.reduce_from_tp(
            torch.tanh(tensor.copy_to_tp(x, group) @ ws[dist.rank()]), group)

    want = sum(torch.tanh(x @ w) for w in ws)
    return (torch.autograd.gradcheck(fn, (x.requires_grad_(),)),
            float((fn(x) - want).abs().max()))


def forward(spec):
    """``infer_tensor_sharded`` of ``spec["g"]`` on ``spec["x"]`` over this
    world's (dp, tp) = ``spec["plan"]``."""
    mesh = tensor.make_tp_mesh(*spec["plan"])
    return tensor.infer_tensor_sharded(
        spec["g"], torch.from_numpy(spec["x"]), mesh,
        data_parallel=spec["plan"][0] > 1).numpy()


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
    """(g): a P2p trainer under ``{tp: 2}``: a step of the batch, a save
    (rank 0 writes), its state; then a trainer under ``{dp: 2}`` that
    resumes that ``.pt``, its state. Each state as its :func:`digest`."""
    from ctagan_tpu_torch.train.trainers import P2pTrainer
    from ctagan_tpu_torch.utils.config import load_config

    t = P2pTrainer(load_config(dict(spec["cfg"], mesh={"tp": 2})),
                   torch.device("cpu"), quiet=True)
    t._step({k: torch.from_numpy(v) for k, v in spec["batch"].items()},
            t.lr, t.lr_d)
    out = {"split": tensor.is_sharded(t.state), "path": t._save(1),
           "tp": digest(t._checkpoint_state())}
    d = P2pTrainer(load_config(dict(spec["cfg"], mesh={"dp": 2},
                                    resume=True)),
                   torch.device("cpu"), quiet=True)
    out.update(dp_epoch=d.start_epoch, dp=digest(d._checkpoint_state()))
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    todo = torch.load(sys.argv[1], weights_only=False)
    dist.init(torch.device("cpu"))
    try:
        out = {name: run_case(case, todo["plan"])
               for name, case in todo["cases"].items()}
        if "forward" in todo:
            out["forward"] = forward(dict(todo["forward"],
                                          plan=todo["plan"]))
        if "ckpt" in todo:
            out["gradcheck"] = gradcheck_pair()
            out["ckpt"] = run_ckpt(todo["ckpt"])
        torch.save(out, f"{sys.argv[2]}.{dist.rank()}")
    finally:
        dist.shutdown()
'''
_ns = {"__name__": "tp_rank"}
exec(compile(_RANK, "tp_rank", "exec"), _ns)
run_case, digest = _ns["run_case"], _ns["digest"]


# -- (a) the plan ---------------------------------------------------------------

@pytest.mark.parametrize("spec,world", [({"tp": 2}, 2), ({"tp": 4}, 4),
                                        ({"dp": 2, "tp": 2}, 4)], ids=str)
def test_tp_plan_is_jaxs(spec, world):
    want = jax_plan_from_spec(spec, jax.devices()[:world])
    got = plan_from_spec(spec, world)
    axes = dict(zip(want.mesh.axis_names, want.mesh.devices.shape))
    assert (got.kind, got.batch_scale) == (want.kind, want.batch_scale)
    assert got.describe().startswith(
        f"mesh plan: {axes} (kind=tp, batch x{want.batch_scale}); ")
    assert (got.dp, got.tp) == (spec.get("dp", 1), spec["tp"])
    assert [got.batch_rank(r) for r in range(world)] == [
        r // spec["tp"] for r in range(world)]
    with pytest.raises(ValueError, match=f"process group has {world + 1}"):
        plan_from_spec(spec, world + 1)


def test_train_starts_dp_times_tp_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    for mesh, n in (({"tp": 2}, 2), ({"tp": 4}, 4), ({"dp": 2, "tp": 2}, 4)):
        assert dp_ranks(load_config({"mesh": mesh}), cuda, None) == n
    with pytest.raises(SystemExit, match="needs 8 devices, have 4"):
        dp_ranks(load_config({"mesh": {"dp": 2, "tp": 4}}), cuda, None)


# -- (b) the rules ----------------------------------------------------------------

def _marked(tree, specs):
    """Each leaf as an array of its shape that counts along the axis its
    spec shards (0 where it is replicated)."""
    def mark(leaf, spec):
        leaf = np.asarray(leaf)
        out = np.zeros(leaf.shape)
        if jax_tensor.MODEL_AXIS in tuple(spec):
            ax = tuple(spec).index(jax_tensor.MODEL_AXIS)
            shape = [1] * leaf.ndim
            shape[ax] = leaf.shape[ax]
            out = out + np.arange(leaf.shape[ax]).reshape(shape)
        return out
    return jax.tree.map(mark, tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


def _port_dim(t):
    """The axis along which a converted marker counts, or None."""
    a = t.numpy()
    for ax in range(a.ndim):
        if a.shape[ax] > 1 and not np.all(np.diff(a, axis=ax) == 0):
            return ax
    return None


@pytest.mark.parametrize("net", ["g", "g9", "r"])
def test_rules_are_jaxs_leaf_for_leaf(net):
    port = {"g": lambda: small_g(0), "g9": lambda: Generator(1, 1),
            "r": RegNet}[net]()
    tree = jax_tree(port)
    specs = (jax_tensor.reg_param_specs if net == "r"
             else jax_tensor.tp_param_specs)(tree)
    convert = regnet_state_dict if net == "r" else generator_state_dict
    want = {k: _port_dim(v) for k, v in convert(_marked(tree, specs)).items()}
    rules = (tensor.reg_param_rules if net == "r"
             else tensor.tp_param_rules)(port)
    dims = {tensor.COLUMN: 0, tensor.ROW: 1, tensor.REPLICATED: None}
    assert set(rules) == set(want)
    assert {k: dims[r] for k, r in rules.items()} == want
    split = sum(v.numel() for k, v in port.state_dict().items()
                if rules[k] != tensor.REPLICATED)
    if net == "g9":  # the full-width G: 9 blocks of 2 × 589,824 + 256
        assert split == 10_619_136
    assert split > 0
    # the split module keeps its state-dict keys
    split_net = tensor.shard_module_tp(copy.deepcopy(port),
                                       tensor.TpMesh(1, 0, None))
    assert list(split_net.state_dict()) == list(port.state_dict())


def test_3d_generator_and_d_have_nothing_to_split():
    for m in (Generator3D(1, 1, n_residual_blocks=2, base_features=8),
              Discriminator(2)):
        assert set(tensor.tp_param_rules(m).values()) == {tensor.REPLICATED}
        assert not any(isinstance(b, tensor.TpResidualBlock)
                       for b in tensor.shard_module_tp(
                           m, tensor.TpMesh(2, 0, None)).modules())


# -- the runs -----------------------------------------------------------------------

def _jax_cases():
    """P2p, HD stage 1 and CycleGAN, one step each without augmentation,
    as JAX's tp steps take them (JAX draws from its own key)."""
    cyc_nets = [small_g(0).double(), small_g(1).double(),
                Discriminator().reset_parameters(2).double(),
                Discriminator().reset_parameters(3).double()]
    return {
        "p2p": dict(nets=[small_g(0).double(),
                          Discriminator(2).reset_parameters(1).double()],
                    init="init_p2p_state", init_kw={}, step="p2p_train_step",
                    cfg=dict(CFG, grad_accum=1), batch=pair_batch(2, 64),
                    lr=LR, steps=1, step_kw={}),
        "hd1": dict(nets=_reg_nets(), init="init_reg_state", init_kw={},
                    step="reg_train_step", cfg=HD_CFG, batch=_hd_batch(1),
                    lr=LR, steps=1,
                    step_kw={"lr_d": LR_D, "dual_window_mode": True}),
        "cyc": dict(nets=cyc_nets, init="init_cyc_state",
                    init_kw={"size": 64, "buffer_size": 2},
                    step="cyc_train_step", cfg=CYC_CFG,
                    batch=pair_batch(2, 64), lr=LR, steps=1, step_kw={}),
    }


def _aug_cases():
    """With augmentation: P2p with its EMA over two steps, CycleGAN at
    ``grad_accum: 2`` and P3d (nothing to split)."""
    fam = {"noise_level": 1, "aligned_aug": False, "grad_accum": 1}
    pairs = pair_batch(2, 64)
    return {
        "p2p_aug": dict(nets=[small_g(0).double(),
                              Discriminator(2).reset_parameters(1).double()],
                        init="init_p2p_state", init_kw={"ema": True},
                        step="p2p_train_step",
                        cfg=dict(fam, P2P_lamda=100.0, Adv_lamda=1.0),
                        batch=pairs, lr=LR, steps=2, step_kw={}),
        "cyc_aug": dict(nets=[small_g(0).double(), small_g(1).double(),
                              Discriminator().reset_parameters(2).double(),
                              Discriminator().reset_parameters(3).double()],
                        init="init_cyc_state",
                        init_kw={"size": 64, "buffer_size": 2, "ema": True},
                        step="cyc_train_step",
                        cfg=dict(CYC_CFG, noise_level=1, grad_accum=2),
                        batch=pair_batch(4, 64), lr=LR, steps=1, step_kw={}),
        "p3d": dict(nets=[Generator3D(1, 1, n_residual_blocks=1,
                                      base_features=8).reset_parameters(
                                          0).double(),
                          Discriminator3D(2).reset_parameters(1).double()],
                    init="init_p3d_state", init_kw={}, step="p3d_train_step",
                    cfg=dict(fam, P2P_lamda=100.0, Adv_lamda=1.0),
                    batch={k: np.stack([v[:, :32, :32]] * 4, axis=1)
                           for k, v in pairs.items()},
                    lr=LR, steps=1, step_kw={}),
    }


def _hybrid_case():
    """P2p with augmentation and its EMA on a global batch of 2: one row a
    dp column of ``{dp: 2, tp: 2}``."""
    return _aug_cases()["p2p_aug"]


def _fwd_g():
    return Generator(1, 1, fused_body=False, **FWD_G).reset_parameters(
        3).double()


def _fwd_x(n):
    return np.random.default_rng(4).uniform(
        -1, 1, (n, FWD_SIZE, FWD_SIZE, 1))


def _jax_tp_state(state_cls, trees, mesh, *extra):
    """A JAX family state of the float64 ``trees`` (nets, then their Adam
    states' nets), split by ``shard_state_tp``."""
    tx = jax_steps.make_optimizer()
    *nets, opts = trees
    return jax_tensor.shard_state_tp(state_cls(
        *nets, *(tx.init(o) for o in opts), *extra,
        jax.random.PRNGKey(0)), mesh), tx


def _jax_step(name, case):
    """JAX's ``shard_state_tp`` + jitted step of ``case`` on a ``{tp: 2}``
    mesh of conftest's virtual devices, in float64, from the case's
    weights: (new state, losses)."""
    mesh = jax_tensor.make_tp_mesh(n=2)
    rep = NamedSharding(mesh, P())
    jg, jd = jax_small_g(), JaxDiscriminator(2 if name == "p2p" else 1)
    jax.config.update("jax_enable_x64", True)
    try:
        trees = [f64(jax_tree(m)) for m in case["nets"]]
        kw = {}
        if name == "p2p":
            state, tx = _jax_tp_state(jax_steps.P2pState,
                                      trees + [trees], mesh)
            fn = partial(jax_steps.p2p_train_step, jg, jd,
                         jax_steps.make_optimizer(), case["cfg"])
        elif name == "hd1":
            state, tx = _jax_tp_state(jax_steps.RegState, trees + [trees],
                                      mesh)
            fn = partial(jax_steps.reg_train_step, jg, JaxRegNet(), jd, tx,
                         case["cfg"], dual_window_mode=True)
            kw = {"lr_d": jnp.float64(LR_D)}
        else:
            ga, gb, da, db = trees
            pools = [jax_rb.ReplayBuffer.create(2, (64, 64, 1), np.float64)
                     for _ in range(2)]
            state, tx = _jax_tp_state(jax_steps.CycState,
                                      [ga, gb, da, db, [(ga, gb), da, db]],
                                      mesh, *pools)
            fn = partial(jax_steps.cyc_train_step, jg, jd, tx, case["cfg"])
        batch = {k: jax.device_put(jnp.asarray(v), rep)
                 for k, v in case["batch"].items()}
        return jax.device_get(jax.jit(fn)(state, batch, jnp.float64(LR),
                                          **kw))
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_forwards():
    """JAX's ``infer_tensor_sharded`` of the forward G on ``{tp: 2}`` and
    on ``{dp: 2, tp: 2}`` (the batch split over ``data``), float64."""
    g = _fwd_g()
    jax.config.update("jax_enable_x64", True)
    try:
        params = f64(jax_tree(g))
        jg = JaxGenerator(1, 1, **FWD_G)
        return {plan: np.asarray(jax.device_get(jax_tensor.infer_tensor_sharded(
            jg, params, _fwd_x(2 * plan[0]), mesh=mesh,
            data_parallel=plan[0] > 1)))
            for plan, mesh in ((TP2, jax_tensor.make_tp_mesh(n=2)),
                               (HYBRID, jax_tensor.make_dp_tp_mesh(2, 2)))}
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_child(out, names):
    """A child's JAX work: the tp steps of ``names`` and with "forward" the
    forwards, pickled to ``out``."""
    cases = _jax_cases()
    res = {name: (_jax_forwards() if name == "forward"
                  else _jax_step(name, cases[name])) for name in names}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _ckpt_cfg(root):
    return _p2p_cfg(root, "unused.txt", size=CKPT_SIZE)


def _launch(tmp, name, n, todo):
    """The rank script over ``n`` gloo ranks (``n`` None: one process
    without a group) on ``todo``; each rank's results in
    ``tmp``/<name>.<rank>."""
    torch.save(todo, tmp / f"{name}.pt")
    return subprocess.Popen(
        ([sys.executable] if n is None else _torchrun(n))
        + [str(tmp / "rank.py"), str(tmp / f"{name}.pt"), str(tmp / name)],
        env=dict(os.environ, **CHILD_ENV))


def _jax_launch(tmp, names):
    return subprocess.Popen(
        [sys.executable, "-c", "from tests.test_torch_port_tp import "
         f"_jax_child; _jax_child({str(tmp / names[0])!r}, {names!r})"],
        env=dict(os.environ, **CHILD_ENV,
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Two ranks under ``{tp: 2}`` (every case, the forward, the gradcheck,
    the checkpoint drill), four under ``{dp: 2, tp: 2}`` (P2p, the
    forward), one process on each case's global batch, and two JAX
    children (P2p's tp step and the forwards; CycleGAN's tp step), all
    started first; JAX's HD tp step here meanwhile."""
    tmp = tmp_path_factory.mktemp("tp")
    (tmp / "rank.py").write_text(_RANK)
    jax_cases, aug, hybrid = _jax_cases(), _aug_cases(), _hybrid_case()
    fwd = {"g": _fwd_g()}
    ckpt_root = tmp / "ckpt"
    ckpt_batch = {k: v.astype(np.float32)
                  for k, v in pair_batch(2, CKPT_SIZE).items()}
    procs = [
        _launch(tmp, "w2", 2, {
            "plan": TP2, "cases": dict(jax_cases, **aug),
            "forward": dict(fwd, x=_fwd_x(2)),
            "ckpt": {"cfg": _ckpt_cfg(ckpt_root), "batch": ckpt_batch}}),
        _launch(tmp, "w4", 4, {"plan": HYBRID, "cases": {"p2p": hybrid},
                               "forward": dict(fwd, x=_fwd_x(4))}),
        _launch(tmp, "one", None, {"plan": None, "cases": dict(
            jax_cases, hybrid=hybrid, **aug)}),
        _jax_launch(tmp, ["p2p", "forward"]), _jax_launch(tmp, ["cyc"])]
    try:
        jax_hd = _jax_step("hd1", jax_cases["hd1"])
        for p in procs:
            assert p.wait(timeout=900) == 0
    finally:
        for p in procs:
            p.kill()
    jax_res = {"hd1": jax_hd}
    for name in ("p2p", "cyc"):
        with open(tmp / name, "rb") as f:
            jax_res.update(pickle.load(f))
    w2, w4 = ([torch.load(f"{tmp / w}.{r}", weights_only=False)
               for r in range(n)] for w, n in (("w2", 2), ("w4", 4)))
    one = torch.load(f"{tmp / 'one'}.0", weights_only=False)
    with torch.no_grad():
        one["forward"] = {n: fwd["g"](torch.from_numpy(_fwd_x(n))).numpy()
                          for n in (2, 4)}
    pt = w2[0]["ckpt"]["path"]
    back = P2pTrainer(load_config(dict(_ckpt_cfg(ckpt_root), resume=True)),
                      torch.device("cpu"), quiet=True)
    yield {"w2": w2, "w4": w4, "one": one, "jax": jax_res, "pt": pt,
           "world1": (back.start_epoch, digest(back._checkpoint_state())),
           "cases": dict(jax_cases, **aug)}
    shutil.rmtree(tmp, ignore_errors=True)


# -- (c) the pair -----------------------------------------------------------------

def test_copy_and_reduce_pass_gradcheck_on_two_ranks(tp_runs):
    for rank in tp_runs["w2"]:
        ok, err = rank["gradcheck"]
        assert ok and err <= 1e-15


# -- (d) the sharded forward --------------------------------------------------------

@pytest.mark.parametrize("plan", [TP2, HYBRID], ids=["tp2", "dp2_tp2"])
def test_sharded_forward_matches_jax(tp_runs, plan):
    world, n = ("w2", 2) if plan == TP2 else ("w4", 4)
    want = tp_runs["jax"]["forward"][plan]
    for rank in tp_runs[world]:
        got = rank["forward"]
        assert got.shape == want.shape == (n, FWD_SIZE, FWD_SIZE, 1)
        assert np.abs(got - want).max() <= 1e-6
        assert np.abs(got - tp_runs["one"]["forward"][n]).max() <= PORT_TOL
        assert np.array_equal(got, tp_runs[world][0]["forward"])


# -- (e) the steps --------------------------------------------------------------------

@pytest.mark.parametrize("name,net", [
    ("p2p", "g"), ("p2p", "d"), ("hd1", "g"), ("hd1", "r"), ("hd1", "d"),
    ("cyc", "g_a2b"), ("cyc", "g_b2a"), ("cyc", "d_a"), ("cyc", "d_b")])
def test_tp_step_matches_jax_tp_step(tp_runs, name, net):
    new, want_losses = tp_runs["jax"][name]
    fields = {"g": ("g_params", "g_opt", 0), "r": ("r_params", "r_opt", 1),
              "d": ("d_params", "d_opt", -1),
              "g_a2b": ("g_a2b_params", "g_opt", 0),
              "g_b2a": ("g_b2a_params", "g_opt", 1),
              "d_a": ("d_a_params", "d_a_opt", 2),
              "d_b": ("d_b_params", "d_b_opt", 3)}
    params, opt, i = fields[net]
    mu = getattr(new, opt).mu
    if name == "cyc" and opt == "g_opt":
        mu = mu[i]
    convert = CONVERT[net[0]]
    for rank in tp_runs["w2"]:
        got = rank[name]
        for k, v in want_losses.items():
            np.testing.assert_allclose(got["losses"][0][k], float(v),
                                       rtol=1e-9, atol=1e-15, err_msg=k)
        for tree, have in ((getattr(new, params), got["weights"][i]),
                           (mu, got["moments"][i])):
            want = {k: v.numpy() for k, v in convert(tree).items()}
            floor = MOMENT_FLOOR * max(np.linalg.norm(w)
                                       for w in want.values())
            for k, w in want.items():
                assert _rel(have[k].numpy(), w, floor) <= JAX_TOL, (k, net)


@pytest.mark.parametrize("case", ["p2p", "hd1", "cyc", "p2p_aug",
                                  "cyc_aug", "p3d", "hybrid"])
def test_tp_step_matches_one_process(tp_runs, case):
    ranks, name = ((tp_runs["w4"], "p2p") if case == "hybrid"
                   else (tp_runs["w2"], case))
    for rank in ranks:
        _held(rank[name], tp_runs["one"][case], PORT_TOL)
        assert rank[name]["split"] == (case != "p3d")
    # the weights every rank holds whole (after the gather: all of them)
    # are bit-identical across the ranks
    for rank in ranks[1:]:
        for wa, wb in zip(rank[name]["weights"], ranks[0][name]["weights"]):
            assert all(torch.equal(wa[k], wb[k]) for k in wa)
        assert rank[name]["losses"] == ranks[0][name]["losses"]


# -- (f) the resting state ----------------------------------------------------------

@pytest.mark.parametrize("case", ["p2p_aug", "hd1", "cyc_aug", "p3d"])
def test_rank_holds_its_slices(tp_runs, case):
    """Each net holds its replicated parameters whole and 1/2 of its split
    ones, by the rules; Adam's two moments alike; the EMA as its net."""
    c = tp_runs["cases"][case]
    state = getattr(_ns["steps"], c["init"])(*copy.deepcopy(c["nets"]),
                                              **c["init_kw"])
    want, total = [], 0
    for opt, net in tensor._nets(state):
        split = {k for rules in (tensor.tp_param_rules(net),
                                 tensor.reg_param_rules(net))
                 for k, r in rules.items() if r != tensor.REPLICATED}
        held = sum(v.numel() // (2 if k in split else 1)
                   for k, v in net.state_dict().items())
        want.append((held, 0 if opt is None else 2 * held))
        total += 8 * sum(want[-1])
    for rank in tp_runs["w2"]:
        assert rank[case]["rest"] == want
        assert rank[case]["bytes"] == total
    if case == "hd1":  # G and R both split, D whole
        assert [w[0] < sum(p.numel() for p in n.parameters()) for w, n in
                zip(want, c["nets"])] == [True, True, False]


# -- (g) checkpoints ----------------------------------------------------------------

def test_pt_written_under_tp_resumes_at_world_1_and_under_dp2(tp_runs):
    ranks = [r["ckpt"] for r in tp_runs["w2"]]
    assert all(r["split"] for r in ranks)
    assert ranks[0]["path"] and ranks[1]["path"] is None  # rank 0 wrote it
    assert tp_runs["pt"].endswith(".pt") and "_e1" in tp_runs["pt"]
    for r in ranks:
        _same(r["tp"], ranks[0]["tp"])
        assert r["dp_epoch"] == 1
        _same(r["dp"], ranks[0]["tp"])
    start_epoch, state = tp_runs["world1"]
    assert start_epoch == 1
    _same(state, ranks[0]["tp"])
    # the one-process layout: G's body convs whole
    w = state["g"]["model_body.0.conv_block.1.weight"]
    assert w[1] == (256, 256, 3, 3)
