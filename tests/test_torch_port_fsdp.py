"""The port's fsdp plan (``parallel/fsdp.py``, ``parallel/mesh.py``,
``parallel/dist.py``) on the CPU, in float64, with gloo ranks in child
processes that ``torchrun`` starts (the launch and the family cases of
``tests/test_torch_port_dp.py``).

- (a) ``plan_from_spec``: ``{fsdp: 2}`` at world 2 and ``{dp: 2, fsdp: 2}``
  at world 4 give JAX's kind, ``batch_scale`` and printed line; a world
  other than dp × fsdp raises; ``--mode train`` starts dp × fsdp ranks.
- (b) Two fsdp ranks, one P2p step (G of 2 blocks at base 16, 64²,
  ``noise_level: 0``, a global batch of 2): G, D and Adam's first moments
  within 1e-6 of JAX's ``fsdp_train_step_fn`` on a ``{fsdp: 2}`` mesh of
  conftest's virtual devices, from the same converted weights.
- (c) P2p (with its EMA, two steps), HD stage 1, RegGAN, CycleGAN
  (``grad_accum: 2``) and P3d under ``{fsdp: 2}``, each against dp at
  world 2 in the same ranks and against one process on the global batch,
  within 1e-12; HD stage 1 under ``{dp: 2, fsdp: 2}`` on four ranks
  against dp at world 4 and one process.
- (d) Each rank's resting state below total / N × 1.10 (JAX's bound), the
  modules without parameter storage and the Adam moments of the shard's
  size, after sharding and after every step.
- (e) A P2p trainer's ``.pt`` written by one process resumes under
  ``{fsdp: 2}`` sharded and bit-equal; the ``.pt`` the ranks write after a
  step (rank 0 alone) resumes at world 1 bit-equal to the ranks' state; a
  JAX ``.ckpt`` resumes under ``{fsdp: 2}`` as at world 1.
- (f) ``python -m ctagan_tpu_torch --mode train_test --device cpu`` on a
  P2p config at 32² with ``mesh: {fsdp: 2}`` as two ranks: its loss and
  val CSV rows, test()'s metrics and its SE2 tree equal one process's at
  ``batchSize`` 2, ``grad_accum`` 2 and ``eval_batch`` 1 on one thread (the
  ranks' per-slice work, their sums split alike).
"""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.parallel.fsdp import (
    batch_sharding_fsdp,
    fsdp_train_step_fn,
    make_fsdp_mesh as jax_fsdp_mesh,
    shard_p2p_state_fsdp,
)
from ctagan_tpu.parallel.mesh import plan_from_spec as jax_plan_from_spec
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu.utils import checkpoint as jax_ckpt
from ctagan_tpu_torch.__main__ import dp_ranks
from ctagan_tpu_torch.models import Discriminator, Generator
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
)
from ctagan_tpu_torch.parallel import fsdp
from ctagan_tpu_torch.parallel.mesh import plan_from_spec
from ctagan_tpu_torch.train.trainers import P2pTrainer
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_dp import (
    CHILD_ENV,
    JAX_TOL,
    MOMENT_FLOOR,
    PORT_TOL,
    _cases,
    _csv_rows,
    _hd_batch,
    _rel,
    _reg_nets,
    _se2_tree,
)
from tests.test_torch_port_p2p import (
    CFG,
    LR,
    _corpus,
    _p2p_cfg,
    _yaml,
    f64,
    jax_small_g,
    jax_tree,
    pair_batch,
    small_g,
)

torch.set_num_threads(2)


def _torchrun(n):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}"]


# one rank's work: each case under the dp layout and with the state
# sharded; the checkpoint drill; run by the children and, without a group,
# by the test process
_RANK = r'''
import copy
import hashlib
import sys

import numpy as np
import torch

from ctagan_tpu_torch.parallel import dist, fsdp
from ctagan_tpu_torch.parallel.mesh import shard_rows
from ctagan_tpu_torch.train import steps


def _rest(state):
    """The resting state's shape: each net's module parameters' elements
    (0 when sharded), and each sharded net's (shard, Adam moments,
    padded) elements; the EMAs' module elements."""
    nets, shards = [], []
    for name, names in state.OPT_NETS.items():
        opt = getattr(state, name)
        for n in names:
            m = getattr(state, n)
            nets.append(sum(p.numel() for p in m.parameters()))
            flat = fsdp.flat_of(m)
            if flat is not None:
                st = opt.state.get(flat.shard, {})
                shards.append((flat.shard.numel(),
                               [v.numel() for k, v in sorted(st.items())
                                if k.startswith("exp_avg")],
                               flat.padded))
    emas = [sum(p.numel() for p in getattr(state, e).parameters())
            for e in state.EMA_NETS if getattr(state, e) is not None]
    return {"nets": nets, "shards": shards, "emas": emas}


def run_case(case, plan=None):
    """The case's steps on this rank's rows of its global batch (every row
    without a group), on copies of its nets; with ``plan`` = (dp, fsdp) the
    state sharded first. Returns the weights (nets, then EMAs) and Adam's
    first moments by name in the one-process layout, each step's losses,
    the unsharded state's bytes after them, and with ``plan`` the resting
    state's bytes and shape after sharding and after each step."""
    nets = copy.deepcopy(case["nets"])
    state = getattr(steps, case["init"])(*nets, **case["init_kw"])
    out = {}
    if plan is not None:
        fsdp.shard_state_fsdp(state, fsdp.make_fsdp_mesh(*plan))
        out["bytes"], out["rest"] = [fsdp.state_bytes_per_rank(state)], [
            _rest(state)]
    n = len(next(iter(case["batch"].values())))
    rows = shard_rows(n, dist.rank(), dist.world())
    batch = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    step = getattr(steps, case["step"])
    losses = []
    for _ in range(case["steps"]):
        losses.append({k: float(v) for k, v in step(
            state, case["cfg"], batch, case["lr"], **case["step_kw"]
        ).items()})
        if plan is not None:
            out["bytes"].append(fsdp.state_bytes_per_rank(state))
            out["rest"].append(_rest(state))
    with fsdp.unsharded_state(state):
        out["total"] = fsdp.state_bytes_per_rank(state)
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
    """(e): a P2p trainer under ``{fsdp: 2}`` resumes the newest ``.pt`` of
    its ``save_root``; its state then, one step of the global batch, a save
    (rank 0 writes), its state after; then one that resumes the JAX
    ``.ckpt`` of ``spec["jax_cfg"]``'s ``save_root``, its state. Each
    state as its :func:`digest`."""
    from ctagan_tpu_torch.train.trainers import P2pTrainer
    from ctagan_tpu_torch.utils.config import load_config

    t = P2pTrainer(load_config(spec["cfg"]), torch.device("cpu"), quiet=True)
    out = {"start_epoch": t.start_epoch, "sharded": fsdp.is_sharded(t.state),
           "g_elements": sum(p.numel() for p in t.g_model.parameters()),
           "resumed": digest(t._checkpoint_state())}
    n = len(spec["batch"]["A"])
    rows = shard_rows(n, dist.rank(), dist.world())
    t._step({k: torch.from_numpy(v[rows]) for k, v in spec["batch"].items()},
            t.lr, t.lr_d)
    out["path"] = t._save(2)
    out.update(after=digest(t._checkpoint_state()),
               sharded_after=fsdp.is_sharded(t.state))
    j = P2pTrainer(load_config(spec["jax_cfg"]), torch.device("cpu"),
                   quiet=True)
    out["jax"] = {"start_epoch": j.start_epoch,
                  "sharded": fsdp.is_sharded(j.state),
                  "state": digest(j._checkpoint_state())}
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    todo = torch.load(sys.argv[1], weights_only=False)
    dist.init(torch.device("cpu"))
    try:
        out = {name: {str(plan): run_case(case, plan)
                      for plan in todo["plans"]}
               for name, case in todo["cases"].items()}
        if "ckpt" in todo:
            out["ckpt"] = run_ckpt(todo["ckpt"])
        torch.save(out, f"{sys.argv[2]}.{dist.rank()}")
    finally:
        dist.shutdown()
'''
_ns = {"__name__": "fsdp_rank"}
exec(compile(_RANK, "fsdp_rank", "exec"), _ns)
run_case, digest = _ns["run_case"], _ns["digest"]

FSDP2, HYBRID = (1, 2), (2, 2)
CASES = ["hd1", "reg", "p2p", "cyc", "p3d"]
CKPT_SIZE = 32


# -- (a) the plan ---------------------------------------------------------------

@pytest.mark.parametrize("spec,world", [({"fsdp": 2}, 2),
                                        ({"dp": 2, "fsdp": 2}, 4)], ids=str)
def test_fsdp_plan_is_jaxs(spec, world):
    want = jax_plan_from_spec(spec, jax.devices()[:world])
    got = plan_from_spec(spec, world)
    axes = dict(zip(want.mesh.axis_names, want.mesh.devices.shape))
    assert (got.kind, got.batch_scale) == (want.kind, want.batch_scale)
    assert got.describe() == (f"mesh plan: {axes} (kind={want.kind}, "
                              f"batch x{want.batch_scale})")
    assert (got.dp, got.fsdp) == (spec.get("dp", 1), spec["fsdp"])
    with pytest.raises(ValueError, match=f"needs {world} devices"):
        plan_from_spec(spec, world - 1)
    with pytest.raises(ValueError, match=f"process group has {world + 1}"):
        plan_from_spec(spec, world + 1)


def test_train_starts_dp_times_fsdp_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    for mesh, n in (({"fsdp": 2}, 2), ({"fsdp": 4}, 4),
                    ({"dp": 2, "fsdp": 2}, 4)):
        assert dp_ranks(load_config({"mesh": mesh}), cuda, None) == n
    with pytest.raises(SystemExit, match="needs 8 devices, have 4"):
        dp_ranks(load_config({"mesh": {"dp": 2, "fsdp": 4}}), cuda, None)


# -- the ranks ------------------------------------------------------------------

def _jax_case():
    """(b)'s P2p step: JAX's weights, converted, and no augmentation."""
    return dict(nets=[small_g(0).double(),
                      Discriminator(2).reset_parameters(1).double()],
                init="init_p2p_state", init_kw={}, step="p2p_train_step",
                cfg=dict(CFG, grad_accum=1), batch=pair_batch(2, 64), lr=LR,
                steps=1, step_kw={})


def _jax_fsdp_step(case):
    """JAX's ``fsdp_train_step_fn`` on a ``{fsdp: 2}`` mesh, in float64,
    from the case's weights."""
    g, d = case["nets"]
    jg, jd = jax_small_g(), JaxDiscriminator(2)
    tx = jax_steps.make_optimizer()
    mesh = jax_fsdp_mesh(n=2)
    jax.config.update("jax_enable_x64", True)
    try:
        gp, dp = f64(jax_tree(g)), f64(jax_tree(d))
        state = shard_p2p_state_fsdp(jax_steps.P2pState(
            gp, dp, tx.init(gp), tx.init(dp), jax.random.PRNGKey(0)), mesh)
        bsh = batch_sharding_fsdp(mesh)
        batch = {k: jax.device_put(v, bsh) for k, v in case["batch"].items()}
        fn = fsdp_train_step_fn(jg, jd, tx, case["cfg"])
        return jax.device_get(fn(state, batch, jnp.float64(LR)))
    finally:
        jax.config.update("jax_enable_x64", False)


def _world2_cases():
    cases = _cases()
    # the EMA sharded too, and the state held sharded over a second step
    cases["p2p"].update(init_kw={"ema": True}, steps=2)
    return cases


def _hybrid_case():
    hd = _cases()["hd1"]
    hd.update(nets=_reg_nets(), batch=_hd_batch(4))
    return hd


def _ckpt_cfg(root):
    return _p2p_cfg(root, "unused.txt", size=CKPT_SIZE, resume=True)


def _ckpt_batch():
    return {k: v.astype(np.float32)
            for k, v in pair_batch(2, CKPT_SIZE).items()}


def _write_world1_pt(root):
    """One process's P2p trainer after a step, saved as epoch 1; returns its
    checkpoint state."""
    t = P2pTrainer(load_config(dict(_ckpt_cfg(root), resume=False)),
                   torch.device("cpu"), quiet=True)
    t._step({k: torch.from_numpy(v) for k, v in _ckpt_batch().items()},
            t.lr, t.lr_d)
    t._save(1)
    return t._checkpoint_state()


def _write_jax_ckpt(root):
    """A JAX P2p state of the trainer's full-size nets (the port's seeded
    weights, converted), Adam after 3 counts with moments of its own, as
    epoch 1 of a ``.ckpt``."""
    g = jax_tree(Generator(1, 1).reset_parameters(5))
    d = jax_tree(Discriminator(2).reset_parameters(6))
    tx = jax_steps.make_optimizer()

    def adam(tree):
        return tx.init(tree)._replace(
            count=jnp.asarray(3, jnp.int32),
            mu=jax.tree.map(lambda x: 0.1 * x, tree),
            nu=jax.tree.map(lambda x: x * x, tree))

    state = jax_steps.P2pState(g, d, adam(g), adam(d), jax.random.PRNGKey(0))
    jax_ckpt.save_checkpoint(f"{root}/model", "P2p_p2p", 1, {
        "state": jax.device_get(state), "epoch": 1, "lr": LR, "lr_d": LR})


def _launch(tmp, name, n, todo):
    torch.save(todo, tmp / f"{name}.pt")
    return subprocess.Popen(
        _torchrun(n) + [str(tmp / "rank.py"), str(tmp / f"{name}.pt"),
                        str(tmp / name)],
        env=dict(os.environ, **CHILD_ENV))


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """Two ranks (every case under dp and {fsdp: 2}, (b)'s case, the
    checkpoint drill) and four ranks (HD stage 1 under dp and {dp: 2,
    fsdp: 2}), started first; JAX's fsdp step and one process on each
    global batch meanwhile. The full-width checkpoints are removed after
    the module's tests."""
    tmp = tmp_path_factory.mktemp("fsdp")
    (tmp / "rank.py").write_text(_RANK)
    ckpt_root, jax_root = tmp / "ckpt", tmp / "jax"
    world1_pt = _write_world1_pt(ckpt_root)
    _write_jax_ckpt(jax_root)
    cases, jax_case, hybrid = _world2_cases(), _jax_case(), _hybrid_case()
    procs = [
        _launch(tmp, "w2", 2, {
            "plans": [None, FSDP2],
            "cases": dict(cases, jax=dict(jax_case)),
            "ckpt": {"cfg": dict(_ckpt_cfg(ckpt_root), mesh={"fsdp": 2}),
                     "batch": _ckpt_batch(),
                     "jax_cfg": dict(_ckpt_cfg(jax_root), mesh={"fsdp": 2})}}),
        _launch(tmp, "w4", 4, {"plans": [None, HYBRID],
                               "cases": {"hd1": hybrid}})]
    try:
        jax_new, jax_losses = _jax_fsdp_step(jax_case)
        one = {name: run_case(case) for name, case in cases.items()}
        one["hybrid"] = run_case(hybrid)
        for p in procs:
            assert p.wait(timeout=900) == 0
    finally:
        for p in procs:
            p.kill()
    w2 = [torch.load(f"{tmp / 'w2'}.{r}", weights_only=False)
          for r in range(2)]
    w4 = [torch.load(f"{tmp / 'w4'}.{r}", weights_only=False)
          for r in range(4)]
    back, from_jax = (
        P2pTrainer(load_config(_ckpt_cfg(root)), torch.device("cpu"),
                   quiet=True) for root in (ckpt_root, jax_root))
    yield {"w2": w2, "w4": w4, "one": one, "jax": (jax_new, jax_losses),
           "world1_pt": digest(world1_pt),
           "world1_back": (back.start_epoch, fsdp.is_sharded(back.state),
                           digest(back._checkpoint_state())),
           "world1_jax": (from_jax.start_epoch, digest(
               from_jax._checkpoint_state()), int(from_jax.state.g_opt.state[
                   next(from_jax.g_model.parameters())]["step"]))}
    shutil.rmtree(tmp, ignore_errors=True)


def _held(got, want, tol):
    """Losses within ``tol`` (relative beyond 1); Adam's first moments per
    tensor within ``tol`` of the tensor's norm, floored at MOMENT_FLOOR of
    the net's largest; the weights per tensor within ``tol`` of their norm,
    but the biases whose gradient is rounding alone (below the floor)
    within 1e-4 of a step, as ``tests/test_torch_port_dp.py`` holds them;
    G's EMA (after the nets) as G's weights."""
    for lg, lw in zip(got["losses"], want["losses"], strict=True):
        assert lg.keys() == lw.keys()
        for k in lw:
            assert abs(lg[k] - lw[k]) <= tol * max(1.0, abs(lw[k])), k
    moments = want["moments"] + want["moments"][:1] * (
        len(want["weights"]) - len(want["moments"]))
    for i, (wg, ww, mw) in enumerate(zip(got["weights"], want["weights"],
                                         moments, strict=True)):
        floor = MOMENT_FLOOR * max(float(v.norm()) for v in mw.values())
        assert set(wg) == set(ww) == set(mw)
        for k, w in mw.items():
            if i < len(want["moments"]):
                assert _rel(got["moments"][i][k].numpy(), w.numpy(),
                            floor) <= tol, k
            if float(w.norm()) > floor:
                assert _rel(wg[k].numpy(), ww[k].numpy(), 0.0) <= tol, k
            else:
                assert float((wg[k] - ww[k]).abs().max()) <= 1e-4 * LR, k


# -- (b) against JAX ------------------------------------------------------------

@pytest.mark.parametrize("net", ["g", "d"])
def test_two_fsdp_ranks_match_jax_fsdp_step(fsdp_runs, net):
    new, want_losses = fsdp_runs["jax"]
    i = "gd".index(net)
    params = (new.g_params, new.d_params)[i]
    mu = (new.g_opt, new.d_opt)[i].mu
    convert = (generator_state_dict, discriminator_state_dict)[i]
    for rank in fsdp_runs["w2"]:
        got = rank["jax"][str(FSDP2)]
        for k, v in want_losses.items():
            np.testing.assert_allclose(got["losses"][0][k], float(v),
                                       rtol=1e-9, atol=1e-15, err_msg=k)
        for tree, have in ((params, got["weights"][i]),
                           (mu, got["moments"][i])):
            want = {k: v.numpy() for k, v in convert(tree).items()}
            floor = MOMENT_FLOOR * max(np.linalg.norm(w)
                                       for w in want.values())
            for k, w in want.items():
                assert _rel(have[k].numpy(), w, floor) <= JAX_TOL, (k, net)


# -- (c) every family against dp and one process --------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("against", ["dp", "one"])
def test_fsdp_matches_dp_and_one_process(fsdp_runs, case, against):
    for rank in fsdp_runs["w2"]:
        want = (rank[case][str(None)] if against == "dp"
                else fsdp_runs["one"][case])
        _held(rank[case][str(FSDP2)], want, PORT_TOL)


@pytest.mark.parametrize("against", ["dp", "one"])
def test_hybrid_dp2_fsdp2_matches_dp_and_one_process(fsdp_runs, against):
    for rank in fsdp_runs["w4"]:
        want = (rank["hd1"][str(None)] if against == "dp"
                else fsdp_runs["one"]["hybrid"])
        _held(rank["hd1"][str(HYBRID)], want, PORT_TOL)


# -- (d) the resting state ------------------------------------------------------

@pytest.mark.parametrize("case", CASES + ["hybrid"])
def test_rank_holds_its_share_of_the_state(fsdp_runs, case):
    """JAX's bound (``tests/test_parallel_fsdp.py``): a rank's resting state
    below total / N × 1.10, after sharding and after every step; the
    modules hold no parameter storage; each optimizer's moments are the
    shard's, 1/N of the padded net."""
    ranks, plan, name = ((fsdp_runs["w4"], HYBRID, "hd1") if case == "hybrid"
                         else (fsdp_runs["w2"], FSDP2, case))
    n = plan[1]
    for rank in ranks:
        res = rank[name][str(plan)]
        total = res["total"]
        assert all(b < total / n * 1.10 for b in res["bytes"]), (
            res["bytes"], total)
        assert len(res["rest"]) == 1 + len(res["losses"])
        for rest in res["rest"]:
            assert rest["nets"] and not any(rest["nets"] + rest["emas"])
            for shard, moments, padded in rest["shards"]:
                assert shard * n == padded
                assert moments in ([], [shard, shard])
        assert all(m == [shard, shard]
                   for shard, m, _ in res["rest"][-1]["shards"])
    if case == "p2p":
        assert len(res["rest"][-1]["emas"]) == 1


# -- (e) checkpoints -------------------------------------------------------------

def _same(got, want, path="state"):
    """Two :func:`digest` trees equal, reporting the first path that
    differs."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    else:
        assert got == want, path


def test_pt_round_trips_between_fsdp_and_world_1(fsdp_runs):
    ranks = [r["ckpt"] for r in fsdp_runs["w2"]]
    for r in ranks:
        assert r["start_epoch"] == 1 and r["sharded"] and r["sharded_after"]
        assert r["g_elements"] == 0  # the resumed G is sharded again
        _same(r["resumed"], fsdp_runs["world1_pt"])
        _same(r["after"], ranks[0]["after"])
    assert ranks[0]["path"] and ranks[1]["path"] is None  # rank 0 wrote it
    assert ranks[0]["path"].endswith(".pt") and "_e2" in ranks[0]["path"]
    start_epoch, sharded, state = fsdp_runs["world1_back"]
    assert start_epoch == 2 and not sharded
    _same(state, ranks[0]["after"])


def test_jax_ckpt_resumes_under_fsdp(fsdp_runs):
    start_epoch, want, step = fsdp_runs["world1_jax"]
    assert start_epoch == 1 and step == 3
    for r in fsdp_runs["w2"]:
        got = r["ckpt"]["jax"]
        assert got["start_epoch"] == 1 and got["sharded"]
        _same(got["state"], want)


# -- (f) the entry point ----------------------------------------------------------

def test_train_test_entry_point_under_fsdp(tmp_path, capfd):
    """``--mode train_test`` as two ranks under ``mesh: {fsdp: 2}``: an
    epoch of 2 steps at a global batch of 2 with its validation, then
    test() at ``eval_batch`` 2 over 7 slices, against one process at
    ``batchSize`` 2, ``grad_accum`` 2 and ``eval_batch`` 1: bit-equal."""
    with open(_corpus(tmp_path, n_patients=2, slices=4, size=32)) as f:
        paths = f.read().split()
    lists = {}
    for name, chunk in (("train", paths[:4]), ("val", paths[4:]),
                        ("test", paths[1:])):
        lists[name] = tmp_path / f"{name}.txt"
        lists[name].write_text("\n".join(chunk) + "\n")
    cfg = _p2p_cfg(tmp_path / "fsdp", str(lists["train"]), size=32,
                   decay_epoch=0, log_every=1, eval_batch=2,
                   val_list=str(lists["val"]), test_list=str(lists["test"]))
    path = _yaml(tmp_path / "P2p.yaml", cfg)
    with open(path, "a") as f:
        f.write("mesh: {fsdp: 2}\n")
    rc = subprocess.call(_torchrun(2) + [
        "-m", "ctagan_tpu_torch", "--config", path, "--mode", "train_test",
        "--device", "cpu", "--max-steps", "2"],
        env=dict(os.environ, **CHILD_ENV))
    out = capfd.readouterr().out
    assert rc == 0, out[-3000:]
    assert "mesh plan: {'fsdp': 2} (kind=fsdp, batch x2)" in out
    assert "2 ranks, global batch 2" in out
    root = cfg["save_root"]
    pts = [f for f in os.listdir(root) if f.endswith(".pt")]
    assert len(pts) == 1 and pts[0].startswith("P2p_p2p_e1_"), pts
    printed = {ln.split(": ")[0]: float(ln.split(": ")[1])
               for ln in out.splitlines()
               if ln.split(": ")[0] in ("MAEw", "PSNRw", "SSIMw", "UQIw",
                                        "MAE", "PSNR", "SSIM", "UQI")}
    assert len(printed) == 8 and out.count("PSNRw: ") == 1

    # one process on the same global batch, a slice a forward, as each rank
    one_root = tmp_path / "one"
    one_cfg = dict(cfg, batchSize=2, grad_accum=2, eval_batch=1,
                   save_root=f"{one_root}/model/",
                   image_save=f"{one_root}/img/")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: the convs' sums split alike
    try:
        one = P2pTrainer(load_config(one_cfg), torch.device("cpu"),
                         quiet=True)
        one.train(max_steps_per_epoch=2)
        agg = one.test()
    finally:
        torch.set_num_threads(threads)
    for name in ("P2p_losses.csv", "P2p_val.csv"):
        got, want = (_csv_rows(os.path.join(r, name))
                     for r in (root, one_cfg["save_root"]))
        assert got == want, name
    assert printed == {k: agg[k] for k in printed}
    got, want = (_se2_tree(d) for d in (cfg["image_save"],
                                        one_cfg["image_save"]))
    assert sorted(got) == sorted(want) and len(got) == 3 * 7
    for name, (px, _) in want.items():
        assert np.array_equal(got[name][0], px), name
