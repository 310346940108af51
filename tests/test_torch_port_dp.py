"""The port's data-parallel plan (``parallel/mesh.py``, ``parallel/dist.py``)
on the CPU, with gloo ranks in child processes that ``torchrun``
(``torch.distributed.run``) starts.

- ``plan_from_spec`` refuses every spec that JAX's ``plan_from_spec`` or
  config refuses (``tests/test_mesh_plan.py``); sp, depth or pp above 1
  names its ROADMAP M12 item; ``{dp: N}`` needs a group of N ranks, and
  ``{dp: M, tp: N}`` M × N.
- ``PrefetchLoader.shard``: at world 2 the ranks' rows are disjoint and
  together are world 1's global batches; at ``batchSize`` 1 they are JAX's
  multi-process ``order[idx::count]``; a dataset that draws at access
  (``VolumePatchDataset``) draws what one process draws.
- Two gloo ranks, one float64 HD stage-1 step each at a global batch of 2
  (G of 2 blocks at base 16, 128², ``noise_level: 0``): each rank's G, R
  and D, and Adam's first moments (the gradients), within 1e-6 of JAX's
  ``reg_train_step`` on a 2-device dp mesh (conftest's virtual devices)
  from the same converted weights; the two ranks bit-identical. In the
  same ranks, with augmentation on, P2p (64²), RegGAN (128²), CycleGAN
  (64², ``grad_accum: 2`` on a global batch of 4, so that each rank splits
  its 2 rows, into 2-slot pools, so that the pools fill and the last two
  fakes of each draw their coins) and P3d (2 windows of 4 × 32²) against
  one process on the whole global batch within 1e-12.
- ``python -m ctagan_tpu_torch --mode train_test --device cpu`` as two
  ranks on a P2p config at 32²: rank 0 alone writes the ``.pt``, the loss
  and val CSVs (one row each), which match one process's run on the same
  global batch; test() splits ``eval_batch`` 2 over the ranks and the SE2
  tree equals one process's; the ``.pt`` resumes at world 1.
- Eval over the ranks: each rank decodes only the slices of its block of
  every ``eval_batch`` batch, and the ranks' real rows are every slice
  once.
- ``data_parallel: false`` is a field; world 1 runs no collective whatever
  it says; the rank count ``--mode train`` starts, through torchrun.

The children run ``torch.set_num_threads(1)`` (or ``OMP_NUM_THREADS``).
"""
import os
import subprocess
import sys
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.data import loader as jax_loader
from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.parallel.mesh import plan_from_spec as jax_plan_from_spec
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu.utils.config import load_config as jax_load_config
from ctagan_tpu_torch import __main__ as cli
from ctagan_tpu_torch.__main__ import dp_ranks
from ctagan_tpu_torch.data.loader import PrefetchLoader
from ctagan_tpu_torch.models import Discriminator, RegNet
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
    regnet_state_dict,
)
from ctagan_tpu_torch.models.volumetric import Discriminator3D, Generator3D
from ctagan_tpu_torch.parallel import dist
from ctagan_tpu_torch.parallel.mesh import plan_from_spec, shard_rows
from ctagan_tpu_torch.train.trainers import (
    P2pTrainer,
    TrainerBase,
    build_trainer,
)
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_p2p import (
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
HD_SIZE = 128  # the RegNet's 7 max pools
LR_D = 2e-4
HD_CFG = {"Adv_lamda1": 1.0, "Corr_lamda1": 20.0, "Smooth_lamda": 10.0,
          "noise_level": 0, "aligned_aug": False, "d_refwd": True}
JAX_TOL, MOMENT_FLOOR = 1e-6, 1e-3
PORT_TOL = 1e-12
F32_TOL = 1e-3  # two f32 steps of one process and of two ranks, relative
FLOW_HEAD_SCALE = 1e4
CONVERT = {"g": generator_state_dict, "r": regnet_state_dict,
           "d": discriminator_state_dict}
CHILD_ENV = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": os.pathsep.join(
                 p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)}
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={WORLD}"]

# one rank's work: its rows of each case's global batch through the case's
# step; run by the children and, on the whole batch, by the test process
_RANK = r'''
import sys

import torch

from ctagan_tpu_torch.parallel import dist
from ctagan_tpu_torch.parallel.mesh import shard_rows
from ctagan_tpu_torch.train import steps


def run_case(case):
    """The case's steps on this rank's rows of its global batch (every row
    without a group): each net's weights and Adam first moments by name,
    and each step's losses."""
    nets = case["nets"]
    state = getattr(steps, case["init"])(*nets, **case["init_kw"])
    n = len(next(iter(case["batch"].values())))
    rows = shard_rows(n, dist.rank(), dist.world())
    batch = {k: torch.from_numpy(v[rows]) for k, v in case["batch"].items()}
    step = getattr(steps, case["step"])
    losses = [{k: float(v) for k, v in step(
        state, case["cfg"], batch, case["lr"], **case["step_kw"]).items()}
        for _ in range(case["steps"])]
    mu = {p: opt.state[p]["exp_avg"] for opt in vars(state).values()
          if isinstance(opt, torch.optim.Adam) for p in opt.state}
    return {"weights": [{k: v.detach().clone()
                         for k, v in m.state_dict().items()} for m in nets],
            "moments": [{k: mu[p].clone() for k, p in m.named_parameters()}
                        for m in nets],
            "losses": losses}


if __name__ == "__main__":
    torch.set_num_threads(1)
    cases = torch.load(sys.argv[1], weights_only=False)
    dist.init(torch.device("cpu"))
    try:
        out = {name: run_case(case) for name, case in cases.items()}
        torch.save(out, f"{sys.argv[2]}.{dist.rank()}")
    finally:
        dist.shutdown()
'''
_ns = {"__name__": "dp_rank"}
exec(compile(_RANK, "dp_rank", "exec"), _ns)
run_case = _ns["run_case"]


# -- the plan -----------------------------------------------------------------

JAX_REFUSED = [({"bogus": 2}, 8), ({"fsdp": 2, "tp": 2}, 8),
               ({"dp": 4, "fsdp": 4}, 8), ({"dp": 0}, 8)]


@pytest.mark.parametrize("spec,world", JAX_REFUSED, ids=str)
def test_plan_from_spec_refuses_what_jax_refuses(spec, world):
    with pytest.raises(ValueError):
        jax_plan_from_spec(spec, jax.devices()[:world])
    with pytest.raises((ValueError, NotImplementedError)):
        plan_from_spec(spec, world)


@pytest.mark.parametrize("mesh", [{"bogus": 2}, {"tp": 2, "sp": 2},
                                  {"dp": "two"}], ids=str)
def test_config_mesh_refused_as_jax(mesh):
    with pytest.raises(ValueError):
        jax_load_config({"mesh": mesh})
    with pytest.raises(ValueError):
        load_config({"mesh": mesh})


@pytest.mark.parametrize("raw,match", [
    ({"pp_microbatches": 0}, "pp_microbatches must be an int >= 1"),
    ({"pp_schedule": "bogus"}, "pp_schedule must be 'gpipe' or '1f1b'"),
    ({"batchSize": 3, "mesh": {"pp": 2}, "pp_microbatches": 2},
     "batchSize 3 must divide into pp_microbatches 2"),
], ids=["microbatches", "schedule", "batch"])
def test_config_pp_keys_checked_as_jax(raw, match):
    """The pp keys are fields, checked whatever the mesh with JAX's
    messages (the pp plan itself is not ported), and never extras."""
    with pytest.raises(ValueError, match=match):
        jax_load_config(raw)
    with pytest.raises(ValueError, match=match):
        load_config(raw)
    ok = load_config({k: v for k, v in raw.items() if k != "mesh"}
                     | {"pp_microbatches": 4, "pp_schedule": "1f1b"})
    assert (ok.pp_microbatches, ok.pp_schedule) == (4, "1f1b")
    assert not {"pp_microbatches", "pp_schedule"} & set(ok.extras)


@pytest.mark.parametrize("spec,item", [
    ({"dp": 2, "sp": 2}, "M12d"), ({"depth": 4}, "M12f"), ({"sp": 2}, "M12d"),
    ({"pp": 3}, "M12e"), ({"dp": 2, "pp": 4}, "M12e"), ({"depth": 2}, "M12f"),
], ids=str)
def test_model_axis_names_its_roadmap_item(spec, item):
    if item in ("M12d", "M12f"):  # the sp and depth plans, ported: they
        # need dp × sp (dp × depth) ranks
        kind = "sp" if item == "M12d" else "depth"
        world = spec.get("dp", 1) * spec[kind]
        plan = plan_from_spec(spec, world)
        assert (plan.kind, plan.batch_scale) == (kind, spec.get("dp", 1))
        with pytest.raises(ValueError, match=f"needs {world} devices"):
            plan_from_spec(spec, 1)
        return
    for world in (1, 8):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            plan_from_spec(spec, world)


@pytest.mark.parametrize("spec,world", [({"tp": 2}, 2), ({"tp": 4}, 4),
                                        ({"dp": 2, "tp": 2}, 4)], ids=str)
def test_tp_plan_needs_dp_times_tp_ranks(spec, world):
    """The tp plan (ported): JAX's ``batch_scale`` (the dp extent, the
    batch replicated over tp) at world dp × tp, and JAX's "needs N
    devices" at world 1."""
    p = plan_from_spec(spec, world)
    assert (p.kind, p.batch_scale) == ("tp", spec.get("dp", 1))
    assert p.batch_scale == jax_plan_from_spec(
        spec, jax.devices()[:world]).batch_scale
    with pytest.raises(ValueError, match=f"needs {world} devices, have 1"):
        plan_from_spec(spec, 1)


def test_dp_plan_needs_a_group_of_its_size():
    assert plan_from_spec({}, 1).batch_scale == 1
    p = plan_from_spec({"dp": 2}, 2)
    assert (p.kind, p.batch_scale) == ("dp", 2)
    assert "batch x2" in p.describe()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        plan_from_spec({"dp": 2}, 1)
    with pytest.raises(ValueError, match="process group has 2"):
        plan_from_spec({"dp": 1}, 2)
    assert shard_rows(6, 1, 3) == slice(2, 4)
    with pytest.raises(ValueError):
        shard_rows(3, 0, 2)


# -- the loader ---------------------------------------------------------------

class _Items:
    """Item i is {"x": i}; with ``rng`` each access draws one value."""

    def __init__(self, n, rng=None):
        self.n, self.rng = n, rng

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        out = {"x": np.array([i])}
        if self.rng is not None:
            out["draw"] = np.array([self.rng.integers(1 << 30)])
        return out

    def skip(self, i):
        if self.rng is not None:
            self.rng.integers(1 << 30)


def _batches(loader, key="x"):
    return [b[key][:, 0].tolist() for b in loader]


@pytest.mark.parametrize("bs", [1, 2])
def test_sharded_loader_splits_world_1s_global_batches(bs):
    n = 11
    whole = _batches(PrefetchLoader(
        _Items(n), bs * WORLD, shuffle=True, drop_last=True, num_threads=2,
        rng=np.random.default_rng(5)))
    ranks = [PrefetchLoader(_Items(n), bs, shuffle=True, drop_last=True,
                            num_threads=2, rng=np.random.default_rng(5),
                            shard=(r, WORLD)) for r in range(WORLD)]
    assert [len(ld) for ld in ranks] == [len(whole)] * WORLD == [n // (
        bs * WORLD)] * WORLD
    got = [_batches(ld) for ld in ranks]
    for i, batch in enumerate(whole):
        assert sum((g[i] for g in got), []) == batch
    assert not set(sum(got[0], [])) & set(sum(got[1], []))
    if bs == 1:  # JAX's multi-process layout
        for r in range(WORLD):
            want = jax_loader.PrefetchLoader(
                _Items(n), 1, shuffle=True, drop_last=True,
                rng=np.random.default_rng(5), shard=(r, WORLD))
            assert got[r] == _batches(want)


def test_sharded_loader_keeps_draws_at_access_in_step():
    """One loader thread, as the P3d trainer runs: each rank's items draw
    what one process draws for them, and the streams end alike."""
    whole_rng = np.random.default_rng(3)
    whole = list(PrefetchLoader(_Items(8, whole_rng), WORLD, shuffle=True,
                                drop_last=True, num_threads=1,
                                rng=np.random.default_rng(9)))
    rngs = [np.random.default_rng(3) for _ in range(WORLD)]
    for r in range(WORLD):
        got = list(PrefetchLoader(_Items(8, rngs[r]), 1, shuffle=True,
                                  drop_last=True, num_threads=1,
                                  rng=np.random.default_rng(9),
                                  shard=(r, WORLD)))
        assert len(got) == len(whole)
        for g, w in zip(got, whole):
            assert g["draw"][0, 0] == w["draw"][r, 0]
        assert rngs[r].bit_generator.state == whole_rng.bit_generator.state


def test_sharded_loader_needs_drop_last_and_a_rank_in_the_world():
    with pytest.raises(ValueError, match="drop_last"):
        PrefetchLoader(_Items(4), 1, shard=(0, 2))
    with pytest.raises(ValueError, match="rank"):
        PrefetchLoader(_Items(4), 1, drop_last=True, shard=(2, 2))


# -- steps over two gloo ranks ------------------------------------------------

def _hd_batch(n, keys=("A1", "A2", "B1", "B2")):
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
    from ctagan_tpu_torch.data.native import dual_window_native

    rng = np.random.default_rng(11)
    out = {k: [] for k in keys}
    for _ in range(n):
        a = dual_window_native(synthetic_ct_pixels(rng, HD_SIZE))
        b = dual_window_native(synthetic_ct_pixels(rng, HD_SIZE,
                                                   contrast=True))
        for k, v in zip(("A1", "A2", "B1", "B2"), (*a, *b)):
            if k in out:
                out[k].append(v[:, :, None])
    return {k: np.stack(v).astype(np.float64) for k, v in out.items()}


def _reg_nets():
    """G, R and D; the flow head scaled so the warp sees flows of a few
    pixels."""
    g = small_g(0)
    r = RegNet().reset_parameters(1)
    d = Discriminator().reset_parameters(2)
    with torch.no_grad():
        r.offset_map.output.conv2d.weight.mul_(FLOW_HEAD_SCALE)
    return [m.double() for m in (g, r, d)]


def _cases():
    fam = {"noise_level": 1, "aligned_aug": False, "grad_accum": 1}
    reg_cfg = dict(fam, Adv_lamda=1.0, Corr_lamda=20.0, Smooth_lamda=10.0,
                   d_refwd=True)
    hd = _hd_batch(WORLD)
    pairs = pair_batch(WORLD, 64)
    return {
        "hd1": dict(nets=_reg_nets(), init="init_reg_state", init_kw={},
                    step="reg_train_step", cfg=HD_CFG, batch=hd,
                    lr=LR, steps=1,
                    step_kw={"lr_d": LR_D, "dual_window_mode": True}),
        "reg": dict(nets=_reg_nets(), init="init_reg_state", init_kw={},
                    step="reg_train_step", cfg=reg_cfg,
                    batch={"A": hd["A2"], "B": hd["B2"]},
                    lr=LR, steps=1, step_kw={}),
        "p2p": dict(nets=[small_g(0).double(),
                          Discriminator(2).reset_parameters(1).double()],
                    init="init_p2p_state", init_kw={}, step="p2p_train_step",
                    cfg=dict(fam, P2P_lamda=100.0, Adv_lamda=1.0),
                    batch=pairs, lr=LR, steps=1, step_kw={}),
        "cyc": dict(nets=[small_g(0).double(), small_g(1).double(),
                          Discriminator().reset_parameters(2).double(),
                          Discriminator().reset_parameters(3).double()],
                    init="init_cyc_state",
                    init_kw={"size": 64, "buffer_size": 2},
                    step="cyc_train_step",
                    cfg=dict(fam, grad_accum=2, Adv_lamda=1.0, Cyc_lamda=10.0),
                    batch=pair_batch(2 * WORLD, 64), lr=LR, steps=1,
                    step_kw={}),
        "p3d": dict(nets=[Generator3D(1, 1, n_residual_blocks=1,
                                      base_features=8).reset_parameters(
                                          0).double(),
                          Discriminator3D(2).reset_parameters(1).double()],
                    init="init_p3d_state", init_kw={}, step="p3d_train_step",
                    cfg=dict(fam, P2P_lamda=100.0, Adv_lamda=1.0),
                    # depth windows of 4 copies of a 32² crop
                    batch={k: np.stack([v[:, :32, :32]] * 4, axis=1)
                           for k, v in pairs.items()},
                    lr=LR, steps=1, step_kw={}),
    }


def _jax_hd_step(nets, batch):
    """JAX's HD stage-1 step on a 2-device dp mesh, in float64, from the
    port nets' weights."""
    g, r, d = nets
    jg, jr, jd = jax_small_g(), JaxRegNet(), JaxDiscriminator()
    tx = jax_steps.make_optimizer()
    plan = jax_plan_from_spec({"dp": WORLD})
    jax.config.update("jax_enable_x64", True)
    try:
        gp, rp, dp = (f64(jax_tree(m)) for m in (g, r, d))
        state = jax_steps.RegState(gp, rp, dp, tx.init(gp), tx.init(rp),
                                   tx.init(dp), jax.random.PRNGKey(0))
        state = plan.shard_state(state)
        fn = jax.jit(partial(jax_steps.reg_train_step, jg, jr, jd, tx, HD_CFG,
                             dual_window_mode=True))
        return jax.device_get(fn(state, plan.shard_batch(batch),
                                 jnp.float64(LR), lr_d=jnp.float64(LR_D)))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every case on two gloo ranks (children, started first), JAX's dp HD
    step and one process on each whole global batch, meanwhile."""
    tmp = tmp_path_factory.mktemp("dp")
    cases = _cases()
    torch.save(cases, tmp / "cases.pt")
    script = tmp / "rank.py"
    script.write_text(_RANK)
    world = subprocess.Popen(TORCHRUN + [str(script), str(tmp / "cases.pt"),
                                         str(tmp / "out")],
                             env=dict(os.environ, **CHILD_ENV))
    try:
        jax_new, jax_losses = _jax_hd_step(cases["hd1"]["nets"],
                                           cases["hd1"]["batch"])
        one = {name: run_case(case) for name, case in cases.items()}
        assert world.wait(timeout=600) == 0
    finally:
        world.kill()
    ranks = [torch.load(f"{tmp / 'out'}.{r}") for r in range(WORLD)]
    return ranks, one, (jax_new, jax_losses)


def _rel(got, want, floor):
    return np.linalg.norm(got - want) / max(float(np.linalg.norm(want)),
                                            floor)


@pytest.mark.parametrize("case", ["hd1", "reg", "p2p", "cyc", "p3d"])
def test_ranks_end_the_step_bit_identical(dp_runs, case):
    ranks, _, _ = dp_runs
    a, b = (r[case] for r in ranks)
    assert a["losses"] == b["losses"]
    for wa, wb in zip(a["weights"], b["weights"]):
        assert all(torch.equal(wa[k], wb[k]) for k in wa)


@pytest.mark.parametrize("net", ["g", "r", "d"])
def test_two_ranks_match_jax_dp_mesh_step(dp_runs, net):
    ranks, _, (new, want_losses) = dp_runs
    i = "grd".index(net)
    params = (new.g_params, new.r_params, new.d_params)[i]
    mu = (new.g_opt, new.r_opt, new.d_opt)[i].mu
    for rank in ranks:
        got = rank["hd1"]
        for k, v in want_losses.items():
            np.testing.assert_allclose(got["losses"][0][k], float(v),
                                       rtol=1e-9, atol=1e-15, err_msg=k)
        for tree, have in ((params, got["weights"][i]),
                           (mu, got["moments"][i])):
            want = {k: v.numpy() for k, v in CONVERT[net](tree).items()}
            floor = MOMENT_FLOOR * max(np.linalg.norm(w)
                                       for w in want.values())
            for k, w in want.items():
                assert _rel(have[k].numpy(), w, floor) <= JAX_TOL, (k, net)


@pytest.mark.parametrize("case", ["hd1", "reg", "p2p", "cyc", "p3d"])
def test_two_ranks_match_one_process_on_the_global_batch(dp_runs, case):
    """Losses within 1e-12 (relative). Adam's first moments (the gradients)
    per tensor within 1e-12 of the tensor's norm, floored at 1e-3 of the
    net's largest: the conv biases before an InstanceNorm have a gradient
    that is zero in exact arithmetic, and hold rounding alone (~1e-15
    here). The weights per tensor within 1e-12 of the tensor's norm (an
    element with a gradient near Adam's eps moves by up to lr/eps times its
    rounding), but those biases, whose Adam update is their rounding
    times lr/eps (up to ~1e-9 here), each within 1e-4 of a step (lr): a
    wrong gradient moves a weight by ~lr."""
    ranks, one, _ = dp_runs
    got, want = ranks[0][case], one[case]
    for lg, lw in zip(got["losses"], want["losses"]):
        assert lg.keys() == lw.keys()
        for k in lw:
            assert abs(lg[k] - lw[k]) <= PORT_TOL * max(1.0, abs(lw[k])), k
    for wg, ww, mg, mw in zip(got["weights"], want["weights"],
                              got["moments"], want["moments"]):
        floor = MOMENT_FLOOR * max(float(v.norm()) for v in mw.values())
        for k, w in mw.items():
            assert _rel(mg[k].numpy(), w.numpy(), floor) <= PORT_TOL, (case, k)
            if float(w.norm()) > floor:
                assert _rel(wg[k].numpy(), ww[k].numpy(), 0.0) <= PORT_TOL, (
                    case, k)
            else:
                assert float((wg[k] - ww[k]).abs().max()) <= 1e-4 * LR, (
                    case, k)
        assert set(ww) == set(mw)


# -- the entry point over two ranks -------------------------------------------

def _csv_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [[float(x) for x in ln.split(",")] for ln in lines[1:]]


def _se2_tree(root):
    from ctagan_tpu_torch.data.dicom import read_dicom

    tree = {}
    for d, _, files in os.walk(root):
        for f in files:
            ds = read_dicom(os.path.join(d, f))
            tree[os.path.relpath(os.path.join(d, f), root)] = (
                ds.pixel_array().astype(np.int32), ds.series_instance_uid)
    return tree


def test_train_test_entry_point_over_two_ranks(tmp_path, capfd):
    """``--mode train_test`` as two gloo ranks under torchrun's env: an
    epoch of 2 steps at a global batch of 2 and its validation, then test()
    at ``eval_batch`` 2 over 7 slices of two patients (the last batch
    padded, a patient's first slice on rank 1)."""
    with open(_corpus(tmp_path, n_patients=2, slices=4, size=32)) as f:
        paths = f.read().split()
    lists = {}
    for name, chunk in (("train", paths[:4]), ("val", paths[4:]),
                        ("test", paths[1:])):
        lists[name] = tmp_path / f"{name}.txt"
        lists[name].write_text("\n".join(chunk) + "\n")
    cfg = _p2p_cfg(tmp_path / "dp", str(lists["train"]), size=32,
                   decay_epoch=0, log_every=1, eval_batch=2,
                   val_list=str(lists["val"]), test_list=str(lists["test"]))
    path = _yaml(tmp_path / "P2p.yaml", cfg)
    rc = subprocess.call(TORCHRUN + ["-m", "ctagan_tpu_torch", "--config",
                                     path, "--mode", "train_test", "--device",
                                     "cpu", "--max-steps", "2"],
                         env=dict(os.environ, **CHILD_ENV))
    out = capfd.readouterr().out
    assert rc == 0, out[-3000:]
    assert "2 ranks, global batch 2" in out
    root = cfg["save_root"]
    pts = [f for f in os.listdir(root) if f.endswith(".pt")]
    assert len(pts) == 1 and pts[0].startswith("P2p_p2p_e1_"), pts
    loss_head, loss_rows = _csv_rows(os.path.join(root, "P2p_losses.csv"))
    _, val_rows = _csv_rows(os.path.join(root, "P2p_val.csv"))
    assert len(loss_rows) == 1 and len(val_rows) == 1  # rank 0's alone
    printed = {ln.split(": ")[0]: float(ln.split(": ")[1])
               for ln in out.splitlines()
               if ln.split(": ")[0] in ("MAEw", "PSNRw", "SSIMw", "UQIw",
                                        "MAE", "PSNR", "SSIM", "UQI")}
    assert len(printed) == 8 and out.count("PSNRw: ") == 1

    # one process on the same global batch
    one_cfg = dict(cfg, batchSize=2, save_root=f"{tmp_path}/one/model/")
    one = P2pTrainer(load_config(one_cfg), torch.device("cpu"), quiet=True)
    one.train(max_steps_per_epoch=2)
    one_head, one_loss = _csv_rows(os.path.join(one_cfg["save_root"],
                                                "P2p_losses.csv"))
    # f32: the biases before an InstanceNorm have rounding for a gradient,
    # which Adam turns into steps of ±lr whose signs differ with the sum
    # order, so the losses after the first update agree to ~1e-4
    assert loss_head == one_head
    np.testing.assert_allclose(loss_rows, one_loss, rtol=F32_TOL)

    # validate() and test() of the ranks' weights by one process, a slice
    # a forward
    pt = os.path.join(root, pts[0])
    ref = P2pTrainer(load_config(dict(
        cfg, generator_ckpt=pt, eval_batch=1,
        image_save=f"{tmp_path}/one/img/")), torch.device("cpu"), quiet=True)
    ref.load_generator(pt)
    np.testing.assert_allclose(val_rows[0][1:], ref.validate(), rtol=1e-6)
    agg = ref.test()
    for k, v in printed.items():
        assert abs(v - agg[k]) <= 1e-6 * max(1.0, abs(agg[k])), k
    got, want = (_se2_tree(d) for d in (cfg["image_save"],
                                        f"{tmp_path}/one/img/"))
    assert sorted(got) == sorted(want) and len(got) == 3 * 7
    for name, (px, _) in want.items():
        assert np.abs(got[name][0] - px).max() <= 1, name
    for tree in (got, want):  # one series UID a patient's SE2
        uids = {name.split(os.sep)[1]: set() for name in tree
                if os.sep + "SE2" + os.sep in name}
        for name, (_, uid) in tree.items():
            if os.sep + "SE2" + os.sep in name:
                uids[name.split(os.sep)[1]].add(uid)
        assert sorted(uids) == ["1", "2"]
        assert all(len(u) == 1 for u in uids.values())
        assert len(set.union(*uids.values())) == 2

    # the checkpoint resumes at world 1
    back = P2pTrainer(load_config(dict(cfg, resume=True)),
                      torch.device("cpu"), quiet=True)
    assert back.start_epoch == 1
    saved = torch.load(pt, weights_only=False)["state"]["g"]
    assert all(torch.equal(v, saved[k])
               for k, v in back.g_model.state_dict().items())


# -- eval over the ranks ------------------------------------------------------

class _Decoded(_Items):
    """``_Items`` with A paths, counting the items decoded."""

    def __init__(self, n):
        super().__init__(n)
        self.files_a = [f"s{i}" for i in range(n)]
        self.decoded = []

    def __getitem__(self, i):
        self.decoded.append(i)
        return dict(super().__getitem__(i), x_path=self.files_a[i])


@pytest.mark.parametrize("eval_batch,world", [(2, 2), (4, 2), (3, 2),
                                              (4, 4), (2, 1)], ids=str)
def test_eval_rank_decodes_only_its_rows(monkeypatch, eval_batch, world):
    """7 slices: each rank decodes the slices of its block of every batch
    (the ragged last batch padded by repeating its last slice), rank 0
    every batch when ``eval_batch`` does not divide over the ranks; the
    ranks' real rows are every slice once, in order within each batch."""
    n = 7
    trainer = SimpleNamespace(config=SimpleNamespace(eval_batch=eval_batch,
                                                     n_cpu=2))
    monkeypatch.setattr(dist, "world", lambda: world)
    real_rows = {}
    for r in range(world):
        monkeypatch.setattr(dist, "rank", lambda r=r: r)
        ds = _Decoded(n)
        blocks = TrainerBase._eval_blocks(trainer, n)
        fed = list(TrainerBase._eval_feed(trainer, ds, blocks))
        assert sorted(ds.decoded) == sorted(i for b in blocks for i in b[4])
        for start, paths, lo, real, idx, block in fed:
            assert paths == ds.files_a[start:start + len(paths)]
            assert block["x"][:, 0].tolist() == idx
            assert "x_path" not in block
            for j in range(real):
                real_rows.setdefault(start, {})[lo + j] = idx[j]
        if eval_batch % world:
            assert (blocks == []) == (r > 0)
    got = [i for start in sorted(real_rows)
           for _, i in sorted(real_rows[start].items())]
    assert got == list(range(n))


# -- world 1, the config key, the launcher ------------------------------------

def test_data_parallel_is_a_field_with_jax_default(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("name: P2p\ndata_parallel: false\n")
    cfg, want = load_config(str(path)), jax_load_config(str(path))
    assert cfg.data_parallel is False and want.data_parallel is False
    assert "data_parallel" not in cfg.extras
    assert load_config({}).data_parallel is jax_load_config({}).data_parallel


@pytest.mark.parametrize("data_parallel", [True, False])
def test_world_1_runs_no_collective(tmp_path, monkeypatch, data_parallel):
    """Without a group the plan is dp 1, the loader unsharded, and an
    epoch (steps, validation, a save) calls no collective, whatever
    ``data_parallel`` says."""
    def refuse(*a, **k):
        raise AssertionError("a collective without a group")

    for name in ("all_reduce", "broadcast", "broadcast_object_list",
                 "barrier"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    lst = _corpus(tmp_path, n_patients=1, slices=2, size=32)
    t = build_trainer(load_config(_p2p_cfg(
        tmp_path, lst, size=32, data_parallel=data_parallel)),
        torch.device("cpu"), quiet=True)
    assert t.plan.batch_scale == 1 and t._train_loader().shard is None
    t.train(max_steps=2)
    assert len(t.loss_history) == 2 and len(os.listdir(t.config.save_root))


def test_dp_ranks_is_one_a_card_under_the_dp_plan(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dp_ranks(load_config({}), cuda, None) == 4
    assert dp_ranks(load_config({}), cuda, "cuda") == 4
    assert dp_ranks(load_config({"data_parallel": False}), cuda, None) == 1
    assert dp_ranks(load_config({"mesh": {"dp": 2}}), cuda, None) == 2
    assert dp_ranks(load_config({}), torch.device("cuda", 1), "cuda:1") == 1
    assert dp_ranks(load_config({}), cpu, "cpu") == 1
    with pytest.raises(SystemExit, match="needs 8 devices, have 4"):
        dp_ranks(load_config({"mesh": {"dp": 8}}), cuda, None)


def test_train_starts_a_rank_a_card_through_torchrun(tmp_path,
                                                    monkeypatch):
    """On a host of 4 cards, ``--mode train`` builds the kernels once and
    hands the command to torchrun, a rank a card; its exit is the run's."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(cli.subprocess, "call",
                        lambda cmd: calls.append(cmd) or 3)
    from ctagan_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "build", lambda: calls.append("build"))
    path = tmp_path / "c.yaml"
    path.write_text("name: P2p\n")
    argv = ["--config", str(path), "--mode", "train", "--max-steps", "2"]
    assert cli.main(argv) == 3
    assert calls == ["build", [sys.executable, "-m", "torch.distributed.run",
                               "--standalone", "--nproc-per-node=4", "-m",
                               "ctagan_tpu_torch", *argv]]
