"""Parity: the port's CycleGAN family against the JAX package.

- One ``cyc_train_step`` in float64 against JAX's, from the same weights,
  with ``noise_level: 0``, at ``grad_accum`` 1 on a batch of 1 and at
  ``grad_accum`` 2 on a batch of 2 (JAX's pool fakes then come from an
  extra forward over the whole batch): the losses rtol 1e-9, the Adam first
  moments of both generators (one optimizer over the pair) and both Ds as
  ``test_torch_port_p2p.py`` holds them. The pools hold fewer than 50
  fakes, so each returns the new fakes on both sides and the Ds see the
  same inputs.
- The replay pool element by element: fill, swap and pass-through with the
  coin and slot draws recomputed from a copy of the same generator; its
  size stops at ``max_size``.
- The EMA of both generators over two steps, exactly the formula on the
  port's own params and the shared optimizer's count.
- ``PairedSliceDataset(unaligned=True)``: the same B paths as JAX's over
  two epochs, a fresh draw per visit.
- ``CycTrainer``: ``resume`` restores every tensor (nets, the three
  optimizers, both pools and their sizes, the RNG, both EMAs).

A G of 2 residual blocks at base 16 and 64² images.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from ctagan_tpu.data import datasets as jax_datasets
from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.train import replay_buffer as jax_rb
from ctagan_tpu.train import steps as jax_steps
from ctagan_tpu_torch.data import datasets
from ctagan_tpu_torch.models import Discriminator
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    generator_state_dict,
    load_cyc_state,
)
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.train.replay_buffer import ReplayBuffer, push_and_pop
from ctagan_tpu_torch.train.trainers import CycTrainer
from ctagan_tpu_torch.utils.config import load_config
from tests.test_torch_port_p2p import (
    EMA_DECAY,
    LR,
    SIZE,
    _corpus,
    assert_losses,
    assert_moments,
    expect_ema,
    f64,
    jax_small_g,
    jax_tree,
    pair_batch,
    run_jax,
    small_g,
    snapshot,
)

torch.set_num_threads(2)

CFG = {"Adv_lamda": 1.0, "Cyc_lamda": 10.0, "noise_level": 0,
       "aligned_aug": False}


def _nets():
    return (small_g(0), small_g(1), Discriminator().reset_parameters(2),
            Discriminator().reset_parameters(3))


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def cyc_step(request):
    n = request.param  # grad_accum, on a batch of as many pairs
    cfg = dict(CFG, grad_accum=n)
    nets = _nets()
    trees = [f64(jax_tree(net)) for net in nets]
    batch = pair_batch(n, SIZE)
    jg, jd = jax_small_g(), JaxDiscriminator()
    tx = jax_steps.make_optimizer()
    jax.config.update("jax_enable_x64", True)
    try:
        ga, gb, da, db = trees
        pools = [jax_rb.ReplayBuffer.create(50, (SIZE, SIZE, 1), np.float64)
                 for _ in range(2)]
        state = jax_steps.CycState(ga, gb, da, db, tx.init((ga, gb)),
                                   tx.init(da), tx.init(db), *pools,
                                   jax.random.PRNGKey(0))
    finally:
        jax.config.update("jax_enable_x64", False)
    new, want = run_jax(partial(jax_steps.cyc_train_step, jg, jd, tx, cfg),
                        state, batch)
    for net in nets:
        net.double()
    pstate = steps.init_cyc_state(*nets, SIZE, seed=0)
    got = steps.cyc_train_step(
        pstate, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    return new, want, pstate, got


def test_cyc_losses_match_jax(cyc_step):
    new, want, pstate, got = cyc_step
    assert list(got) == ["loss_G", "loss_GAN_A2B", "loss_cycle_ABA",
                         "loss_D_A", "loss_D_B"]
    assert_losses(got, want)
    n = pstate.fake_a_buffer.size
    assert n == pstate.fake_b_buffer.size == int(new.fake_a_buffer.size)
    for key in ("fake_a_buffer", "fake_b_buffer"):
        np.testing.assert_allclose(
            getattr(pstate, key).data[:n].numpy(),
            np.asarray(getattr(new, key).data)[:n], rtol=0, atol=1e-12)


@pytest.mark.parametrize("net", ["g_a2b", "g_b2a", "d_a", "d_b"])
def test_cyc_adam_first_moments_match_jax(cyc_step, net):
    new, _, pstate, _ = cyc_step
    if net.startswith("g"):
        mu = new.g_opt.mu[0 if net == "g_a2b" else 1]
        assert_moments(getattr(pstate, net), pstate.g_opt, mu,
                       generator_state_dict)
    else:
        assert_moments(getattr(pstate, net), getattr(pstate, f"{net}_opt"),
                       getattr(new, f"{net}_opt").mu,
                       discriminator_state_dict)


def test_load_cyc_state_loads_jax_trees_and_both_emas():
    nets = _nets()
    trees = [jax_tree(net) for net in nets]
    pstate = steps.init_cyc_state(small_g(5), small_g(6), Discriminator(),
                                  Discriminator(), SIZE, ema=True)
    load_cyc_state(pstate, *trees)
    for attr, want in (("g_a2b", 0), ("g_ema", 0), ("g_b2a", 1),
                       ("g_ema_b2a", 1), ("d_a", 2), ("d_b", 3)):
        sd = nets[want].state_dict()
        assert all(torch.equal(v, sd[k]) for k, v in
                   getattr(pstate, attr).state_dict().items()), attr


# -- the replay pool ----------------------------------------------------------

def test_replay_pool_fills_swaps_and_passes_through():
    max_size, n_items = 3, 12
    buf = ReplayBuffer.create(max_size, (2, 2, 1))
    gen = torch.Generator().manual_seed(5)
    shadow = torch.Generator().manual_seed(5)
    model = []  # the reference policy on a Python list
    outcomes = set()
    for step in range(n_items // 2):
        items = torch.arange(2 * step, 2 * step + 2, dtype=torch.float32
                             )[:, None, None, None].expand(2, 2, 2, 1) + 1.0
        got = push_and_pop(buf, items, gen)
        for item, out in zip(items, got):
            coin = float(torch.rand((), generator=shadow)) > 0.5
            idx = int(torch.randint(0, max_size, (), generator=shadow))
            if len(model) < max_size:
                model.append(item.clone())
                want, kind = item, "fill"
            elif coin:
                want, model[idx] = model[idx], item.clone()
                kind = "swap"
            else:
                want, kind = item, "pass"
            outcomes.add(kind)
            assert torch.equal(out, want), (step, kind)
        assert buf.size == min(len(model), max_size) <= max_size
        assert torch.equal(buf.data[:buf.size], torch.stack(model))
    assert outcomes == {"fill", "swap", "pass"}
    assert buf.size == max_size


def test_replay_pool_returns_the_batch_dtype():
    buf = ReplayBuffer.create(1, (2, 2, 1))
    gen = torch.Generator().manual_seed(0)
    push_and_pop(buf, torch.zeros(1, 2, 2, 1), gen)
    out = push_and_pop(buf, torch.ones(4, 2, 2, 1, dtype=torch.float64), gen)
    assert out.dtype == torch.float64 and out.shape == (4, 2, 2, 1)


# -- the EMA of both generators -----------------------------------------------

def test_cyc_emas_over_two_steps_are_the_ramped_formula():
    nets = _nets()
    pstate = steps.init_cyc_state(*nets, SIZE, seed=0, ema=True)
    start = {k: snapshot(getattr(pstate, k)) for k in ("g_ema", "g_ema_b2a")}
    batch = {k: torch.from_numpy(v).float()
             for k, v in pair_batch(1, SIZE).items()}
    cfg = dict(CFG, noise_level=1, ema_decay=EMA_DECAY)
    params = {"g_ema": [], "g_ema_b2a": []}
    for _ in range(2):
        steps.cyc_train_step(pstate, cfg, batch, LR)
        params["g_ema"].append(snapshot(pstate.g_a2b))
        params["g_ema_b2a"].append(snapshot(pstate.g_b2a))
    assert steps._count(pstate.g_opt) == 2
    for key in start:
        want = expect_ema(start[key], params[key])
        got = snapshot(getattr(pstate, key))
        assert all(torch.equal(got[k], want[k]) for k in want), key


# -- unaligned pairs ----------------------------------------------------------

def test_unaligned_b_paths_equal_jax_over_two_epochs(tmp_path):
    lst = _corpus(tmp_path)
    got, want = (mod.PairedSliceDataset(lst, unaligned=True, seed=7)
                 for mod in (datasets, jax_datasets))
    paths = []
    for _ in range(2):
        for i in (3, 0, 5, 1, 4, 2):  # any visiting order
            g_item, w_item = got[i], want[i]
            np.testing.assert_array_equal(g_item["B"], w_item["B"])
            np.testing.assert_array_equal(g_item["A"], w_item["A"])
            assert g_item["A_path"] == w_item["A_path"]
            paths.append((i, g_item["B"].tobytes()))
    # a fresh draw per visit: some index sees another B in its second epoch
    first, second = dict(paths[:6]), dict(paths[6:])
    assert any(first[i] != second[i] for i in first)


# -- the trainer: resume ------------------------------------------------------

def _cyc_cfg(root, lst, **kw):
    cfg = dict(name="CycleGan", size=SIZE, seed=0, n_cpu=1, n_epochs=1,
               decay_epoch=1, val_every=100, train_list=lst, val_list=lst,
               test_list=lst, save_root=f"{root}/model/",
               image_save=f"{root}/img/", ema_decay=EMA_DECAY)
    cfg.update(kw)
    return cfg


def _all_tensors(t):
    """Every tensor of the trainer's checkpoint state, by flattened key."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
        elif isinstance(v, torch.Tensor):
            out[prefix] = v.detach().clone()
        else:
            out[prefix] = v

    walk("", t._checkpoint_state())
    return out


def test_cyc_resume_restores_every_tensor(tmp_path):
    lst = _corpus(tmp_path, n_patients=1, slices=2)
    t = CycTrainer(load_config(_cyc_cfg(tmp_path, lst)), torch.device("cpu"),
                   quiet=True)
    t.train(max_steps=2)  # one epoch: two steps, then its checkpoint
    assert t.state.fake_a_buffer.size == 2
    want = _all_tensors(t)
    r = CycTrainer(load_config(_cyc_cfg(tmp_path, lst, resume=True)),
                   torch.device("cpu"), quiet=True)
    got = _all_tensors(r)
    assert r.start_epoch == 1
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert any(k.startswith("/fake_b_buffer") for k in want)
    assert any(k.startswith("/g_ema_b2a") for k in want)
    # the restored RNG continues the stream
    assert torch.equal(torch.rand(4, generator=r.state.gen),
                       torch.rand(4, generator=t.state.gen))
