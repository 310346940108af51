"""Parity: the modules of the port's HD stage-1 training slice against the JAX
package, on the same weights, the same numpy inputs and the same seeds.

Tolerances: RegNet and Discriminator forwards atol 1e-5 relative to the
output's scale (f32 convs in another order); warp values atol 1e-5 and
gradients atol 1e-4 (bilinear weights from coordinates that round-trip
through grid_sample's [-1, 1] normalisation); resize, losses and pooling
1e-6; the windowing tables, the corpus, the datasets and the loader order
are exact.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.data import datasets as jax_datasets
from ctagan_tpu.data import dicom as jax_dicom
from ctagan_tpu.data import fixtures as jax_fixtures
from ctagan_tpu.data import loader as jax_loader
from ctagan_tpu.models import Discriminator as JaxDiscriminator
from ctagan_tpu.models import RegNet as JaxRegNet
from ctagan_tpu.models import layers as jax_layers
from ctagan_tpu.models import torch_export
from ctagan_tpu.ops import augment as jax_augment
from ctagan_tpu.ops import losses as jax_losses
from ctagan_tpu.ops import resize as jax_resize
from ctagan_tpu.ops import warp as jax_warp
from ctagan_tpu.ops import windowing as jax_windowing
from ctagan_tpu.train.trainers import TrainerBase as JaxTrainerBase
from ctagan_tpu_torch.data import datasets, dicom, fixtures, loader
from ctagan_tpu_torch.models import Discriminator, RegNet
from ctagan_tpu_torch.models import layers
from ctagan_tpu_torch.models.convert import (
    discriminator_state_dict,
    regnet_state_dict,
)
from ctagan_tpu_torch.ops import augment, losses, resize, warp, windowing
from ctagan_tpu_torch.train.trainers import TrainerBase

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.fixture(scope="module")
def regnet_case():
    a, b = _rand((1, 256, 256, 1), 0), _rand((1, 256, 256, 1), 1)
    model = JaxRegNet()
    params = jax.device_get(model.init(jax.random.PRNGKey(0), a, b))
    # the flow head is initialised near zero (N(0, 1e-5)); scale it so the
    # comparison sees the whole net, not just its rounding
    head = params["params"]["output"]["ConvTorch_0"]["Conv_0"]
    head["kernel"] = np.asarray(head["kernel"]) * 1e4
    return a, b, params, np.asarray(model.apply(params, a, b))


def test_regnet_matches_jax(regnet_case):
    a, b, params, want = regnet_case
    sd = regnet_state_dict(params)
    assert list(sd) == list(torch_export.regnet_state_dict(params))
    net = RegNet()
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(_t(a), _t(b)).numpy()
    assert got.shape == (1, 256, 256, 2)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert set(net.state_dict()) == set(sd)


def test_discriminator_matches_jax():
    x = _rand((2, 64, 64, 1), 2)
    model = JaxDiscriminator()
    params = jax.device_get(model.init(jax.random.PRNGKey(1), x))
    sd = discriminator_state_dict(params)
    want_sd = torch_export.discriminator_state_dict(params)
    assert list(sd) == list(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(sd[k].numpy(), want_sd[k])
    d = Discriminator()
    d.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = d(_t(x)).numpy()
    want = np.asarray(model.apply(params, x))
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_seeded_init_scales():
    net = RegNet().reset_parameters(3)
    again = RegNet().reset_parameters(3)
    for p, q in zip(net.parameters(), again.parameters()):
        assert torch.equal(p, q)
    head = net.offset_map.output.conv2d.weight.detach()
    assert float(head.abs().max()) < 1e-4  # near-zero flow head
    w = net.offset_map.down_2.conv_0.conv2d.weight.detach()  # leaky 0.2
    std = float(w.std())
    want = np.sqrt(2.0 / (1 + 0.04) / (32 * 9))
    assert abs(std - want) < 0.1 * want
    assert all(float(m.bias.detach().abs().max()) == 0.0
               for m in net.modules() if isinstance(m, layers.ConvTorch))


def test_warp2d_values_and_grads_match_jax():
    src = _rand((2, 16, 20, 3), 3)
    flow = _rand((2, 16, 20, 2), 4, scale=6.0)  # reaches past every border
    cot = _rand((2, 16, 20, 3), 5)

    def jloss(s, f):
        return jnp.sum(jax_warp.warp2d(s, f) * cot)

    want = np.asarray(jax_warp.warp2d(src, flow))
    gs_want, gf_want = jax.grad(jloss, argnums=(0, 1))(src, flow)
    s_t, f_t = _t(src, True), _t(flow, True)
    got = warp.warp2d(s_t, f_t)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(gs_want),
                               atol=1e-4)
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(gf_want),
                               atol=1e-4)


def test_losses_match_jax():
    flow = _rand((2, 8, 12, 2), 6)
    a, b = _rand((2, 8, 8, 1), 7), _rand((2, 8, 8, 1), 8)
    for got, want in (
        (warp.smoothing_loss(_t(flow)), jax_warp.smoothing_loss(flow)),
        (losses.mse(_t(a), _t(b)), jax_losses.mse(a, b)),
        (losses.l1(_t(a), _t(b)), jax_losses.l1(a, b)),
        (losses.mse(_t(a), 1.0), jax_losses.mse(a, jnp.ones_like(a))),
    ):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("params", [
    (0.0, 0.0, 0.0, 1.0),     # identity
    (0.0, 3.0, -5.0, 1.0),    # whole-pixel shift: the fill enters
    (7.5, -2.0, 4.0, 1.03),   # rotate + scale
    (-12.0, 1.0, 1.0, 0.97),
])
def test_affine_warp_with_injected_params_matches_jax(params):
    img = _rand((2, 24, 20, 2), 9)
    ang, ty, tx, sc = (np.full((2,), v, np.float32) for v in params)
    want = np.asarray(jax_augment.affine_warp(img, ang, ty, tx, sc))
    got = augment.affine_warp(_t(img), _t(ang), _t(ty), _t(tx),
                              _t(sc)).numpy()
    # nearest sampling: a source coordinate within float rounding of a .5
    # may round the other way in one framework; allow a handful of pixels
    assert np.mean(got != want) <= 2e-3
    assert np.mean(got == -1.0) == pytest.approx(np.mean(want == -1.0),
                                                 abs=2e-3)


def test_sample_affine_params_ranges():
    gen = torch.Generator().manual_seed(0)
    ang, ty, tx, sc = augment.sample_affine_params(gen, 1000, 5, 100, 200)
    assert float(ang.abs().max()) <= 5.0 and float(ang.abs().max()) > 4.0
    assert torch.equal(tx, tx.round()) and float(tx.abs().max()) <= 20.0
    assert float(ty.abs().max()) <= 10.0
    assert float((sc - 1).abs().max()) <= 0.1
    zero = augment.sample_affine_params(gen, 3, 0, 100, 200)
    assert [v.tolist() for v in zero] == [[0.0] * 3, [0.0] * 3, [0.0] * 3,
                                          [1.0] * 3]


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((5, 7), (10, 14)),
                                     ((16, 16), (16, 16))])
def test_interpolate_bilinear_matches_jax(src, dst):
    x = _rand((2, *src, 3), 10)
    got = resize.interpolate_bilinear(_t(x), dst).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jax_resize.interpolate_bilinear(x, dst)), atol=1e-6)


def test_max_pool_values_and_tied_grads_match_jax():
    x = np.round(_rand((2, 8, 6, 3), 11))  # integers: many tied maxima
    cot = _rand((2, 4, 3, 3), 12)

    def jloss(v):
        return jnp.sum(jax_layers.max_pool(v, 2) * cot)

    x_t = _t(x, True)
    got = layers.max_pool(x_t, 2)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(jax_layers.max_pool(x, 2)))
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(x_t.grad.numpy(),
                               np.asarray(jax.grad(jloss)(x)), atol=1e-6)


def test_dual_window_from_stored_is_bit_exact_on_every_uint16():
    raw = np.arange(65536, dtype=np.uint32).astype(np.uint16).reshape(
        1, 256, 256, 1)
    want = jax_windowing.dual_window_from_stored(raw)
    got = windowing.dual_window_from_stored(torch.from_numpy(
        raw.astype(np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        windowing.fullrange_from_stored(torch.from_numpy(
            raw.astype(np.int32))).numpy(),
        np.asarray(jax_windowing.fullrange_from_stored(raw)))
    # the arithmetic form: the host codec's values; XLA's may differ by an
    # ulp (it turns the divisions into reciprocal multiplies)
    stored = raw[0, ::37, ::41, 0].astype(np.float32) % 4096
    for g, w in zip(windowing.dual_window(stored),
                    jax_windowing.dual_window(stored)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    kw = dict(n_patients=2, slices_per_patient=3, size=48, seed=5)
    root_j = str(tmp_path_factory.mktemp("jax_corpus"))
    root_t = str(tmp_path_factory.mktemp("port_corpus"))
    return (root_j, jax_fixtures.make_corpus(root_j, **kw),
            root_t, fixtures.make_corpus(root_t, **kw))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_make_corpus_matches_jax(corpora):
    root_j, lists_j, root_t, lists_t = corpora
    assert _tree(root_t) == _tree(root_j)
    assert set(lists_t) == set(lists_j)
    for name in lists_j:
        with open(lists_j[name]) as f:
            want = [os.path.relpath(p, root_j) for p in f.read().split()]
        with open(lists_t[name]) as f:
            got = [os.path.relpath(p, root_t) for p in f.read().split()]
        assert got == want
    for rel in _tree(root_j):
        if not os.path.basename(rel).startswith("IM"):
            continue
        with open(os.path.join(root_t, rel), "rb") as f:
            ds = dicom.read_dicom(f.read())
        ds_j = jax_dicom.read_dicom(os.path.join(root_j, rel))
        np.testing.assert_array_equal(ds.pixel_array(), ds_j.pixel_array())
        for tag in (dicom.TAG_PATIENT_ID, dicom.TAG_SERIES_DESC,
                    dicom.TAG_SLICE_LOCATION, dicom.TAG_ACCESSION):
            assert ds.get_str(tag) == ds_j.get_str(tag)


@pytest.mark.parametrize("raw_feed", [True, False])
def test_dual_window_dataset_items_match_jax(corpora, raw_feed):
    root_j, lists_j, _, _ = corpora
    # a traind2 list exercises the oversampling redraw
    with open(lists_j["train"]) as f:
        first = f.read().split()[0]
    d2 = lists_j["train"].replace("train", "traind2")
    with open(d2, "w") as f:
        f.write(first + "\n")
    kw = dict(oversample=True, size=32, raw_feed=raw_feed)
    ds = datasets.DualWindowDataset(lists_j["train"],
                                    rng=np.random.default_rng(3), **kw)
    ds_j = jax_datasets.DualWindowDataset(lists_j["train"],
                                          rng=np.random.default_rng(3), **kw)
    os.remove(d2)
    assert ds.files_a == ds_j.files_a and ds.files_b == ds_j.files_b
    assert len(ds) > len(ds.base)
    for i in range(len(ds)):
        got, want = ds[i], ds_j[i]
        assert set(got) == set(want)
        for k in want:
            if k.endswith("_path"):
                assert got[k] == want[k]
            else:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64), "A_path": f"p{i}"}


def test_prefetch_loader_order_matches_jax():
    kw = dict(batch_size=3, shuffle=True, drop_last=True, num_threads=3)
    got = loader.PrefetchLoader(_Items(11), rng=np.random.default_rng(9),
                                **kw)
    want = jax_loader.PrefetchLoader(_Items(11),
                                     rng=np.random.default_rng(9), **kw)
    assert len(got) == len(want) == 3
    for _ in range(2):  # two epochs: the rng reshuffles each
        gb, wb = list(got), list(want)
        assert [b["A_path"] for b in gb] == [b["A_path"] for b in wb]
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g["x"], w["x"])


def test_prefetch_loader_many_threads_keep_order():
    """More decode threads than cores, with a short switch interval: every
    batch arrives once, complete and in order."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ld = loader.PrefetchLoader(_Items(203), batch_size=4, shuffle=True,
                                   num_threads=32, prefetch=2,
                                   rng=np.random.default_rng(1))
        order = np.random.default_rng(1).permutation(203)
        batches = list(ld)
    finally:
        sys.setswitchinterval(old)
    assert len(batches) == len(ld) == 51
    got = np.concatenate([b["x"][:, 0] for b in batches])
    np.testing.assert_array_equal(got, order)


def test_prefetch_loader_surfaces_decode_errors():
    class Bad(_Items):
        def __getitem__(self, i):
            if i == 2:
                raise OSError("unreadable")
            return super().__getitem__(i)

    with pytest.raises(RuntimeError, match="decode"):
        list(loader.PrefetchLoader(Bad(4), batch_size=2))


@pytest.mark.parametrize("family,mode", [("hd1", "reference"),
                                         ("hd1", "linear"),
                                         ("reg", "reference")])
def test_update_learning_rate_matches_jax(family, mode):
    cfg = types.SimpleNamespace(lr=2e-4, decay_epoch=4, decay_mode=mode)

    def stub(cls):
        obj = types.SimpleNamespace(config=cfg, quiet=True, family=family,
                                    lr=2e-4, lr_d=1e-4)
        return obj, lambda: cls.update_learning_rate(obj)

    port, port_step = stub(TrainerBase)
    ref, ref_step = stub(JaxTrainerBase)
    seen = []
    for _ in range(6):
        port_step()
        ref_step()
        assert (port.lr, port.lr_d) == (ref.lr, ref.lr_d)
        seen.append(port.lr)
    assert seen[0] < 2e-4 and seen == sorted(seen, reverse=True)
    if family == "hd1":
        assert port.lr_d == 1e-4  # the HD family's D lr never decays
    else:
        assert port.lr_d == port.lr
