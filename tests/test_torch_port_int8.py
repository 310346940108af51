"""Parity: the port's int8 serving path (``ops/quantize.py``, K7
``ops/fused_s8.py``) and its fused InstanceNorm (K6
``ops/pallas_kernels.py``) against the JAX package, on the same numpy
inputs and weights. JAX runs its Pallas kernels in interpret mode.

On the CPU each kernel wrapper runs its plain PyTorch version (the CUDA
kernels are held against those on the card by chip_smoke.py). Tolerances:

- weights, scales and the whole quantized tree: bit-equal (the same f32
  operations, round half to even);
- one int8 conv (K7's plain version, ``_conv_i8``) on identical int8
  operands: the int32 sums are exact, so only the f32 dequant can differ,
  by the fused multiply-add XLA may form (1e-6 relative);
- a chain of them, or the whole forward: a last-bit difference upstream (a
  conv's or a sum's order) can move a value across an int8 rounding
  boundary, one step of the per-tensor scale, and the next InstanceNorm and
  re-quantization carry that on. So those are held to the int8 path's own
  scale of error: PSNR between port and JAX above that of JAX's int8
  against the f32 route by a stated margin, and a max error of a few steps;
- K6's plain version: f32 1e-5, bf16 two bf16 ulps (sum order, rsqrt).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.ops import fused_s8 as jax_s8
from ctagan_tpu.ops import quantize as jax_q
from ctagan_tpu.ops.pallas_kernels import instance_norm_pallas as jax_in
from ctagan_tpu_torch.models import Generator, layers
from ctagan_tpu_torch.models.convert import (
    generator_state_dict,
    quantized_generator_params,
)
from ctagan_tpu_torch.ops import fused_s8, quantize
from ctagan_tpu_torch.ops.pallas_kernels import (
    instance_norm_pallas,
    instance_norm_pallas_plain,
)

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _assert_tree_equal(want, got, path="qp"):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in want:
            _assert_tree_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_tree_equal(w, g, f"{path}/{i}")
    else:
        w, g = np.asarray(want), got.numpy()
        assert (w.dtype, w.shape) == (g.dtype, g.shape), path
        assert np.array_equal(w, g), path


def _psnr(a, b):  # over the [-1, 1] range: peak 2
    return 10.0 * np.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


@pytest.fixture(scope="module", params=["k7_branch", "loop_branch"])
def generator_case(request):
    """(name, x, JAX generator, params, port generator): the K7 branch's
    body is (1, 8, 128, 128), which s8_chain_ok admits; the loop branch's
    (2, 16, 16, 256), which it refuses."""
    if request.param == "k7_branch":
        shape, kw = (1, 32, 512, 1), dict(n_residual_blocks=2,
                                         base_features=32)
    else:
        shape, kw = (2, 64, 64, 1), dict(n_residual_blocks=3)
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    g_jax = JaxGenerator(1, 1, **kw)
    params = jax.device_get(g_jax.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    g = Generator(1, 1, **kw)
    g.load_state_dict(generator_state_dict(params), strict=True)
    return request.param, x, g_jax, params, g.eval()


def test_quantize_weight_per_channel_matches_jax():
    w = _rand((3, 3, 8, 16), 0, 0.1)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    q_j, s_j = jax_q.quantize_weight_per_channel(jnp.asarray(w))
    q_t, s_t = quantize.quantize_weight_per_channel(torch.from_numpy(w))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert np.array_equal(np.asarray(q_j), q_t.numpy())
    assert np.array_equal(np.asarray(s_j), s_t.numpy())


@pytest.mark.parametrize("exact", [False, True])
def test_quantize_generator_matches_jax(generator_case, exact):
    """Every leaf bit-equal, the transposed up kernels included, from the
    port Generator loaded with the same weights."""
    _, _, _, params, g = generator_case
    want = jax.device_get(jax_q.quantize_generator(params, exact=exact))
    got = quantize.quantize_generator(g, exact=exact)
    _assert_tree_equal(want, got)
    assert (quantize.quantized_size_bytes(got)
            == jax_q.quantized_size_bytes(want))


def test_quantized_generator_params_round_trip(generator_case):
    _, x, _, params, g = generator_case
    want = quantize.quantize_generator(g)
    got = quantized_generator_params(
        jax.device_get(jax_q.quantize_generator(params)))
    _assert_tree_equal(jax.tree.map(lambda t: t.numpy(), want), got)
    # the trees are equal leaf for leaf (above), but two CPU forwards of
    # equal trees are not bit-equal every time: under several workers one
    # output differed in its last digit once (a float sum whose order the
    # CPU library picks at run time), and int8 re-quantization carries such
    # a difference on. So the forwards are compared as the int8 routes are
    # (module docstring): closer to each other than int8 is to the f32 route
    # by the margin of test_generator_int8_forward_matches_jax, and within a
    # few int8 steps (equal outputs give ~126 dB)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_got = quantize.generator_int8_forward(got, xt).numpy()
        y_want = quantize.generator_int8_forward(want, xt).numpy()
        f32 = g(xt).numpy()
    assert np.isfinite(y_got).all() and y_got.shape == y_want.shape
    assert _psnr(y_got, y_want) > _psnr(y_want, f32) + 1.5, (
        _psnr(y_got, y_want), _psnr(y_want, f32))
    assert np.abs(y_got - y_want).max() < 0.25


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["i", "ii"])
def test_conv3x3_reflect_s8_plain_matches_jax(mode, out_dtype):
    x = _rand((1, 8, 128, 128), 0)
    q, ws = jax_q.quantize_weight_per_channel(
        jnp.asarray(_rand((3, 3, 128, 128), 1, 0.05)))
    b = _rand((128,), 2, 0.1)
    jkw, tkw = {}, {}
    if mode == "i":
        xs = np.float32(np.abs(x).max() / 127.0)
        x = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
        jkw["x_scale"], tkw["x_scale"] = jnp.float32(xs), torch.tensor(xs)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    else:  # the chain's bf16 raw h1 and its norm
        xt = torch.from_numpy(x).bfloat16()
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xf = xt.float().numpy()
        norm = np.stack([xf.mean((1, 2)), 1.0 / np.sqrt(xf.var((1, 2))
                                                        + 1e-5)], 1)
        jkw["norm"] = jnp.asarray(norm.astype(np.float32))
        tkw["norm"] = torch.from_numpy(norm.astype(np.float32))
    y_j, st_j = jax_s8.conv3x3_reflect_s8(
        xj, q, ws, jnp.asarray(b), out_dtype=getattr(jnp, out_dtype),
        interpret=True, **jkw)
    before = fused_s8.conv3x3_reflect_s8.launches
    y_t, st_t = fused_s8.conv3x3_reflect_s8(  # a CPU tensor: the plain version
        xt, _t(q), _t(ws), torch.from_numpy(b),
        out_dtype=getattr(torch, out_dtype), **tkw)
    assert fused_s8.conv3x3_reflect_s8.launches == before
    assert y_t.dtype == getattr(torch, out_dtype) and st_t.shape == (1, 2, 128)
    y_j = np.asarray(y_j.astype(jnp.float32))
    if out_dtype == "float32":
        np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-6, atol=1e-6)
    else:  # one bf16 rounding of values that may differ in the last f32 bit
        np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=2 ** -7,
                                   atol=1e-6)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=1e-5,
                               atol=1e-3)


def _qblocks(n_blocks, c=128):
    jb, tb = [], []
    for i in range(n_blocks):
        q1, s1 = jax_q.quantize_weight_per_channel(
            jnp.asarray(_rand((3, 3, c, c), 10 + i, 0.05)))
        q2, s2 = jax_q.quantize_weight_per_channel(
            jnp.asarray(_rand((3, 3, c, c), 30 + i, 0.05)))
        b1, b2 = _rand((c,), 20 + i, 0.01), _rand((c,), 40 + i, 0.01)
        jb.append((q1, s1, jnp.asarray(b1), q2, s2, jnp.asarray(b2)))
        tb.append(tuple(_t(a) for a in (q1, s1, b1, q2, s2, b2)))
    return jb, tb


def test_fused_residual_chain_s8_matches_jax():
    x = _rand((1, 8, 128, 128), 7, 0.5)
    jb, tb = _qblocks(2)
    want = np.asarray(jax_s8.fused_residual_chain_s8(jnp.asarray(x), jb,
                                                     interpret=True))
    got = fused_s8.fused_residual_chain_s8(torch.from_numpy(x), tb).numpy()
    err = np.abs(got - want)
    # a last-bit difference of the stats moves a mode (ii) value across a
    # rounding boundary now and then (module docstring): ~1e-3 of the
    # trunk's range at most, ~1e-4 on average
    assert err.max() <= 1e-2 * np.abs(want).max(), err.max()
    assert err.mean() <= 1e-3, err.mean()
    assert _psnr(got / np.abs(want).max(), want / np.abs(want).max()) > 50.0


@pytest.mark.parametrize("stage", ["down", "up"])
def test_conv_i8_matches_jax(stage):
    cin, cout = 64, 128
    q, s = jax_q.quantize_weight_per_channel(
        jnp.asarray(_rand((3, 3, cin, cout), 50, 0.05)))
    c_j = {"q": q, "scale": s, "bias": jnp.asarray(_rand((cout,), 51))}
    c_t = {k: _t(v) for k, v in c_j.items()}
    x = np.maximum(_rand((2, 16, 32, cin), 52), 0.0)
    kw = (dict(stride=2, padding=(1, 1)) if stage == "down"
          else dict(stride=1, padding=(1, 2), lhs_dilation=(2, 2)))
    want = np.asarray(jax_q._conv_i8(jnp.asarray(x), c_j, **kw))
    got = quantize._conv_i8(torch.from_numpy(x), c_t, **kw).numpy()
    assert got.shape == want.shape == ((2, 8, 16, cout) if stage == "down"
                                       else (2, 32, 64, cout))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [
    (1, 8, 128, 128), (2, 128, 128, 256), (1, 4, 256, 128), (1, 2, 128, 128),
    (1, 6, 128, 128), (1, 7, 128, 128), (1, 8, 64, 128), (1, 8, 128, 64),
    (1, 8, 384, 384), (8, 128, 128), (1, 16, 16, 256),
])
def test_s8_chain_ok_matches_jax(shape):
    assert fused_s8.s8_chain_ok(shape) == jax_s8.s8_chain_ok(shape)


def test_generator_int8_forward_matches_jax(generator_case, monkeypatch):
    """The whole int8 forward on both branches of the body; the port takes
    the K7 chain exactly where JAX does."""
    name, x, g_jax, params, g = generator_case
    chain_calls = []
    chain = quantize.fused_residual_chain_s8
    monkeypatch.setattr(quantize, "fused_residual_chain_s8",
                        lambda *a, **k: chain_calls.append(1) or chain(*a, **k))
    qp_j = jax_q.quantize_generator(params)
    want = np.asarray(jax_q.generator_int8_forward(qp_j, jnp.asarray(x)))
    got = quantize.generator_int8_forward(quantize.quantize_generator(g),
                                          torch.from_numpy(x)).numpy()
    assert bool(chain_calls) == (name == "k7_branch")
    assert got.shape == want.shape and np.isfinite(got).all()
    f32 = np.asarray(g_jax.apply(params, jnp.asarray(x)))
    # both int8 forwards hold JAX's contract against the f32 route ...
    assert _psnr(got, f32) > 30.0 and _psnr(want, f32) > 30.0
    # ... and are closer to each other than JAX's int8 is to it, by a margin
    # a forward that skipped the quantization would not have (it would sit
    # at the f32 distance): measured 43.9 and 44.0 dB against 40.4 and 41.2
    # dB (K7 and loop branch), max ~0.06
    assert _psnr(got, want) > _psnr(want, f32) + 1.5, (_psnr(got, want),
                                                       _psnr(want, f32))
    assert np.abs(got - want).max() < 0.25


def test_dequant_forward_matches_generator(generator_case):
    """Exact mode: the int8 graph with f32 weights is the port Generator's
    plain route (the padding, dilation and kernel-transform plumbing)."""
    _, x, _, _, g = generator_case
    qp = quantize.quantize_generator(g, exact=True)
    xt = torch.from_numpy(x)
    got = quantize.generator_dequant_forward(qp, xt)
    g.fused_body = False
    try:
        with torch.no_grad():
            want = g(xt)
    finally:
        g.fused_body = True
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", [None, "relu", "leaky_relu"])
def test_instance_norm_pallas_plain_matches_jax(activation, dtype):
    x = _rand((2, 32, 128, 8), 60, 2.0) + 0.5
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jax_in(jnp.asarray(x).astype(getattr(jnp, dtype)),
                  activation=activation, interpret=True)
    got = instance_norm_pallas(xt, activation=activation)  # CPU: plain
    assert got.dtype == xt.dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6,
                                   atol=1e-6)


def test_use_pallas_instance_norm_switch(monkeypatch):
    """With the switch on, instance_norm takes K6 where JAX's gate admits
    the shape (here its plain version: a CPU tensor), else the clamped
    layer form; nothing launches."""
    before = instance_norm_pallas.launches
    x = torch.from_numpy(_rand((1, 16, 128, 8), 61))
    small = torch.from_numpy(_rand((1, 8, 128, 8), 62))
    off, small_off = layers.instance_norm(x, activation="relu"), \
        layers.instance_norm(small)
    monkeypatch.setattr(layers, "USE_PALLAS_INSTANCE_NORM", True)
    assert layers.pallas_norm_applies(x)
    assert not layers.pallas_norm_applies(small)  # H % 16 != 0
    on = layers.instance_norm(x, activation="relu")
    assert torch.equal(on, instance_norm_pallas_plain(x, activation="relu"))
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-5)
    assert torch.equal(layers.instance_norm(small), small_off)
    assert instance_norm_pallas.launches == before


def test_instance_norm_pallas_has_no_backward(monkeypatch):
    x = torch.from_numpy(_rand((1, 16, 128, 8), 63)).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        instance_norm_pallas(x)
    monkeypatch.setattr(layers, "USE_PALLAS_INSTANCE_NORM", True)
    with pytest.raises(RuntimeError, match="no backward"):
        layers.instance_norm(x)
    with torch.no_grad():  # no autograd record: it runs
        assert instance_norm_pallas(x).shape == x.shape


@pytest.mark.parametrize("bad", ["int8_without_scale", "raw_with_scale",
                                 "float_weight", "short_scale", "norm_shape",
                                 "out_dtype"])
def test_k7_rejects_bad_arguments(bad):
    x8 = torch.zeros(1, 4, 4, 64, dtype=torch.int8)
    kw = dict(x=x8, w_q=torch.zeros(3, 3, 64, 64, dtype=torch.int8),
              w_scale=torch.ones(64), b=torch.zeros(64),
              x_scale=torch.tensor(0.1))
    kw.update({
        "int8_without_scale": dict(x_scale=None),
        "raw_with_scale": dict(x=torch.zeros(1, 4, 4, 64),
                               norm=torch.zeros(1, 2, 64)),
        "float_weight": dict(w_q=torch.zeros(3, 3, 64, 64)),
        "short_scale": dict(w_scale=torch.ones(32)),
        "norm_shape": dict(x=torch.zeros(1, 4, 4, 64), x_scale=None,
                           norm=torch.zeros(1, 2, 32)),
        "out_dtype": dict(out_dtype=torch.float16),
    }[bad])
    with pytest.raises(ValueError):
        fused_s8.conv3x3_reflect_s8(**kw)
