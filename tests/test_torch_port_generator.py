"""Parity: the port's Generator, param converter and config reader against
the JAX package, on the same weights and numpy inputs (CPU; the fused route
runs the kernels' plain versions here)."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.models.torch_export import (
    generator_state_dict as jax_generator_state_dict,
)
from ctagan_tpu.utils.config import load_config as jax_load_config
from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.models.convert import generator_state_dict
from ctagan_tpu_torch.utils.config import (
    Config,
    load_config,
    parse_flat_yaml,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_from_jax(params, **kw):
    g = Generator(**kw)
    g.load_state_dict(generator_state_dict(jax.device_get(params)),
                      strict=True)
    return g.eval()


@pytest.fixture(scope="module")
def fused_up_case():
    """The configuration that engages all three JAX kernels
    (test_generator_fused_up_path_parity): body 4x128x256, up1 8x256x128,
    up2 16x512x64."""
    kw = dict(n_residual_blocks=1, base_features=64, tap_heads=False)
    x = _input((1, 16, 512, 1))
    g = JaxGenerator(1, 1, fused_body=True, **kw)
    params = g.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return x, params, np.asarray(g.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("fused_body", [True, False])
def test_generator_matches_jax_fused(fused_up_case, fused_body):
    x, params, want = fused_up_case
    g = _port_from_jax(params, input_nc=1, output_nc=1, n_residual_blocks=1,
                       base_features=64, fused_body=fused_body)
    with torch.no_grad():
        got = g(torch.from_numpy(x))
    assert got.shape == (1, 16, 512, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_generator_zero_pad_matches_jax():
    """pad_mode 'zero' has no fused path: on the CPU the port runs its layer
    route, which must equal the JAX zero-pad generator."""
    x = _input((1, 32, 32, 1), 3)
    g_jax = JaxGenerator(1, 1, n_residual_blocks=2, base_features=16,
                         pad_mode="zero", tap_heads=False)
    params = g_jax.init(jax.random.PRNGKey(1), jnp.asarray(x))
    g = _port_from_jax(params, n_residual_blocks=2, base_features=16,
                       pad_mode="zero")
    with torch.no_grad():
        got = g(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(g_jax.apply(params, x)), atol=2e-5)


def test_converter_matches_torch_export_and_full_width_count():
    g_jax = JaxGenerator(1, 1)
    params = jax.device_get(g_jax.init(jax.random.PRNGKey(2),
                                       jnp.zeros((1, 32, 32, 1))))
    want = jax_generator_state_dict(params)
    got = generator_state_dict(params)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    g = Generator(1, 1, n_residual_blocks=9, base_features=64)
    g.load_state_dict(got, strict=True)
    assert sum(p.numel() for p in g.parameters()) == 11_365_633
    assert set(g.state_dict()) == set(want)


def test_seeded_init_is_deterministic_and_torch_scaled():
    a = Generator(1, 1, n_residual_blocks=1).reset_parameters(7)
    b = Generator(1, 1, n_residual_blocks=1).reset_parameters(7)
    c = Generator(1, 1, n_residual_blocks=1).reset_parameters(8)
    for (k, pa), pb, pc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(pa, pb), k
        assert not torch.equal(pa, pc), k
    w = a.model_body[0].conv_block[1].weight.detach()  # fan_in 256·9
    assert float(w.abs().max()) <= 1.0 / np.sqrt(256 * 9)
    wt = a.model_tail[0].weight.detach()  # ConvTranspose fan_in = O·9 = 128·9
    assert float(wt.abs().max()) <= 1.0 / np.sqrt(128 * 9)
    assert float(wt.abs().max()) > 1.0 / np.sqrt(256 * 9)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_reader_matches_jax(path):
    ref = jax_load_config(path)
    cfg = load_config(path)
    for f in ("name", "size", "input_nc", "output_nc", "context_slices",
              "compute_dtype", "pad_mode", "seed", "generator_ckpt"):
        assert getattr(cfg, f) == getattr(ref, f), f
    for k, v in ref.extras.items():
        assert cfg.extras[k] == v, k
    assert cfg.serve_port == int(ref.extras.get("serve_port", 8080))
    assert cfg.max_batch == 16 and cfg.serve_quantize == ""


@pytest.mark.parametrize("text", [
    "mesh:\n  dp: 2", "a: [1, 2]", "a: {b: 1}", "  indented: 1",
    "a: 'unterminated", "not a key value", "a: - 1",
])
def test_config_reader_rejects_what_it_cannot_parse(text):
    with pytest.raises(ValueError):
        parse_flat_yaml(text)


def test_config_reader_scalars():
    raw = parse_flat_yaml(
        "a: 1\nb: 0.0001\nc: True\nd: 'x # y'  # note\ne: plain text\n"
        "f: ~\ng: -3\nh: 1.0e-4\ni: 1e-4\n# comment\n\nserve_port: 9000\n")
    assert raw == {"a": 1, "b": 0.0001, "c": True, "d": "x # y",
                   "e": "plain text", "f": None, "g": -3, "h": 1e-4,
                   "i": "1e-4",  # YAML 1.1, as PyYAML reads it
                   "serve_port": 9000}
    cfg = load_config({"serve_port": 9000, "size": 64})
    assert isinstance(cfg, Config) and cfg.serve_port == 9000
    with pytest.raises(ValueError):
        load_config({"size": 30})
