"""``pad_mode: zero`` serves through the generator's layer route.

``configs/HdGan_fast.yaml`` (bf16, ``pad_mode: zero``) is built the way the
serve entry point builds it (``__main__.serving_generator``, which sets
``fused_body=True``), loaded with the JAX generator's weights, and
its forward is held against the JAX generator of the same config. JAX's
``chain_ok`` leaves zero pad out of the fused body, and so does the port on
every device: the branch that picks the layer route reads only
``pad_mode``, so this CPU run takes the route a CUDA tensor takes, and no
kernel wrapper is called (their launch counts stay where they were).

Tolerance: both sides compute in bf16 through 9 residual blocks, rounding
at other points (oneDNN vs XLA), so the tanh outputs differ at bf16 grade:
measured max 0.042, mean 0.0065 (JAX bf16 against JAX f32: 0.035, 0.0058).
Held to a max of 2^-3 and a mean of 2^-6; reflect padding in place of zero
padding is 0.94 / 0.24 away.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu_torch.__main__ import serving_generator
from ctagan_tpu_torch.models.convert import generator_state_dict
from ctagan_tpu_torch.ops import fused_convt, fused_down, fused_resblock
from ctagan_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(REPO, "configs", "HdGan_fast.yaml")


def test_hdgan_fast_serves_through_the_layer_route(tmp_path, monkeypatch):
    config = load_config(FAST)
    assert config.pad_mode == "zero" and config.compute_dtype == "bfloat16"
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 1)).astype(
        np.float32)
    g_jax = JaxGenerator(1, 1, dtype=jnp.bfloat16, pad_mode="zero",
                         fused_body=True, tap_heads=False)
    params = jax.device_get(g_jax.init(jax.random.PRNGKey(3),
                                       jnp.asarray(x)))
    want = np.asarray(g_jax.apply(params, jnp.asarray(x)).astype(
        jnp.float32))

    ckpt = tmp_path / "G.pth"
    torch.save(generator_state_dict(params), ckpt)
    config.generator_ckpt = str(ckpt)
    config.save_root = str(tmp_path / "model")
    g, path = serving_generator(config, torch.device("cpu"))
    assert path == str(ckpt)
    assert g.fused_body and g.pad_mode == "zero"
    assert g.dtype == torch.bfloat16

    def refuse(*_a, **_k):
        raise AssertionError("zero pad took the fused route")

    monkeypatch.setattr(g, "_forward_fused", refuse)
    wrappers = (fused_resblock.conv3x3_reflect_stats,
                fused_down.conv3x3_s2_zero_stats, fused_convt.convt2x_stats)
    before = [f.launches for f in wrappers]
    with torch.inference_mode():
        got = g(torch.from_numpy(x)).float().numpy()
    assert [f.launches for f in wrappers] == before
    assert got.shape == want.shape == (2, 32, 32, 1)
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= 2.0 ** -3, err.max()
    assert err.mean() <= 2.0 ** -6, err.mean()
