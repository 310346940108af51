"""Parity: the port's residual-body backward (K4 conv3x3_input_grad, K5
conv3x3_weight_grad, the FusedChainFunction custom VJP) against the JAX
package's Pallas kernels in interpret mode and its ``fused_chain_vjp_make``,
on the same numpy inputs.

On the CPU each port function runs its plain PyTorch version (the CUDA
kernels are held against those on the card by chip_smoke.py). Tolerances,
as tests/test_fused_grad.py states them for the same shapes: input grads
atol 2e-4 (f32 sums over K = 9·128 in another order); weight grads atol
5e-3 with rtol 1e-4 (sums over up to 2·16·128 pixels); the chain's forward
atol 2e-4, its gradients atol 3e-3 (x) and 5e-3 / rtol 1e-3 (params), since
the two IN backwards amplify f32 reordering. The float64 gradcheck holds the
hand-written backward to finite differences of the forward.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.ops.fused_resblock_grad import (
    conv3x3_input_grad as jax_input_grad,
)
from ctagan_tpu.ops.fused_resblock_grad import (
    conv3x3_weight_grad as jax_weight_grad,
)
from ctagan_tpu.ops.fused_resblock_grad import fused_chain_vjp_make
from ctagan_tpu_torch.ops.fused_resblock_grad import (
    FusedChainFunction,
    conv3x3_input_grad,
    conv3x3_weight_grad,
    fused_chain,
)

torch.set_num_threads(2)

EPS = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _norm_of(h):
    m = h.mean(axis=(1, 2))
    v = np.maximum((h * h).mean(axis=(1, 2)) - m * m, 0.0)
    return np.stack([m, 1.0 / np.sqrt(v + EPS)], axis=1).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 128, 128), (1, 32, 128, 128)],
                         ids=["batch2", "tall"])
def test_k4_input_grad_matches_jax(shape):
    g = _rand(shape, 2)
    w = _rand((3, 3, 128, 128), 1, 0.05)
    want = jax_input_grad(jnp.asarray(g), jnp.asarray(w), interpret=True)
    got = conv3x3_input_grad(torch.from_numpy(g), torch.from_numpy(w))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_k4_input_grad_bfloat16_matches_jax():
    """bf16: the interior is rounded to bf16 before the f32 folds are added
    (the JAX rounding points); one bf16 ulp of slack at these magnitudes."""
    g = torch.from_numpy(_rand((1, 8, 16, 64), 3)).bfloat16()
    w = _rand((3, 3, 64, 64), 4, 0.05)
    want = jax_input_grad(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(w), interpret=True)
    got = conv3x3_input_grad(g, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2)


@pytest.mark.parametrize("variant", ["plain", "norm_relu", "norm_relu_skip"])
def test_k5_weight_grad_matches_jax(variant):
    x = _rand((2, 16, 128, 128), 6)
    g = _rand((2, 16, 128, 128), 8)
    kw = {}
    if variant != "plain":
        kw = dict(norm=_norm_of(x), relu=True)
    if variant == "norm_relu_skip":
        kw["skip"] = _rand(x.shape, 9)
    want = jax_weight_grad(jnp.asarray(x), jnp.asarray(g), interpret=True,
                           **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                  else v) for k, v in kw.items()})
    got = conv3x3_weight_grad(
        torch.from_numpy(x), torch.from_numpy(g),
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    assert got.shape == (3, 3, 128, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3,
                               rtol=1e-4)


def _chain_params(n_blocks, c=128):
    return [(_rand((3, 3, c, c), 30 + i, 0.05), _rand((c,), 40 + i, 0.01),
             _rand((3, 3, c, c), 50 + i, 0.05), _rand((c,), 60 + i, 0.01))
            for i in range(n_blocks)]


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_chain_function_matches_jax_vjp(n_blocks):
    import jax

    x = _rand((1, 8, 128, 128), 20)
    params = _chain_params(n_blocks)
    cot = _rand((1, 8, 128, 128), 70)
    chain = fused_chain_vjp_make(eps=EPS, interpret=True)
    jparams = [tuple(jnp.asarray(t) for t in blk) for blk in params]

    def loss(x_, p_):
        return jnp.sum(chain(x_, p_) * jnp.asarray(cot))

    want_out = chain(jnp.asarray(x), jparams)
    want_gx, want_gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jparams)

    xt = torch.from_numpy(x).requires_grad_(True)
    pt = [tuple(torch.from_numpy(t).requires_grad_(True) for t in blk)
          for blk in params]
    out = fused_chain(xt, pt, eps=EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=2e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx),
                               atol=3e-3)
    for blk_t, blk_j in zip(pt, want_gp):
        for t, j in zip(blk_t, blk_j):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       atol=5e-3, rtol=1e-3)


def test_chain_function_gradcheck_float64():
    """Finite differences of the forward against the hand-written backward,
    in float64, two blocks (the skip prologue of block 1 included): the
    reordered-gradient trap that f32 cannot show."""
    rng = np.random.default_rng(5)
    c = 4

    def t(shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale).requires_grad_(
            True)

    x = t((1, 4, 5, c))
    flat = []
    for _ in range(2):
        flat += [t((3, 3, c, c), 0.3), t((c,), 0.1), t((3, 3, c, c), 0.3),
                 t((c,), 0.1)]
    assert torch.autograd.gradcheck(
        lambda x_, *p: FusedChainFunction.apply(x_, EPS, *p), (x, *flat),
        eps=1e-6, atol=1e-5, rtol=1e-4)
