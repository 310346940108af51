"""Parity: the port's fused conv functions (K1 conv3x3_reflect_stats, K3
conv3x3_s2_zero_stats, K2 convt2x_stats) against the JAX Pallas kernels in
interpret mode, on the same numpy inputs.

On the CPU each port function runs its plain PyTorch version (the CUDA
kernels are checked against those on the card by chip_smoke.py), so these
tests pin the plain versions, and with them the kernels' oracle, to the JAX
semantics: prologue order, reflect/zero boundaries, phase form, stats of the
rounded output. Tolerances: f32 outputs atol 1e-4 and stats rtol 1e-3 (as
tests/test_fused_down.py); bf16 outputs atol 5e-2, one bf16 ulp at these
magnitudes from the different accumulation order (as
test_fused_chain_bfloat16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.ops.fused_convt import convt2x_stats as jax_convt
from ctagan_tpu.ops.fused_down import conv3x3_s2_zero_stats as jax_down
from ctagan_tpu.ops.fused_resblock import (
    conv3x3_reflect_stats as jax_resblock,
)
from ctagan_tpu.ops.fused_resblock import fused_residual_block as jax_block
from ctagan_tpu.ops.fused_resblock import fused_residual_chain as jax_chain
from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops.fused_convt import convt2x_stats, phase_deblock
from ctagan_tpu_torch.ops.fused_down import conv3x3_s2_zero_stats
from ctagan_tpu_torch.ops.fused_resblock import (
    conv3x3_reflect_stats,
    fused_residual_block,
    fused_residual_chain,
)

torch.set_num_threads(2)

ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _rand(shape, seed, scale=1.0, dtype="float32"):
    """Seeded numpy input, rounded to ``dtype``'s values (as f32)."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _norm_of(x):
    """(N, 2, C) [mean, rstd] of an NHWC numpy array."""
    mean = x.mean(axis=(1, 2))
    rstd = 1.0 / (x.std(axis=(1, 2)) + 1e-3)
    return np.stack([mean, rstd], axis=1).astype(np.float32)


def _both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _assert_close(got, want, dtype, stats_got=None, stats_want=None,
                  count=None):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=ATOL[dtype])
    if stats_got is None:
        return
    sg, sw = stats_got.numpy(), np.asarray(stats_want)
    if dtype == "float32":
        np.testing.assert_allclose(sg, sw, rtol=1e-3, atol=1e-3)
    else:
        # bf16: ulp flips of single rounded outputs move the sums; compare
        # per-pixel mean and second moment at the outputs' own tolerance
        np.testing.assert_allclose(sg / count, sw / count, atol=ATOL[dtype])


K1_VARIANTS = ["plain", "norm_relu", "norm_skip", "emit_norm_relu"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", K1_VARIANTS)
def test_k1_conv3x3_reflect_stats_matches_jax(variant, dtype):
    shape = (2, 16, 128, 128)
    x = _rand(shape, 0, dtype=dtype)
    w = _rand((3, 3, 128, 128), 1, 0.05)
    b = _rand((128,), 2)
    kw = {}
    if variant != "plain":
        kw["norm"] = _norm_of(x)
    if variant in ("norm_relu", "emit_norm_relu"):
        kw["relu"] = True
    if variant == "norm_skip":
        kw["skip"] = _rand(shape, 3, dtype=dtype)
    if variant == "emit_norm_relu":
        kw["emit_input"] = True
    xj, xt = _both(x, dtype)
    jkw = {k: (jnp.asarray(v).astype(xj.dtype) if k == "skip" else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v).to(xt.dtype) if k == "skip"
               else torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jax_resblock(xj, jnp.asarray(w), jnp.asarray(b), interpret=True,
                        **jkw)
    got = conv3x3_reflect_stats(xt, torch.from_numpy(w), torch.from_numpy(b),
                                **tkw)
    assert len(got) == len(want)
    assert got[0].dtype == xt.dtype and got[1].dtype == torch.float32
    _assert_close(got[0], want[0].astype(jnp.float32), dtype, got[1],
                  want[1], count=16 * 128)
    if len(got) == 3:  # emitted conv input x_new
        _assert_close(got[2], want[2].astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,co", [(64, 128), (128, 256)])
def test_k3_conv3x3_s2_zero_stats_matches_jax(c, co, dtype):
    x = _rand((2, 16, 256, c), 10, dtype=dtype)
    w = _rand((3, 3, c, co), 11, 0.05)
    b = _rand((co,), 12)
    norm = _norm_of(x)
    xj, xt = _both(x, dtype)
    out_j, st_j = jax_down(xj, jnp.asarray(w), jnp.asarray(b),
                           norm=jnp.asarray(norm), relu=True, interpret=True)
    out_t, st_t = conv3x3_s2_zero_stats(
        xt, torch.from_numpy(w), torch.from_numpy(b),
        norm=torch.from_numpy(norm), relu=True)
    assert out_t.shape == (2, 8, 128, co) and out_t.dtype == xt.dtype
    _assert_close(out_t, out_j.astype(jnp.float32), dtype, st_t, st_j,
                  count=8 * 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,co,prenorm", [(256, 128, False),
                                          (128, 64, True)])
def test_k2_convt2x_stats_matches_jax(c, co, prenorm, dtype):
    x = _rand((1, 8, 128, c), 20, dtype=dtype)
    kernel_jax = _rand((3, 3, co, c), 21, 0.05)  # flax (kh, kw, O, I)
    b = _rand((co,), 22)
    norm = _norm_of(x) if prenorm else None
    xj, xt = _both(x, dtype)
    pb, st_j = jax_convt(xj, jnp.asarray(kernel_jax), jnp.asarray(b),
                         norm=None if norm is None else jnp.asarray(norm),
                         relu=prenorm, interpret=True)
    # torch ConvTranspose2d layout (I, O, kh, kw)
    kernel_t = torch.from_numpy(np.ascontiguousarray(
        kernel_jax.transpose(3, 2, 0, 1)))
    out_t, st_t = convt2x_stats(
        xt, kernel_t, torch.from_numpy(b),
        norm=None if norm is None else torch.from_numpy(norm), relu=prenorm)
    assert out_t.shape == (1, 16, 256, co)
    pb_t = torch.from_numpy(np.array(pb.astype(jnp.float32)))
    _assert_close(out_t, phase_deblock(pb_t, co), dtype, st_t, st_j,
                  count=16 * 256)


@pytest.mark.parametrize("orchestration", ["block", "chain"])
def test_k1_residual_orchestration_matches_jax(orchestration):
    """fused_residual_block, and the chain's in_norm into block 0 and
    skip folding, against the JAX functions."""
    x = _rand((1, 8, 128, 128), 30)
    params = [tuple(_rand(s, 31 + 4 * i + j, 0.05 if len(s) > 1 else 0.1)
                    for j, s in enumerate(((3, 3, 128, 128), (128,),
                                           (3, 3, 128, 128), (128,))))
              for i in range(2)]
    raw = x.reshape(1, -1, 128)
    mean, var = raw.mean(1), raw.var(1)
    in_norm = np.stack([mean, 1.0 / np.sqrt(var + 1e-5)], 1).astype(
        np.float32)
    if orchestration == "block":
        want = jax_block(jnp.asarray(x), *map(jnp.asarray, params[0]),
                         interpret=True)
        got = fused_residual_block(torch.from_numpy(x),
                                   *map(torch.from_numpy, params[0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        return
    want = jax_chain(jnp.asarray(x), [tuple(map(jnp.asarray, p))
                                      for p in params],
                     in_norm=jnp.asarray(in_norm), in_relu=True,
                     interpret=True)
    got = fused_residual_chain(
        torch.from_numpy(x), [tuple(map(torch.from_numpy, p))
                              for p in params],
        in_norm=torch.from_numpy(in_norm), in_relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_wrappers_count_only_kernel_launches():
    """A CPU tensor takes the plain version and launches nothing."""
    before = (conv3x3_reflect_stats.launches, conv3x3_s2_zero_stats.launches,
              convt2x_stats.launches)
    x = torch.zeros(1, 4, 4, 16)
    conv3x3_reflect_stats(x, torch.zeros(3, 3, 16, 64), torch.zeros(64))
    conv3x3_s2_zero_stats(x, torch.zeros(3, 3, 16, 64), torch.zeros(64))
    convt2x_stats(x, torch.zeros(16, 64, 3, 3), torch.zeros(64))
    assert (conv3x3_reflect_stats.launches, conv3x3_s2_zero_stats.launches,
            convt2x_stats.launches) == before


@pytest.mark.parametrize("bad", ["skip_without_norm", "emit_with_skip",
                                 "wrong_weight", "int_dtype", "short_bias"])
def test_k1_rejects_bad_arguments(bad):
    x = torch.zeros(1, 4, 4, 16)
    w, b = torch.zeros(3, 3, 16, 64), torch.zeros(64)
    norm = torch.zeros(1, 2, 16)
    kw = {
        "skip_without_norm": dict(skip=x),
        "emit_with_skip": dict(norm=norm, skip=x, emit_input=True),
        "wrong_weight": dict(w=torch.zeros(3, 3, 8, 64)),
        "int_dtype": dict(x=torch.zeros(1, 4, 4, 16, dtype=torch.int32)),
        "short_bias": dict(b=torch.zeros(32)),
    }[bad]
    args = {"x": x, "w": w, "b": b}
    args.update(kw)
    with pytest.raises((ValueError, TypeError)):
        conv3x3_reflect_stats(**args)


@pytest.mark.parametrize("fn,weight", [
    (conv3x3_reflect_stats, (3, 3, 16, 64)),
    (conv3x3_s2_zero_stats, (3, 3, 16, 64)),
    (convt2x_stats, (16, 64, 3, 3)),
])
def test_bias_length_checked_before_dispatch(fn, weight):
    """A bias that is not (Cout,) raises the same ValueError on the plain
    path as on the kernel path (the kernel would read past its end)."""
    with pytest.raises(ValueError, match="bias must be"):
        fn(torch.zeros(1, 4, 4, 16), torch.zeros(weight), torch.zeros(63))


def test_build_flags_target_hopper():
    """The kernels build for sm_90a from the package's own sources."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    cu, cuh = _build._sources()
    names = sorted(p.rsplit("/", 1)[-1] for p in cu)
    assert names == ["fused_convt.cu", "fused_down.cu", "fused_resblock.cu",
                     "fused_s8.cu", "instance_norm.cu"]
    assert cuh and _build.BUILD_DIR.endswith("build/ctagan_tpu_torch")
