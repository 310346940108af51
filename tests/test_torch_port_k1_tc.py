"""K1 on the tensor cores: the arithmetic of the CUDA kernel's f32 route,
checked on the CPU.

The kernel (``csrc/fused_resblock.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version. What it computes
beyond that plain version is fixed here: the K-major (Cout, 9·C) weight it
reads, the 3xTF32 split of its f32 operands (hi = tf32(v), lo = tf32(v −
hi)), and the three products lo·hi + hi·lo + hi·hi summed in f32. A plain
emulation of that scheme, at K1's depth K = 9·256, stays within 2e-5 of
the output's scale of JAX's ``conv3x3_reflect_stats`` in interpret mode
and of the port's plain version (the smoke's f32 tolerance is 1e-4); one
TF32 rounding of each operand does not. The kernel's shape limits raise
ValueError from a check that runs on any device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctagan_tpu.ops.fused_resblock import (
    conv3x3_reflect_stats as jax_resblock,
)
from ctagan_tpu_torch.models.layers import reflect_pad
from ctagan_tpu_torch.ops.fused_resblock import (
    check_k1_kernel_limits,
    conv3x3_reflect_stats,
    conv3x3_reflect_stats_plain,
    k1_weight,
    round_tf32,
    split_tf32,
)

torch.set_num_threads(2)

EMULATION_TOL = 2e-5  # scaled: max |err| / max(1, max |ref|)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("seed,scale", [(0, 0.02), (1, 1.0), (2, 300.0)])
def test_split_tf32_parts_sum_to_w(seed, scale):
    w = torch.from_numpy(_rand((3, 3, 64, 128), seed, scale))
    hi, lo = split_tf32(w)
    for part in (hi, lo):  # TF32 values: the low 13 mantissa bits are 0
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = ((hi.double() + lo.double() - w.double()).abs()
           / w.double().abs()).max()
    assert float(err) <= 2.0 ** -21
    # one rounding alone is ~2^-12 off: the lo part carries the rest
    assert float(((hi.double() - w.double()).abs()
                  / w.double().abs()).max()) > 2.0 ** -16


def test_round_tf32_is_nearest_ties_away():
    # 1 + 2^-11 is half a TF32 ulp above 1: it rounds away, to 1 + 2^-10
    t = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 0.0, 3.0e-5], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         0.0], dtype=torch.float32)
    got = round_tf32(t)
    assert torch.equal(got[:5], want)
    assert float((got[5] - t[5]).abs() / t[5]) <= 2.0 ** -11


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_weight_is_k_major(dtype):
    """(3, 3, C, Cout) -> (Cout, 9·C) with K = (ky, kx, c), as the kernel
    reads it; f32 as TF32 (hi, lo), bf16 as the rounded weight."""
    w = torch.from_numpy(_rand((3, 3, 64, 128), 5, 0.05))
    hi, lo = k1_weight(w, dtype)
    assert hi.shape == (128, 9 * 64) and hi.is_contiguous()
    want = w.reshape(9 * 64, 128).t()
    if dtype == torch.bfloat16:
        assert lo is None and hi.dtype == torch.bfloat16
        assert torch.equal(hi, want.to(torch.bfloat16))
    else:
        assert lo.shape == hi.shape and lo.is_contiguous()
        assert torch.equal((hi, lo)[0], split_tf32(want)[0])
        assert float((hi + lo - want).abs().max()) <= 2.0 ** -21 * float(
            want.abs().max())


def _k1_case(seed):
    """A K1 call at the body's depth (C = 256, K = 2304) with norm, ReLU
    and skip, on numpy inputs; W = 128 for the JAX kernel's limits."""
    shape = (1, 8, 128, 256)
    x = _rand(shape, seed)
    mean, std = x.mean(axis=(1, 2)), x.std(axis=(1, 2))
    norm = np.stack([mean, 1.0 / (std + 1e-3)], axis=1).astype(np.float32)
    return dict(x=x, w=_rand((3, 3, 256, 128), seed + 1, 0.02),
                b=_rand((128,), seed + 2, 0.1), norm=norm,
                skip=_rand(shape, seed + 3))


def _emulate(case, split):
    """The kernel's f32 arithmetic: its prologue (the plain version's x_new),
    reflect pad, both operands through ``split``, the products summed in f32
    on the CPU, the bias added."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    _, _, xs = conv3x3_reflect_stats_plain(t["x"], t["w"], t["b"],
                                           norm=t["norm"], relu=True,
                                           skip=t["skip"])
    a_parts = split(reflect_pad(xs, 1).permute(0, 3, 1, 2))
    b_parts = split(t["w"].permute(3, 2, 0, 1))
    if len(a_parts) == 1:
        y = F.conv2d(a_parts[0], b_parts[0])
    else:
        (a_hi, a_lo), (b_hi, b_lo) = a_parts, b_parts
        y = (F.conv2d(a_lo, b_hi) + F.conv2d(a_hi, b_lo)
             + F.conv2d(a_hi, b_hi))
    return (y + t["b"][:, None, None]).permute(0, 2, 3, 1)


def _references(case):
    want_jax = jax_resblock(
        jnp.asarray(case["x"]), jnp.asarray(case["w"]),
        jnp.asarray(case["b"]), norm=jnp.asarray(case["norm"]), relu=True,
        skip=jnp.asarray(case["skip"]), interpret=True)[0]
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    want_plain = conv3x3_reflect_stats(t["x"], t["w"], t["b"],
                                       norm=t["norm"], relu=True,
                                       skip=t["skip"])[0]
    return np.asarray(want_jax), want_plain.numpy()


@pytest.mark.parametrize("seed", [10, 20])
def test_three_tf32_products_match_jax_and_plain(seed):
    case = _k1_case(seed)
    got = _emulate(case, split_tf32).numpy()
    want_jax, want_plain = _references(case)
    assert _scaled_err(got, want_jax) <= EMULATION_TOL
    assert _scaled_err(got, want_plain) <= EMULATION_TOL


def test_one_tf32_rounding_misses_the_tolerance():
    """Why three products: one TF32 rounding of each operand (a single
    TF32 pass) is an order of magnitude past the bound."""
    case = _k1_case(10)
    got = _emulate(case, lambda t: (round_tf32(t),)).numpy()
    want_jax, _ = _references(case)
    assert _scaled_err(got, want_jax) > 10 * EMULATION_TOL


@pytest.mark.parametrize("bad,match", [
    (dict(c=96), "C % 64"),
    (dict(cout=192), "Cout % 128"),
    (dict(c=4096), "C <= 2048"),
    (dict(norm_shape=(1, 2, 32)), "norm must be"),
    (dict(offset=1), "16-byte aligned"),
])
def test_k1_kernel_limits_raise(bad, match):
    c, cout = bad.get("c", 64), bad.get("cout", 128)
    base = torch.zeros(1 * 4 * 4 * c + 16)
    x = base[bad.get("offset", 0):][:4 * 4 * c].view(1, 4, 4, c)
    norm = torch.zeros(bad.get("norm_shape", (1, 2, c)))
    with pytest.raises(ValueError, match=match):
        check_k1_kernel_limits(x, cout, norm)


@pytest.mark.parametrize("c,cout", [(64, 128), (256, 256), (128, 384)])
def test_k1_kernel_limits_accept_the_body(c, cout):
    x = torch.zeros(2, 5, 3, c)  # any N, H, W: the ragged tile is masked
    check_k1_kernel_limits(x, cout, torch.zeros(2, 2, c), torch.zeros_like(x))
