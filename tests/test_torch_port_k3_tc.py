"""K3 on the tensor cores: the arithmetic of the CUDA kernel's f32 route,
checked on the CPU.

The kernel (``csrc/fused_down.cu``, K1's implicit GEMM of
``csrc/conv_wgmma.cuh`` in its stride-2 mode) runs only on the card, where
``chip_smoke.py`` holds it against its plain version. What it computes
beyond that plain version is fixed here: the K-major (Cout, 9·C) weight it
reads (:func:`k1_weight`), the stride-2 gather whose zero pad lies in the
post-norm domain (a source pixel outside the image stages 0 after the
norm/ReLU prologue), the 3xTF32 split of its f32 operands, and the three
products lo·hi + hi·lo + hi·hi of each 32-channel chunk of one tap summed
apart and added in f32, taps inner. A plain emulation of that scheme at
the generator's down2 depth, K = 9·128, stays within 2e-5 of the output's
scale of JAX's ``conv3x3_s2_zero_stats`` in interpret mode and of the
port's plain version (the smoke's f32 tolerance is 1e-4); one TF32
rounding of each operand does not, and neither does staging the norm of
the halo's zeros. The kernel's shape limits raise ValueError from a check
that runs on any device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctagan_tpu.ops.fused_down import conv3x3_s2_zero_stats as jax_down
from ctagan_tpu_torch.ops.fused_down import (
    check_k3_kernel_limits,
    conv3x3_s2_zero_stats,
)
from ctagan_tpu_torch.ops.fused_resblock import (
    k1_weight,
    round_tf32,
    split_tf32,
)

torch.set_num_threads(2)

EMULATION_TOL = 2e-5  # scaled: max |err| / max(1, max |ref|)
CHUNK = 32  # channels per K chunk of the f32 route: one 128-byte row


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_weight_is_k_major(dtype):
    """The B the wrapper builds from down1's (3, 3, 64, 128) weight:
    entry (o, (3 ky + kx)·C + c) is w[ky, kx, c, o]; f32 as TF32 (hi, lo)
    that sum back to it, bf16 as it rounded."""
    c, cout = 64, 128
    w = torch.from_numpy(_rand((3, 3, c, cout), 5, 0.04))
    hi, lo = k1_weight(w, dtype)
    assert hi.shape == (cout, 9 * c) and hi.is_contiguous()
    want = torch.empty(cout, 9 * c)
    for ky in range(3):
        for kx in range(3):
            for ch in range(c):
                want[:, (3 * ky + kx) * c + ch] = w[ky, kx, ch, :]
    if dtype == torch.bfloat16:
        assert lo is None and hi.dtype == torch.bfloat16
        assert torch.equal(hi, want.to(torch.bfloat16))
        return
    assert lo.shape == hi.shape and lo.is_contiguous()
    for part in (hi, lo):  # TF32 values: the low 13 mantissa bits are 0
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - want.double()).abs()
    assert float((err - 2.0 ** -21 * want.double().abs()).max()) <= 0.0


def _k3_case(seed, prenorm=True):
    """A K3 call at down2's depth (C = 128 -> 256, K = 1152) on numpy
    inputs; W/2 = 128 for the JAX kernel's rows. Channel offsets of ±1.5
    make the norm's mean negative on half the channels, where relu(−mean ·
    rstd) of a normalized zero is far from 0."""
    c, cout = 128, 256
    offset = np.where(np.arange(c) % 2, 1.5, -1.5).astype(np.float32)
    x = _rand((2, 16, 256, c), seed) + offset
    case = dict(x=x, w=_rand((3, 3, c, cout), seed + 1, 0.04),
                b=_rand((cout,), seed + 2, 0.1), norm=None)
    if prenorm:
        mean = x.mean(axis=(1, 2))
        rstd = 1.0 / np.sqrt(x.var(axis=(1, 2)) + 1e-5)
        case["norm"] = np.stack([mean, rstd], axis=1).astype(np.float32)
    return case


def _prologue(t, norm):
    if norm is None:
        return t
    return torch.relu((t - norm[:, 0, None, None, :])
                      * norm[:, 1, None, None, :])


def _emulate(case, split, halo="post"):
    """The kernel's f32 arithmetic: each tap's stride-2 gather of the
    normalized input, zero outside the image (``halo="pre"``: the norm of
    a zero pad instead), and k1_weight's B through ``split``; the products
    of each 32-channel chunk of one tap summed apart, the chunk sums added
    in f32 in the kernel's order (taps inner), then the bias."""
    x = torch.from_numpy(case["x"])
    w = torch.from_numpy(case["w"])
    norm = (torch.from_numpy(case["norm"]) if case["norm"] is not None
            else None)
    n, h, wd, c = x.shape
    cout = w.shape[3]
    ho, wo = h // 2, wd // 2
    pad = (0, 0, 1, 1, 1, 1)
    if halo == "post":
        xp = F.pad(_prologue(x, norm), pad)
    else:
        xp = _prologue(F.pad(x, pad), norm)
    bt = w.permute(3, 0, 1, 2).reshape(cout, 9 * c)
    b_parts = [bp.t() for bp in split(bt)]  # (9·C, Cout)
    a_parts = []
    for ky in range(3):  # output (oy, ox) reads padded (2 oy + ky, 2 ox + kx)
        for kx in range(3):
            a = xp[:, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2].reshape(-1, c)
            a_parts.append(split(a))
    acc = torch.zeros(n * ho * wo, cout)
    for kc in range(9 * c // CHUNK):
        tap, c0 = kc % 9, (kc // 9) * CHUNK
        ap = [t[:, c0:c0 + CHUNK] for t in a_parts[tap]]
        k0 = tap * c + c0
        bp = [t[k0:k0 + CHUNK] for t in b_parts]
        if len(ap) == 1:
            chunk = ap[0] @ bp[0]
        else:
            (a_hi, a_lo), (b_hi, b_lo) = ap, bp
            chunk = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
        acc = acc + chunk  # f32, rounded to nearest
    out = acc + torch.from_numpy(case["b"])
    return out.reshape(n, ho, wo, cout)


def _references(case):
    norm = case["norm"]
    want_jax, _ = jax_down(
        jnp.asarray(case["x"]), jnp.asarray(case["w"]),
        jnp.asarray(case["b"]),
        norm=jnp.asarray(norm) if norm is not None else None,
        relu=norm is not None, interpret=True)
    want_plain, _ = conv3x3_s2_zero_stats(
        torch.from_numpy(case["x"]), torch.from_numpy(case["w"]),
        torch.from_numpy(case["b"]),
        norm=torch.from_numpy(norm) if norm is not None else None,
        relu=norm is not None)
    return np.asarray(want_jax), want_plain.numpy()


@pytest.mark.parametrize("seed,prenorm", [(10, True), (20, True),
                                          (30, False)])
def test_three_tf32_products_match_jax_and_plain(seed, prenorm):
    case = _k3_case(seed, prenorm)
    got = _emulate(case, split_tf32).numpy()
    want_jax, want_plain = _references(case)
    assert got.shape == (2, 8, 128, 256)
    assert _scaled_err(got, want_jax) <= EMULATION_TOL
    assert _scaled_err(got, want_plain) <= EMULATION_TOL


def test_one_tf32_rounding_misses_the_tolerance():
    """Why three products: one TF32 rounding of each operand (a single
    TF32 pass) is an order of magnitude past the bound."""
    case = _k3_case(10)
    got = _emulate(case, lambda t: (round_tf32(t),)).numpy()
    want_jax, _ = _references(case)
    assert _scaled_err(got, want_jax) > 10 * EMULATION_TOL


def test_normalizing_the_halo_misses_jax():
    """Why the halo is zeroed after the prologue: staging relu((0 − mean)
    · rstd) for the top row and left column, as zeroing the raw registers
    would, is far past the bound where the mean is negative."""
    case = _k3_case(10)
    assert (case["norm"][:, 0] < -1.0).any()
    got = _emulate(case, split_tf32, halo="pre").numpy()
    want_jax, _ = _references(case)
    assert _scaled_err(got, want_jax) > 1000 * EMULATION_TOL


@pytest.mark.parametrize("bad,match", [
    (dict(c=16), "C % 64"),
    (dict(cout=64), "Cout % 128"),
    (dict(h=5), "even H, W"),
    (dict(norm=(1, 2, 32)), "norm must be"),
    (dict(offset=1), "16-byte aligned"),
])
def test_k3_kernel_limits_raise(bad, match):
    c, cout, h = bad.get("c", 64), bad.get("cout", 128), bad.get("h", 4)
    base = torch.zeros(h * 4 * c + 16)
    x = base[bad.get("offset", 0):][:h * 4 * c].view(1, h, 4, c)
    norm = torch.zeros(bad["norm"]) if "norm" in bad else None
    with pytest.raises(ValueError, match=match):
        check_k3_kernel_limits(x, cout, norm)


@pytest.mark.parametrize("hw,c,cout", [(512, 64, 128), (256, 128, 256)])
def test_k3_kernel_limits_accept_the_generator(hw, c, cout):
    """The serving generator's down1 and down2, with their norms."""
    x = torch.empty(1, hw, hw, c)  # not touched: only its shape and address
    check_k3_kernel_limits(x, cout, torch.zeros(1, 2, c))
