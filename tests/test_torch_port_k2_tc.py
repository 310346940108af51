"""K2 on the tensor cores: the arithmetic of the CUDA kernel's f32 route,
checked on the CPU.

The kernel (``csrc/fused_convt.cu``, K1's implicit GEMM of
``csrc/conv_wgmma.cuh`` in its phase mode) runs only on the card, where
``chip_smoke.py`` holds it against its plain version. What it computes
beyond that plain version is fixed here: the K-major (Cout, 9·C) weight it
reads (:func:`k2_weight`, PyTorch's (C, Cout, 3, 3) kernel unflipped), the
phase gather (output (2q+py, 2r+px) takes input row q at ky = 1 for py = 0,
rows q+1 and q at ky = 0 and 2 for py = 1, columns alike) whose row and
column past the bottom and right edge are zeros in the post-norm domain,
the 3xTF32 split of its f32 operands, and the three products lo·hi +
hi·lo + hi·hi of each 32-channel chunk of one tap summed apart and added
in f32, taps inner. A plain emulation of that scheme at the generator's
up1 depth, C = 256, stays within 2e-5 of the output's scale of JAX's
``convt2x_stats`` in interpret mode (through ``phase_deblock``) and of the
port's plain version (the smoke's f32 tolerance is 1e-4), and so does its
order at up2 (Cout = 64), where a block pairs the two column phases and
px = 1 sums kx = 2 before kx = 0; one TF32 rounding of each operand does
not, and neither does staging the norm of the edge's zeros. The
kernel's shape limits raise ValueError from a check that runs on any
device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctagan_tpu.ops.fused_convt import convt2x_stats as jax_convt
from ctagan_tpu_torch.ops.fused_convt import (
    check_k2_kernel_limits,
    convt2x_stats,
    k2_weight,
    phase_deblock,
)
from ctagan_tpu_torch.ops.fused_resblock import round_tf32, split_tf32

torch.set_num_threads(2)

EMULATION_TOL = 2e-5  # scaled: max |err| / max(1, max |ref|)
CHUNK = 32  # channels per K chunk of the f32 route: one 128-byte row
PHASES = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _taps(py, px, paired=False):
    """The phase's (ky, kx) in the kernel's order, rows outer: ky = 1 for
    row phase 0, ky = 0 (input row q + 1) then 2 (row q) for row phase 1;
    columns alike, but ``paired`` (64-channel tiles) walks column shift 0
    (kx = 2 for px = 1) before shift 1 (kx = 0)."""
    rows = (1,) if py == 0 else (0, 2)
    cols = (1,) if px == 0 else ((2, 0) if paired else (0, 2))
    return [(ky, kx) for ky in rows for kx in cols]


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_weight_is_k_major(dtype, phase):
    """The B the wrapper builds from up2's (128, 64, 3, 3) kernel_t: for
    each of the phase's taps, entry (o, (3 ky + kx)·C + c) is kernel_t[c,
    o, ky, kx], unflipped; f32 as TF32 (hi, lo) that sum back to it, bf16
    as it rounded."""
    c, cout = 128, 64
    kt = torch.from_numpy(_rand((c, cout, 3, 3), 5, 0.03))
    hi, lo = k2_weight(kt, dtype)
    assert hi.shape == (cout, 9 * c) and hi.is_contiguous()
    if dtype == torch.float32:
        assert lo.shape == hi.shape and lo.is_contiguous()
        for part in (hi, lo):  # TF32 values: the low 13 mantissa bits are 0
            assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    else:
        assert lo is None and hi.dtype == torch.bfloat16
    for ky, kx in _taps(*phase):
        want = kt[:, :, ky, kx].t()  # (Cout, C)
        got = hi[:, (3 * ky + kx) * c:(3 * ky + kx + 1) * c]
        if dtype == torch.bfloat16:
            assert torch.equal(got, want.to(torch.bfloat16))
            continue
        got_lo = lo[:, (3 * ky + kx) * c:(3 * ky + kx + 1) * c]
        err = (got.double() + got_lo.double() - want.double()).abs()
        assert float((err - 2.0 ** -21 * want.double().abs()).max()) <= 0.0


def _k2_case(seed, prenorm=True, c=256, cout=128):
    """A K2 call at up1's depth (C = 256 -> 128; up2's 128 -> 64) on numpy
    inputs; W = 128 for the JAX kernel's rows. Channel offsets of ±1.5 make
    the norm's mean negative on half the channels, where relu(−mean ·
    rstd) of a normalized zero is far from 0."""
    offset = np.where(np.arange(c) % 2, 1.5, -1.5).astype(np.float32)
    x = _rand((2, 8, 128, c), seed) + offset
    case = dict(x=x, kt=_rand((c, cout, 3, 3), seed + 1, 0.03),
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


def _emulate(case, split, edge="post", paired=False):
    """The kernel's f32 arithmetic, phase by phase: each tap's gather of
    the normalized input, zero past the bottom and right edge (``edge=
    "pre"``: the norm of a zero pad instead), and k2_weight's B through
    ``split``; the products of each 32-channel chunk of one tap summed
    apart, the chunk sums added in f32 in the kernel's order (taps inner,
    ``paired`` as on 64-channel tiles), then the bias, stored at output
    pixel (2q+py, 2r+px)."""
    x = torch.from_numpy(case["x"])
    kt = torch.from_numpy(case["kt"])
    norm = (torch.from_numpy(case["norm"]) if case["norm"] is not None
            else None)
    n, h, wd, c = x.shape
    cout = kt.shape[1]
    pad = (0, 0, 0, 1, 0, 1)  # one row below, one column right
    if edge == "post":
        xp = F.pad(_prologue(x, norm), pad)
    else:
        xp = _prologue(F.pad(x, pad), norm)
    bt = kt.permute(1, 2, 3, 0).reshape(cout, 9 * c)  # (o, (ky, kx, c))
    b_parts = [bp.t() for bp in split(bt)]  # (9·C, Cout)
    out = torch.empty(n, 2 * h, 2 * wd, cout)
    for py, px in PHASES:
        taps = _taps(py, px, paired)
        a_parts = []
        for ky, kx in taps:  # ky = 0 reads row q + 1, kx = 0 column r + 1
            dy, dx = int(ky == 0), int(kx == 0)
            a = xp[:, dy:dy + h, dx:dx + wd].reshape(-1, c)
            a_parts.append(split(a))
        acc = torch.zeros(n * h * wd, cout)
        for kc in range(len(taps) * c // CHUNK):
            t, c0 = kc % len(taps), (kc // len(taps)) * CHUNK
            ap = [a[:, c0:c0 + CHUNK] for a in a_parts[t]]
            ky, kx = taps[t]
            k0 = (3 * ky + kx) * c + c0
            bp = [b[k0:k0 + CHUNK] for b in b_parts]
            if len(ap) == 1:
                chunk = ap[0] @ bp[0]
            else:
                (a_hi, a_lo), (b_hi, b_lo) = ap, bp
                chunk = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
            acc = acc + chunk  # f32, rounded to nearest
        res = acc + torch.from_numpy(case["b"])
        out[:, py::2, px::2] = res.reshape(n, h, wd, cout)
    return out


def _references(case):
    norm = case["norm"]
    kernel_jax = np.ascontiguousarray(case["kt"].transpose(2, 3, 1, 0))
    pb, _ = jax_convt(
        jnp.asarray(case["x"]), jnp.asarray(kernel_jax),
        jnp.asarray(case["b"]),
        norm=jnp.asarray(norm) if norm is not None else None,
        relu=norm is not None, interpret=True)
    cout = case["kt"].shape[1]
    want_jax = phase_deblock(torch.from_numpy(np.array(pb)), cout)
    want_plain, _ = convt2x_stats(
        torch.from_numpy(case["x"]), torch.from_numpy(case["kt"]),
        torch.from_numpy(case["b"]),
        norm=torch.from_numpy(norm) if norm is not None else None,
        relu=norm is not None)
    return want_jax.numpy(), want_plain.numpy()


@pytest.mark.parametrize("seed,prenorm", [(10, True), (20, True),
                                          (30, False)])
def test_three_tf32_products_match_jax_and_plain(seed, prenorm):
    case = _k2_case(seed, prenorm)
    got = _emulate(case, split_tf32).numpy()
    want_jax, want_plain = _references(case)
    assert got.shape == (2, 16, 256, 128)
    assert _scaled_err(got, want_jax) <= EMULATION_TOL
    assert _scaled_err(got, want_plain) <= EMULATION_TOL


@pytest.mark.parametrize("prenorm", [True, False])
def test_paired_column_phases_match_jax_and_plain(prenorm):
    """Up2's depth (C = 128 -> 64): the order of the paired column phases
    (px = 1: kx = 2, then kx = 0) is as close as the per-phase order."""
    case = _k2_case(40, prenorm, c=128, cout=64)
    got = _emulate(case, split_tf32, paired=True).numpy()
    want_jax, want_plain = _references(case)
    assert got.shape == (2, 16, 256, 64)
    assert _scaled_err(got, want_jax) <= EMULATION_TOL
    assert _scaled_err(got, want_plain) <= EMULATION_TOL


def test_one_tf32_rounding_misses_the_tolerance():
    """Why three products: one TF32 rounding of each operand (a single
    TF32 pass) is an order of magnitude past the bound."""
    case = _k2_case(10)
    got = _emulate(case, lambda t: (round_tf32(t),)).numpy()
    want_jax, _ = _references(case)
    assert _scaled_err(got, want_jax) > 10 * EMULATION_TOL


def test_normalizing_the_edge_misses_jax():
    """Why the edge is zeroed after the prologue: staging relu((0 −
    mean)·rstd) for the row below and the column right of the input, as
    zeroing the raw registers would, is far past the bound where the mean
    is negative."""
    case = _k2_case(10)
    assert (case["norm"][:, 0] < -1.0).any()
    got = _emulate(case, split_tf32, edge="pre").numpy()
    want_jax, _ = _references(case)
    assert _scaled_err(got, want_jax) > 1000 * EMULATION_TOL


@pytest.mark.parametrize("bad,match", [
    (dict(c=16), "C % 64"),
    (dict(c=2112), "C <= 2048"),
    (dict(cout=96), "Cout % 64"),
    (dict(norm=(1, 2, 32)), "norm must be"),
    (dict(offset=1), "16-byte aligned"),
])
def test_k2_kernel_limits_raise(bad, match):
    c, cout = bad.get("c", 64), bad.get("cout", 64)
    base = torch.zeros(4 * 4 * c + 16)
    x = base[bad.get("offset", 0):][:4 * 4 * c].view(1, 4, 4, c)
    norm = torch.zeros(bad["norm"]) if "norm" in bad else None
    with pytest.raises(ValueError, match=match):
        check_k2_kernel_limits(x, cout, norm)


@pytest.mark.parametrize("hw,c,cout", [(128, 256, 128), (256, 128, 64)])
def test_k2_kernel_limits_accept_the_generator(hw, c, cout):
    """The serving generator's up1 and up2 (Cout = 64), with their
    norms."""
    x = torch.empty(1, hw, hw, c)  # not touched: only its shape and address
    check_k2_kernel_limits(x, cout, torch.zeros(1, 2, c))
