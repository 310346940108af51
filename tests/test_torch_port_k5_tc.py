"""K5 on the tensor cores: the arithmetic of the CUDA kernel's f32 route,
checked on the CPU.

The kernel (``csrc/fused_resblock_grad.cuh``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version. What it computes
beyond that plain version is fixed here: the K-major (Cout, N·hwp) copy of
g it reads (:func:`k5_operands`, each sample's pixels zero-padded to a
multiple of 64), the 3xTF32 split of both operands, the three products
lo·hi + hi·lo + hi·hi of each 32-pixel chunk summed apart and added in f32,
and the split of the pixel axis into blocks whose partials are summed
(:func:`k5_plan`). A plain emulation of that scheme, at K = 4096 pixels,
stays within 2e-6 of the output's scale of JAX's ``conv3x3_weight_grad``
in interpret mode and of the port's plain version (the smoke's f32
tolerance is 1e-4); one TF32 rounding of each operand does not. The
kernel's shape limits raise ValueError from a check that runs on any
device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.ops.fused_resblock_grad import (
    conv3x3_weight_grad as jax_weight_grad,
)
from ctagan_tpu_torch.models.layers import reflect_pad
from ctagan_tpu_torch.ops._common import apply_norm
from ctagan_tpu_torch.ops.fused_resblock import round_tf32, split_tf32
from ctagan_tpu_torch.ops.fused_resblock_grad import (
    K5_PIXEL_PAD,
    check_k5_kernel_limits,
    conv3x3_weight_grad,
    k5_operands,
    k5_plan,
)

torch.set_num_threads(2)

EMULATION_TOL = 2e-6  # scaled: max |err| / max(1, max |ref|)
H100_SMS = 132
CHUNK = 32  # pixels per K chunk of the f32 route: one 128-byte row


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _k_major(g, hwp):
    """(N, H, W, Cout) -> (Cout, N·hwp), each sample's pixels zero-padded
    to hwp, written out."""
    n, h, w, cout = g.shape
    out = torch.zeros(cout, n, hwp, dtype=g.dtype)
    out[:, :, :h * w] = g.reshape(n, h * w, cout).permute(2, 0, 1)
    return out.reshape(cout, n * hwp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 7, 128), (1, 8, 16, 256)],
                         ids=["ragged", "whole"])
def test_k5_operands_is_k_major(shape, dtype):
    """g (N, H, W, Cout) -> (Cout, N·hwp): column n·hwp + p is pixel p of
    sample n, the pad columns are zero; f32 as TF32 (hi, lo) that sum back
    to g, bf16 as g rounded."""
    n, h, w, cout = shape
    g = torch.from_numpy(_rand(shape, 1, 3.0))
    hwp = -(-h * w // K5_PIXEL_PAD) * K5_PIXEL_PAD
    hi, lo = k5_operands(g, dtype)
    assert hi.shape == (cout, n * hwp) and hi.is_contiguous()
    want = _k_major(g, hwp)
    if dtype == torch.bfloat16:
        assert lo is None and hi.dtype == torch.bfloat16
        assert torch.equal(hi, want.to(torch.bfloat16))
        return
    assert lo.shape == hi.shape and lo.is_contiguous()
    for part in (hi, lo):  # TF32 values: the low 13 mantissa bits are 0
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi, split_tf32(want)[0])
    assert torch.equal(lo, split_tf32(want)[1])
    err = (hi.double() + lo.double() - want.double()).abs()
    assert float((err - 2.0 ** -21 * want.double().abs()).max()) <= 0.0
    assert not hi.reshape(cout, n, hwp)[:, :, h * w:].any()


def _k5_case(seed, prologue):
    """A K5 call at the main path's depth per chunk and split (C = Cout =
    128, K = 2·16·128 = 4096 pixels), on numpy inputs; W = 128 and H = 16
    for the JAX kernel's row blocks."""
    shape = (2, 16, 128, 128)
    case = dict(x=_rand(shape, seed), g=_rand(shape, seed + 1))
    if prologue:
        x = case["x"]
        mean, std = x.mean(axis=(1, 2)), x.std(axis=(1, 2))
        case["norm"] = np.stack([mean, 1.0 / (std + 1e-3)],
                                axis=1).astype(np.float32)
        case["skip"] = _rand(shape, seed + 2)
    return case


def _emulate(case, split):
    """The kernel's f32 arithmetic: its prologue, reflect pad, each tap's
    (pixels, C) operand and the K-major g through ``split``, the products of
    each 32-pixel chunk summed apart, the chunk sums added in f32 in order
    within each block of k5_plan's split, and the blocks' partials summed."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    x, g = t["x"], t["g"]
    n, h, w, c = x.shape
    cout = g.shape[3]
    xs = apply_norm(x, t.get("norm"), relu=True)
    if "skip" in t:
        xs = t["skip"] + xs
    xp = reflect_pad(xs, 1)
    _, hwp, per, splits = k5_plan(n, h * w, c, cout, torch.float32,
                                  H100_SMS)
    b_parts = split(_k_major(g, hwp))
    nch = n * hwp // CHUNK
    b_parts = [bp.reshape(cout, nch, CHUNK).permute(1, 2, 0)
               for bp in b_parts]  # (chunks, 32 pixels, Cout)
    taps = []
    for kh in range(3):
        for kw in range(3):
            a = xp[:, kh:kh + h, kw:kw + w].reshape(n, h * w, c)
            a = torch.nn.functional.pad(a, (0, 0, 0, hwp - h * w))
            a_parts = [ap.reshape(nch, CHUNK, c).transpose(1, 2)
                       for ap in split(a)]  # (chunks, C, 32 pixels)
            if len(a_parts) == 1:
                chunk_sums = torch.bmm(a_parts[0], b_parts[0])
            else:
                (a_hi, a_lo), (b_hi, b_lo) = a_parts, b_parts
                chunk_sums = (torch.bmm(a_lo, b_hi) + torch.bmm(a_hi, b_lo)
                              + torch.bmm(a_hi, b_hi))
            partials = []
            for z in range(splits):
                acc = torch.zeros(c, cout)
                for k in range(z * per, min(nch, (z + 1) * per)):
                    acc = acc + chunk_sums[k]  # f32, rounded to nearest
                partials.append(acc)
            taps.append(torch.stack(partials).sum(0))
    return torch.stack(taps).reshape(3, 3, c, cout)


def _references(case):
    j = {k: jnp.asarray(v) for k, v in case.items()}
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    kw = dict(relu=True) if "norm" in case else {}
    want_jax = jax_weight_grad(j["x"], j["g"], norm=j.get("norm"),
                               skip=j.get("skip"), interpret=True, **kw)
    want_plain = conv3x3_weight_grad(t["x"], t["g"], norm=t.get("norm"),
                                     skip=t.get("skip"), **kw)
    return np.asarray(want_jax), want_plain.numpy()


@pytest.mark.parametrize("prologue", [False, True],
                         ids=["plain", "norm_relu_skip"])
def test_three_tf32_products_match_jax_and_plain(prologue):
    case = _k5_case(10, prologue)
    got = _emulate(case, split_tf32).numpy()
    want_jax, want_plain = _references(case)
    assert _scaled_err(got, want_jax) <= EMULATION_TOL
    assert _scaled_err(got, want_plain) <= EMULATION_TOL


def test_one_tf32_rounding_misses_the_tolerance():
    """Why three products: one TF32 rounding of each operand (a single
    TF32 pass) is an order of magnitude past the bound."""
    case = _k5_case(10, True)
    got = _emulate(case, lambda t: (round_tf32(t),)).numpy()
    want_jax, _ = _references(case)
    assert _scaled_err(got, want_jax) > 10 * EMULATION_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw,c,cout", [
    (1, 128 * 128, 256, 256), (1, 40 * 40, 256, 256), (1, 128 * 128, 128, 128),
    (16, 128 * 128, 256, 256), (3, 35, 128, 384), (1, 4, 128, 128),
])
def test_k5_plan_covers_every_chunk_once(n, hw, c, cout, dtype):
    """``splits`` blocks of ``per`` chunks cover the N·hwp pixels, none
    empty; 256-wide tiles only for bf16 with Cout % 256 == 0."""
    bn, hwp, per, splits = k5_plan(n, hw, c, cout, dtype, H100_SMS)
    chunk = 64 if dtype == torch.bfloat16 else 32
    assert hwp % K5_PIXEL_PAD == 0 and hw <= hwp < hw + K5_PIXEL_PAD
    total = n * hwp // chunk
    assert (splits - 1) * per < total <= splits * per
    assert bn == (256 if dtype == torch.bfloat16 and cout % 256 == 0
                  else 128)


@pytest.mark.parametrize("dtype,plan", [
    (torch.float32, (128, 16384, 47, 11)), (torch.bfloat16, (256, 16384, 37, 7)),
])
def test_k5_plan_fills_the_card_at_the_body_shape(dtype, plan):
    """The training body's (1, 128, 128, 256) -> 256 on 132 SMs: f32 36
    tiles x 11 splits = 396 blocks, three whole waves of one block per SM;
    bf16 18 x 7 = 126 blocks, one wave."""
    assert k5_plan(1, 128 * 128, 256, 256, dtype, H100_SMS) == plan


def test_k5_kernel_limits_raise_for_a_huge_sample():
    """H·W·C >= 2^31: a zero-stride view, so nothing is allocated."""
    x = torch.zeros(1).expand(1, 2 ** 12, 2 ** 12, 128)
    with pytest.raises(ValueError, match="2\\^31"):
        check_k5_kernel_limits(x, 128)


@pytest.mark.parametrize("bad,match", [
    (dict(c=64), "C % 128"),
    (dict(cout=192), "Cout % 128"),
    (dict(norm_shape=(1, 2, 64)), "norm must be"),
    (dict(offset=1), "16-byte aligned"),
])
def test_k5_kernel_limits_raise(bad, match):
    c, cout = bad.get("c", 128), bad.get("cout", 128)
    base = torch.zeros(1 * 4 * 4 * c + 16)
    x = base[bad.get("offset", 0):][:4 * 4 * c].view(1, 4, 4, c)
    norm = torch.zeros(bad.get("norm_shape", (1, 2, c)))
    with pytest.raises(ValueError, match=match):
        check_k5_kernel_limits(x, cout, norm)


@pytest.mark.parametrize("c,cout", [(256, 256), (128, 128), (128, 384)])
def test_k5_kernel_limits_accept_the_body(c, cout):
    x = torch.zeros(2, 5, 3, c)  # any N, H, W: the pixel tail is padded
    check_k5_kernel_limits(x, cout, torch.zeros(2, 2, c), torch.zeros_like(x))
