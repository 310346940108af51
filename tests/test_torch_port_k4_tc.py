"""K4 on the tensor cores: the arithmetic of the CUDA kernel's f32 route,
checked on the CPU.

The kernel (``csrc/fused_resblock.cu``, K1's implicit GEMM in its zero-halo
mode) runs only on the card, where ``chip_smoke.py`` holds it against its
plain version. What it computes beyond that plain version is fixed here:
the K-major (C, 9·Cout) flipped kernel it reads (:func:`k4_weight`), the
3xTF32 split of its f32 operands with g zero outside the image, and the
three products lo·hi + hi·lo + hi·hi of each 32-channel chunk of one tap
summed apart and added in f32, taps inner. A plain emulation of that
scheme, at the body's depth K = 9·256, with the wrapper's reflect folds
added, stays within 2e-5 of the output's scale of JAX's
``conv3x3_input_grad`` in interpret mode and of the port's plain version
(the smoke's f32 tolerance is 1e-4); one TF32 rounding of each operand
does not. The kernel's shape limits raise ValueError from a check that
runs on any device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.ops.fused_resblock_grad import (
    conv3x3_input_grad as jax_input_grad,
)
from ctagan_tpu_torch.ops.fused_resblock import round_tf32, split_tf32
from ctagan_tpu_torch.ops.fused_resblock_grad import (
    _flip_pack,
    _reflect_folds,
    check_k4_kernel_limits,
    conv3x3_input_grad,
    k4_weight,
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
def test_k4_weight_is_k_major_flipped(dtype):
    """w (3, 3, C, Cout) -> (C, 9·Cout): entry (c, (3 ky + kx)·Cout + o) is
    _flip_pack(w)[ky, kx, o, c] = w[2 − ky, 2 − kx, c, o]; f32 as TF32
    (hi, lo) that sum back to it, bf16 as it rounded."""
    c, cout = 128, 64
    w = torch.from_numpy(_rand((3, 3, c, cout), 5, 0.05))
    hi, lo = k4_weight(w, dtype)
    assert hi.shape == (c, 9 * cout) and hi.is_contiguous()
    v = _flip_pack(w)
    want = torch.empty(c, 9 * cout)
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(v[ky, kx], w[2 - ky, 2 - kx].t())
            for o in range(cout):
                want[:, (3 * ky + kx) * cout + o] = v[ky, kx, o, :]
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


def _k4_case(seed):
    """A K4 call at the body's depth (the forward conv's Cout = 256, K =
    2304; C = 128 outputs), on numpy inputs; W = 128 for the JAX kernel's
    row blocks."""
    return dict(g=_rand((1, 8, 128, 256), seed),
                w=_rand((3, 3, 128, 256), seed + 1, 0.02))


def _emulate(case, split):
    """The kernel's f32 arithmetic, then the wrapper's folds: g zero-padded,
    each tap's (pixels, Cout) operand and k4_weight's B through ``split``,
    the products of each 32-channel chunk of one tap summed apart, the
    chunk sums added in f32 in the kernel's order (taps inner), the reflect
    folds added in f32."""
    g = torch.from_numpy(case["g"])
    w = torch.from_numpy(case["w"])
    n, h, wd, cout = g.shape
    c = w.shape[2]
    gp = torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1))  # the zero halo
    bt = _flip_pack(w).permute(3, 0, 1, 2).reshape(c, 9 * cout)
    b_parts = [bp.t() for bp in split(bt)]  # (9·Cout, C)
    a_parts = []
    for ky in range(3):
        for kx in range(3):
            a = gp[:, ky:ky + h, kx:kx + wd].reshape(n * h * wd, cout)
            a_parts.append(split(a))
    acc = torch.zeros(n * h * wd, c)
    for kc in range(9 * cout // CHUNK):
        tap, c0 = kc % 9, (kc // 9) * CHUNK
        ap = [t[:, c0:c0 + CHUNK] for t in a_parts[tap]]
        k0 = tap * cout + c0
        bp = [t[k0:k0 + CHUNK] for t in b_parts]
        if len(ap) == 1:
            chunk = ap[0] @ bp[0]
        else:
            (a_hi, a_lo), (b_hi, b_lo) = ap, bp
            chunk = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
        acc = acc + chunk  # f32, rounded to nearest
    dx = acc.reshape(n, h, wd, c)
    return _reflect_folds(dx, g, w)


def _references(case):
    want_jax = jax_input_grad(jnp.asarray(case["g"]), jnp.asarray(case["w"]),
                              interpret=True)
    want_plain = conv3x3_input_grad(torch.from_numpy(case["g"]),
                                    torch.from_numpy(case["w"]))
    return np.asarray(want_jax), want_plain.numpy()


@pytest.mark.parametrize("seed", [10, 20])
def test_three_tf32_products_match_jax_and_plain(seed):
    case = _k4_case(seed)
    got = _emulate(case, split_tf32).numpy()
    want_jax, want_plain = _references(case)
    assert _scaled_err(got, want_jax) <= EMULATION_TOL
    assert _scaled_err(got, want_plain) <= EMULATION_TOL


def test_one_tf32_rounding_misses_the_tolerance():
    """Why three products: one TF32 rounding of each operand (a single
    TF32 pass) is an order of magnitude past the bound."""
    case = _k4_case(10)
    got = _emulate(case, lambda t: (round_tf32(t),)).numpy()
    want_jax, _ = _references(case)
    assert _scaled_err(got, want_jax) > 10 * EMULATION_TOL


@pytest.mark.parametrize("bad,match", [
    (dict(c=192), "C % 128"),
    (dict(cout=96), "Cout % 64"),
    (dict(offset=1), "16-byte aligned"),
])
def test_k4_kernel_limits_raise(bad, match):
    """In the forward conv's terms: C = K4's output channels, Cout = g's."""
    c, cout = bad.get("c", 128), bad.get("cout", 64)
    base = torch.zeros(1 * 4 * 4 * cout + 16)
    g = base[bad.get("offset", 0):][:4 * 4 * cout].view(1, 4, 4, cout)
    with pytest.raises(ValueError, match=match):
        check_k4_kernel_limits(g, c)


@pytest.mark.parametrize("c,cout", [(256, 256), (128, 128), (384, 64)])
def test_k4_kernel_limits_accept_the_body(c, cout):
    g = torch.zeros(2, 5, 3, cout)  # any N, H, W: the ragged tile is masked
    check_k4_kernel_limits(g, c)
