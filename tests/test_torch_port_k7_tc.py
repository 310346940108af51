"""K7 on the int8 tensor cores: the arithmetic of the CUDA kernel, checked on
the CPU.

The kernel (``csrc/fused_s8.cu``, ``k7_wgmma_kernel``) runs only on the
card, where ``chip_smoke.py`` holds it against its plain version with an
output tolerance of 0. What it computes beyond that plain version is fixed
here: the K-major (Cout, 9·C) int8 weight it reads (``k7_weight``), and a
plain emulation of its order of work: K chunks of one tap × 128 channels,
taps inner; each A row's 16-channel groups read at the tap's
reflect-indexed source pixel; in mode (ii) the quantization with the
kernel's operations (its rounding by an f32 add of 1.5·2²³, checked on its
own against round-then-clamp), a function of (pixel, channel) alone, which
the kernel applies once per pixel of a tile's halo and the emulation per
staged group; int32 partial sums per chunk; the dequant's two roundings;
the stats per 8 × 16 tile. That emulation equals
``conv3x3_reflect_s8_plain`` bit for bit, and JAX's ``conv3x3_reflect_s8``
in interpret mode within the tolerances of
``test_torch_port_int8.py::test_conv3x3_reflect_s8_plain_matches_jax``
(its stats in the kernel's per-tile order within the smoke's 1e-4). The
int32 sums have headroom at the kernel's largest C, and its shape limits
raise ValueError from a check that runs on any device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.ops import fused_s8 as jax_s8
from ctagan_tpu.ops import quantize as jax_q
from ctagan_tpu_torch.models.layers import channel_stats
from ctagan_tpu_torch.ops.fused_s8 import (
    K7_CHUNK,
    K7_MAX_C,
    _combined_scale,
    check_k7_kernel_limits,
    conv3x3_reflect_s8,
    conv3x3_reflect_s8_plain,
    k7_weight,
)

torch.set_num_threads(2)

SHAPE = (1, 8, 128, 256)  # W = 128 and C % 128 for the JAX kernel's limits
GROUP = 16  # int8 channels per 16-byte group of an A row
TY, TX = 8, 16  # a tile of output pixels: the stats are summed per tile
# 1.5·2²³: an f32 of ulp 1, so adding a value in [0, 127] rounds it to the
# nearest integer (ties to even) and leaves it in the low mantissa bits
MAGIC = 12582912.0


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _case(mode, cout=256, shape=SHAPE, seed=0):
    """Numpy inputs of one K7 call: mode "i" (the int8 trunk and its
    scale), "ii_bf16" (the chain's bf16 raw h1 and its norm) or "ii_f32"
    (f32 raw input); weights quantized per channel as the serving path
    does."""
    c = shape[3]
    q, ws = jax_q.quantize_weight_per_channel(
        jnp.asarray(_rand((3, 3, c, cout), seed + 1, 0.05)))
    case = dict(w_q=np.array(q), w_scale=np.array(ws),
                b=_rand((cout,), seed + 2, 0.1))
    x = _rand(shape, seed)
    if mode == "i":
        xs = np.float32(np.abs(x).max() / 127.0)
        case["x"] = np.clip(np.round(x / xs), -127, 127).astype(np.int8)
        case["x_scale"] = xs
    else:
        x = x * 3.0 + 0.5
        if mode == "ii_bf16":
            x = torch.from_numpy(x).bfloat16().float().numpy()
        mean = x.mean(axis=(1, 2))
        rstd = 1.0 / np.sqrt(x.var(axis=(1, 2)) + 1e-5)
        case["x"] = x
        case["norm"] = np.stack([mean, rstd], 1).astype(np.float32)
    return case


def _torch_args(case, mode, out_dtype):
    kw = dict(x=torch.from_numpy(case["x"]), w_q=torch.from_numpy(case["w_q"]),
              w_scale=torch.from_numpy(case["w_scale"]),
              b=torch.from_numpy(case["b"]), out_dtype=out_dtype)
    if mode == "i":
        kw["x_scale"] = torch.tensor(case["x_scale"])
    else:
        kw["norm"] = torch.from_numpy(case["norm"])
        if mode == "ii_bf16":
            kw["x"] = kw["x"].bfloat16()
    return kw


def _reflect(i, n):
    return torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))


def _quantize(v, mean, rstd, qmul):
    """The kernel's mode (ii) quantization, operation for operation:
    __fsub_rn, __fmul_rn, fmaxf, __fmul_rn, fminf with 127, then __fadd_rn
    of 1.5·2²³ and the low byte of the sum's bits."""
    f = (v - mean) * rstd
    t = torch.clamp_max(torch.clamp_min(f, 0.0) * qmul, 127.0)
    return (t + MAGIC).view(torch.int32) & 0xFF


def _emulate(x, w_q, w_scale, b, x_scale=None, norm=None, act_clip=8.0,
             out_dtype=torch.bfloat16):
    """The kernel's order of work on the CPU; returns (out, stats) with the
    stats summed per 8 × 16 tile, then over the tiles."""
    n, h, wd, c = x.shape
    cout = w_q.shape[3]
    wk = k7_weight(w_q)
    qmul = torch.tensor(127.0 / act_clip, dtype=torch.float32)  # a C float
    m = torch.arange(h * wd)
    oy, ox = m // wd, m % wd
    acc = torch.zeros((n, h * wd, cout), dtype=torch.int32)
    for kc in range(9 * (c // K7_CHUNK)):
        tap, cb = kc % 9, kc // 9
        iy = _reflect(oy + tap // 3 - 1, h)
        ix = _reflect(ox + tap % 3 - 1, wd)
        a = torch.empty((n, h * wd, K7_CHUNK), dtype=torch.int32)
        for g in range(K7_CHUNK // GROUP):
            ch = slice(cb * K7_CHUNK + GROUP * g,
                       cb * K7_CHUNK + GROUP * (g + 1))
            grp = x[:, iy, ix, ch]
            if norm is not None:
                grp = _quantize(grp.float(), norm[:, None, 0, ch],
                                norm[:, None, 1, ch], qmul)
            a[..., GROUP * g:GROUP * (g + 1)] = grp.to(torch.int32)
        k0 = tap * c + cb * K7_CHUNK
        acc += a @ wk[:, k0:k0 + K7_CHUNK].to(torch.int32).t()
    scale = _combined_scale(w_scale, x_scale, act_clip)
    out = (acc.float() * scale) + b.float()  # two roundings, no FMA
    out = out.to(out_dtype).reshape(n, h, wd, cout)
    assert h % TY == 0 and wd % TX == 0, "whole tiles only"
    of = out.float().reshape(n, h // TY, TY, wd // TX, TX, cout)
    stats = torch.stack([of.sum((2, 4)).sum((1, 2)),
                         (of * of).sum((2, 4)).sum((1, 2))], dim=1)
    return out, stats


def test_k7_weight_layout_and_bytes():
    """Column (3·ky + kx)·C + c of row o is w_q[ky, kx, c, o]."""
    w = torch.randint(-127, 128, (3, 3, 256, 128), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0))
    wk = k7_weight(w)
    assert wk.shape == (128, 9 * 256) and wk.dtype == torch.int8
    assert wk.is_contiguous()
    for ky, kx, c, o in ((0, 0, 0, 0), (1, 2, 17, 5), (2, 1, 255, 127),
                         (2, 2, 128, 64)):
        assert wk[o, (3 * ky + kx) * 256 + c] == w[ky, kx, c, o]
    want = w.permute(3, 0, 1, 2).reshape(128, -1)
    assert torch.equal(wk, want)


@pytest.mark.parametrize("c,cout", [(128, 128), (256, 256)])
def test_k7_weight_is_k_major_at_the_body_widths(c, cout):
    w = torch.randint(-127, 128, (3, 3, c, cout), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(c))
    wk = k7_weight(w)
    for ky in range(3):
        for kx in range(3):
            col = (3 * ky + kx) * c
            assert torch.equal(wk[:, col:col + c], w[ky, kx].t())


def test_quantize_by_magic_add_is_round_then_clamp():
    """The kernel rounds min(t, 127) by an f32 add of 1.5·2²³ in place of
    clamp(rint(t), 0, 127) (the plain version's order): the same integer for
    every product t the quantization can form, ties included."""
    edges = [0.0, -0.0, 0.49999997, 0.5, 1.5, 2.5, 3.5, 126.49999,
             126.5, 126.50001, 127.0, 127.49999, 127.5, 128.0, 254.5,
             1e30, float("inf"), 1e-45, 2.0 ** 22 + 0.5]
    ramp = torch.arange(0, 140 * 8, dtype=torch.float32) / 8.0  # .0 .125 ..
    rng = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 200, 100_000).astype(np.float32))
    t = torch.cat([torch.tensor(edges, dtype=torch.float32), ramp, rng])
    want = torch.clamp(torch.round(t), 0.0, 127.0).to(torch.int32)
    # through _quantize with mean 0, rstd 1, qmul 1: t itself
    got = _quantize(t, torch.tensor(0.0), torch.tensor(1.0), torch.tensor(1.0))
    assert torch.equal(got, want)
    # and negative pre-activations (the ReLU) give 0
    neg = _quantize(-t[t > 0], torch.tensor(0.0), torch.tensor(1.0),
                    torch.tensor(15.875))
    assert int(neg.abs().max()) == 0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [256, 128])
@pytest.mark.parametrize("mode", ["i", "ii_bf16", "ii_f32"])
def test_emulation_equals_plain_exactly(mode, cout, out_dtype):
    kw = _torch_args(_case(mode, cout), mode, out_dtype)
    got, got_st = _emulate(**kw)
    want, want_st = conv3x3_reflect_s8_plain(**kw)
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want)  # the smoke's K7_OUT_TOL is 0
    # the stats in the kernel's per-tile order: the smoke's 1e-4 relative
    scale = float(want_st.abs().max().clamp_min(1.0))
    assert float((got_st - want_st).abs().max()) / scale <= 1e-4
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(conv3x3_reflect_s8(**kw)[0], want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["i", "ii_bf16"])
def test_emulation_matches_jax(mode, out_dtype):
    case = _case(mode, seed=3)
    jkw = {}
    if mode == "i":
        x = jnp.asarray(case["x"])
        jkw["x_scale"] = jnp.float32(case["x_scale"])
    else:
        x = jnp.asarray(case["x"]).astype(jnp.bfloat16)
        jkw["norm"] = jnp.asarray(case["norm"])
    y_j, st_j = jax_s8.conv3x3_reflect_s8(
        x, jnp.asarray(case["w_q"]), jnp.asarray(case["w_scale"]),
        jnp.asarray(case["b"]), out_dtype=getattr(jnp, out_dtype),
        interpret=True, **jkw)
    y_t, st_t = _emulate(**_torch_args(case, mode,
                                       getattr(torch, out_dtype)))
    y_j = np.asarray(y_j.astype(jnp.float32))
    if out_dtype == "float32":
        np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-6, atol=1e-6)
    else:  # one bf16 rounding of values that may differ in the last f32 bit
        np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=2 ** -7,
                                   atol=1e-6)
    # the stats of the emulated output, summed as the plain version sums
    # them, within the plain version's tolerances against JAX's stats moved
    # by the output differences admitted above (exact, in f64: XLA's f32
    # dequant may fuse a multiply-add, and where that flips a bf16 rounding
    # one element's square moves sum² by more than 1e-5 of it); in the
    # kernel's per-tile f32 order (whose error on a sum that cancels is
    # larger) within the smoke's 1e-4 of the largest stat
    def stats64(y):
        y = np.asarray(y, np.float64)
        return np.stack([y.sum((1, 2)), (y * y).sum((1, 2))], axis=1)

    st_j = np.asarray(st_j) + (stats64(y_t.float()) - stats64(y_j))
    np.testing.assert_allclose(channel_stats(y_t).numpy(), st_j, rtol=1e-5,
                               atol=1e-3)
    assert np.abs(st_t.numpy() - st_j).max() <= 1e-4 * np.abs(st_j).max()


@pytest.mark.parametrize("mode", ["i", "ii"])
def test_int32_sums_have_headroom_at_the_largest_c(mode):
    """At C = 2048 the largest sum the kernel can meet (mode (i): -128 ×
    -128 on every term; mode (ii): 127 × -128) fits in int32 with room to
    spare, and the emulation's int32 chunk sums equal an int64 sum."""
    c, cout = K7_MAX_C, 128
    worst = 9 * c * 128 * (128 if mode == "i" else 127)
    assert worst < 2 ** 31 - 1 and 9 * 14564 * 128 * 128 > 2 ** 31 - 1
    kw = dict(w_q=torch.full((3, 3, c, cout), -128, dtype=torch.int8),
              w_scale=torch.ones(cout), b=torch.zeros(cout),
              out_dtype=torch.float32)
    if mode == "i":
        kw.update(x=torch.full((1, TY, TX, c), -128, dtype=torch.int8),
                  x_scale=torch.tensor(1.0))
    else:  # every input quantizes to 127
        kw.update(x=torch.full((1, TY, TX, c), 100.0),
                  norm=torch.stack([torch.zeros(1, c), torch.ones(1, c)], 1))
    out, _ = _emulate(**kw)
    acc = torch.tensor(9 * c * 128 * (128 if mode == "i" else -127),
                       dtype=torch.int64)  # the exact sum
    scale = _combined_scale(kw["w_scale"], kw.get("x_scale"), 8.0)
    assert torch.equal(out, (acc.float() * scale).expand_as(out))
    assert torch.equal(out, conv3x3_reflect_s8_plain(**kw)[0])


def _limit_args(c=256, cout=256, hw=(8, 8), x_offset=0, w_offset=0):
    x = torch.zeros(1 * hw[0] * hw[1] * c + 16, dtype=torch.int8)
    x = x[x_offset:x_offset + hw[0] * hw[1] * c].view(1, *hw, c)
    w = torch.zeros(9 * c * cout + 16, dtype=torch.int8)
    w = w[w_offset:w_offset + 9 * c * cout].view(3, 3, c, cout)
    return x, w


@pytest.mark.parametrize("bad", [
    dict(c=192), dict(c=64, cout=64), dict(cout=192), dict(cout=64),
    dict(c=4096, cout=128), dict(x_offset=4), dict(w_offset=8),
    dict(hw=(1, 8)), dict(hw=(8, 1))])
def test_k7_limits_raise(bad):
    x, w = _limit_args(**bad)
    if x.data_ptr() % 16 == 0 and bad.get("x_offset"):
        pytest.fail("the misaligned view is aligned")
    with pytest.raises(ValueError):
        check_k7_kernel_limits(x, w)


@pytest.mark.parametrize("shape,cout", [
    ((16, 128, 128, 256), 256),  # the b=16 int8 body
    ((2, 128, 128, 256), 256),
    ((2, 128, 128, 128), 128),
    ((1, 40, 40, 256), 256),  # a ragged last tile
    ((1, 2, 2, 2048), 128)])
def test_k7_limits_accept_the_body_shapes(shape, cout):
    x = torch.empty(shape, dtype=torch.int8)
    w = torch.empty((3, 3, shape[3], cout), dtype=torch.int8)
    check_k7_kernel_limits(x, w)
