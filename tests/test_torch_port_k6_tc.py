"""K6 on Hopper: the plan and the order of work of the CUDA kernel, checked
on the CPU.

The kernel (``csrc/instance_norm.cu``) runs only on the card, where
``chip_smoke.py`` holds it against ``instance_norm_pallas_plain`` within
``K6_OUT_TOL`` and requires two calls on one input to give the same bits.
What it does beyond that plain version is fixed here:

- ``k6_plan``, the route by shape: one read through a thread-block cluster
  where a (sample, channel group) plane fits (``k6_cluster_kernel``), else
  two reads (``k6_stats_kernel`` then ``k6_norm_kernel``). For every
  InstanceNorm shape of the int8 forward and the layer route at N = 1, 2
  and 16, and for ragged shapes, the plan covers every (sample, channel,
  pixel) exactly once with the kernel's own index arithmetic, stays within
  the card's shared memory and cluster limits, and takes one read exactly
  where the plane fits;
- an f32 emulation of the kernel's order of work: per-thread partials in
  pixel order, a tree over a warp's rows (its shuffles), a tree over the
  block's warps, then the cluster's blocks in rank order (route 1) or the
  last block's fixed-order sum of the chunks' partials (route 2). It is
  held to the plain version within ``K6_OUT_TOL``, to JAX's
  ``instance_norm_pallas`` in interpret mode within the tolerances of
  ``test_torch_port_int8.py::test_instance_norm_pallas_plain_matches_jax``,
  and gives the same bits on a repeat.
"""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import K6_OUT_TOL
from ctagan_tpu.ops.pallas_kernels import instance_norm_pallas as jax_in
from ctagan_tpu_torch.ops import pallas_kernels as pk
from ctagan_tpu_torch.ops.pallas_kernels import (
    instance_norm_pallas,
    instance_norm_pallas_plain,
    k6_plan,
)

torch.set_num_threads(2)

ELEM = {"float32": 4, "bfloat16": 2}
# the generator's InstanceNorm planes at 512²: after the head and up2,
# after down1 and up1, after down2 and in the residual body
INT8_SHAPES = [(512, 512, 64), (256, 256, 128), (128, 128, 256)]
RAGGED = [(1, 48, 136, 20), (1, 48, 136, 36), (1, 512, 520, 20),
          (2, 40, 72, 36), (3, 17, 33, 5), (1, 1, 1, 1), (1, 64, 64, 4096)]
PLAN_CASES = (
    # the int8 forward (f32) and the layer route (bf16), N = 1, 2, 16
    [((n, *hwc), dt) for n in (1, 2, 16) for hwc in INT8_SHAPES
     for dt in ("float32", "bfloat16")]
    + [(shape, dt) for shape in RAGGED for dt in ("float32", "bfloat16")])


def _rand(shape, seed, scale=2.0, offset=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + offset).astype(np.float32)


def _fits(hw, c, elem, aligned=True):
    """A plane of 32-byte channel groups fits the largest cluster."""
    vec = 16 // elem if aligned and (c * elem) % 16 == 0 else 1
    g = pk._group(c, vec, elem, 32)
    return hw * g * elem <= pk.K6_MAX_CLUSTER * pk.K6_BLOCK_BYTES


def _coverage(n, h, w, c, plan):
    """How often the kernel's index arithmetic touches each pixel and each
    channel of one plane (the grid's z / plane index adds the samples)."""
    hw = h * w
    slots = plan.group // plan.vec
    rows = plan.threads // slots
    blocks = plan.cluster if plan.route == "cluster" else plan.chunks
    px = np.zeros(hw, np.int64)
    for b in range(blocks):  # block b: pixels b·band + r + i·rows
        p0 = b * plan.band
        npx = max(0, min(plan.band, hw - p0))
        for r in range(rows):
            px[p0 + r:p0 + npx:rows] += 1
    ch = np.zeros(c, np.int64)
    for g in range(plan.groups(c)):  # thread slot s: V channels
        for s in range(slots):
            c0 = g * plan.group + s * plan.vec
            if c0 < c:  # a live slot: whole vectors (C % V == 0 when V > 1)
                ch[c0:c0 + plan.vec] += 1
    return px, ch


@pytest.mark.parametrize("shape,dt", PLAN_CASES)
def test_plan_covers_every_element_once(shape, dt):
    n, h, w, c = shape
    plan = k6_plan(n, h, w, c, ELEM[dt])
    px, ch = _coverage(n, h, w, c, plan)
    assert (px == 1).all() and (ch == 1).all()
    slots = plan.group // plan.vec
    assert slots & (slots - 1) == 0 and 1 <= slots <= 32
    assert plan.threads % 32 == 0 and plan.threads % slots == 0
    if plan.vec > 1:
        assert plan.vec * ELEM[dt] == 16 and c % plan.vec == 0
    if plan.route == "cluster":
        assert 1 <= plan.cluster <= pk.K6_MAX_CLUSTER
        assert plan.smem == pk.k6_cluster_smem(plan.band, plan.group,
                                               ELEM[dt])
        assert plan.smem <= pk.K6_SMEM_LIMIT
        assert plan.band * plan.group * ELEM[dt] <= pk.K6_BLOCK_BYTES
        if plan.cluster > pk.K6_PORTABLE_CLUSTER:  # non-portable: narrowest
            assert plan.group * ELEM[dt] <= 32 or plan.group >= c
    else:
        assert plan.cluster == 0 and plan.smem == 0
        assert 2 * plan.group <= plan.threads  # the finalize's parts
        assert plan.chunks * plan.band >= h * w > (plan.chunks - 1) * plan.band


@pytest.mark.parametrize("shape,dt", PLAN_CASES)
def test_one_read_exactly_where_the_plane_fits(shape, dt):
    n, h, w, c = shape
    plan = k6_plan(n, h, w, c, ELEM[dt])
    assert (plan.route == "cluster") == _fits(h * w, c, ELEM[dt])
    # an unaligned pointer takes the element path, on the same rule
    plan1 = k6_plan(n, h, w, c, ELEM[dt], aligned=False)
    assert plan1.vec == 1
    assert (plan1.route == "cluster") == _fits(h * w, c, ELEM[dt], False)
    assert k6_plan(n, h, w, c, ELEM[dt], one_read=False).route == "two_read"


@pytest.mark.parametrize("n", [1, 2, 16])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_the_generators_planes_take_their_routes(n, dt):
    """The 128² and 256² planes of the int8 forward (f32) and the layer
    route (bf16) take one read; the 512² planes two."""
    for h, w, c in INT8_SHAPES:
        plan = k6_plan(n, h, w, c, ELEM[dt])
        assert plan.route == ("two_read" if h == 512 else "cluster")
        assert plan.vec == 16 // ELEM[dt]


def _emulate(x, plan, eps=1e-5, activation=None):
    """The kernel's order of work in f32 on the CPU; returns (out, sums)
    with sums (N, 2, C) the [sum, sum²] it normalizes with."""
    n, h, w, c = x.shape
    hw = h * w
    G, V = plan.group, plan.vec
    S, groups = G // V, plan.groups(c)
    nt = plan.threads
    blocks = plan.cluster if plan.route == "cluster" else plan.chunks
    R, W = nt // S, nt // 32
    it = -(-plan.band // R)
    xf = F.pad(x.float().reshape(n, hw, c), (0, groups * G - c))
    xf = F.pad(xf, (0, 0, 0, blocks * plan.band - hw))  # zeros add nothing
    xb = xf.reshape(n, blocks, plan.band, groups, G)
    xb = F.pad(xb, (0, 0, 0, 0, 0, it * R - plan.band))
    xb = xb.reshape(n, blocks, it, R, groups, G)
    acc = torch.zeros(n, blocks, R, groups, G)
    acc2 = torch.zeros(n, blocks, R, groups, G)
    for i in range(it):  # each thread's pixels in order
        v = xb[:, :, i]
        acc = acc + v
        acc2 = acc2 + v * v
    part = torch.stack([acc, acc2], dim=-2)  # (n, blocks, R, groups, 2, G)
    # a warp's rows (shuffles at offsets 16 .. S), then the warps
    a = part.reshape(n, blocks, W, 32 // S, groups, 2, G)
    while a.shape[3] > 1:
        half = a.shape[3] // 2
        a = a[:, :, :, :half] + a[:, :, :, half:]
    a = a[:, :, :, 0]
    while a.shape[2] > 1:
        half = a.shape[2] // 2
        a = a[:, :, :half] + a[:, :, half:]
    part = a[:, :, 0]  # (n, blocks, groups, 2, G)
    if plan.route == "cluster":  # every block adds the blocks in rank order
        tot = torch.zeros(n, groups, 2, G)
        for b in range(blocks):
            tot = tot + part[:, b]
    else:  # the last block: part j sums chunks j, j + parts, ..; a tree
        parts = nt // (2 * G)
        sums = []
        for j in range(parts):
            t = torch.zeros(n, groups, 2, G)
            for k in range(j, blocks, parts):
                t = t + part[:, k]
            sums.append(t)
        t = torch.stack(sums)
        while t.shape[0] > 1:
            half = t.shape[0] // 2
            t = t[:half] + t[half:]
        tot = t[0]
    tot = tot.permute(0, 2, 1, 3).reshape(n, 2, groups * G)[:, :, :c]
    count = torch.tensor(float(hw))
    mean = tot[:, 0] / count
    var = tot[:, 1] / count - mean * mean  # unclamped, as the TPU kernel
    rstd = torch.rsqrt(var + eps)
    out = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    if activation == "relu":
        out = torch.clamp_min(out, 0.0)
    elif activation == "leaky_relu":
        out = torch.where(out >= 0.0, out, 0.2 * out)
    return out.to(x.dtype), tot


def _scaled_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


# (N, H, W, C) small enough to emulate, each plan route with several
# blocks; H % 16 == 0 for JAX's kernel
EMU_SHAPES = [(1, 64, 128, 64), (2, 32, 128, 8), (1, 48, 136, 20),
              (1, 48, 136, 36), (1, 272, 256, 8)]


@pytest.mark.parametrize("route", ["plan", "two_read"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_emulation_matches_plain(shape, dt, route):
    n, h, w, c = shape
    x = torch.from_numpy(_rand(shape, sum(shape))).to(getattr(torch, dt))
    plan = k6_plan(n, h, w, c, ELEM[dt], one_read=route == "plan")
    act = ("relu", None, "leaky_relu")[c % 3]
    got, sums = _emulate(x, plan, activation=act)
    again, sums2 = _emulate(x, plan, activation=act)
    assert torch.equal(got, again) and torch.equal(sums, sums2)
    want = instance_norm_pallas_plain(x, activation=act)
    assert got.dtype == want.dtype == x.dtype
    assert _scaled_err(got, want) <= K6_OUT_TOL[dt]
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(instance_norm_pallas(x, activation=act), want)


def test_emulated_routes_take_several_blocks():
    """The emulation shapes reach both routes with more than one block."""
    plans = {shape: k6_plan(*shape, 4) for shape in EMU_SHAPES}
    assert plans[(1, 64, 128, 64)].route == "cluster"
    assert plans[(1, 64, 128, 64)].cluster > 1
    assert plans[(1, 272, 256, 8)].route == "two_read"
    assert plans[(1, 272, 256, 8)].chunks > 1


@pytest.mark.parametrize("route", ["plan", "two_read"])
@pytest.mark.parametrize("activation", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64, 128, 64), (1, 48, 136, 20)])
def test_emulation_matches_jax(shape, dt, activation, route):
    n, h, w, c = shape
    x = _rand(shape, 7 + c)
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    plan = k6_plan(n, h, w, c, ELEM[dt], one_read=route == "plan")
    got, _ = _emulate(xt, plan, activation=activation)
    want = jax_in(jnp.asarray(x).astype(getattr(jnp, dt)),
                  activation=activation, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    if dt == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6,
                                   atol=1e-6)


def test_scratch_holds_norm_and_partials():
    plan = k6_plan(2, 512, 512, 64, 4)
    assert plan.route == "two_read"
    assert pk.k6_scratch_floats(2, 64, plan) == (
        2 * 2 * 64 + 2 * plan.groups(64) * plan.chunks * 2 * plan.group)
    assert pk.k6_scratch_floats(2, 256, k6_plan(2, 128, 128, 256, 4)) == 0


def test_no_float_atomics_and_no_zeroed_stats():
    """The statistics are summed in a fixed order: the kernel's only atomic
    is the integer arrival counter, and a call allocates no zeroed buffer
    (the counters are zeroed once and reset by the kernel)."""
    src = os.path.join(os.path.dirname(pk.__file__), os.pardir, "csrc",
                       "instance_norm.cu")
    with open(src) as f:
        text = f.read()
    atomics = [line for line in text.splitlines() if "atomic" in line
               and not line.lstrip().startswith("//")]
    assert len(atomics) == 1 and "atomicAdd(&counters[plane], 1u)" in (
        atomics[0])
    assert "memset" not in text.replace("no memset", "")
    launch = inspect.getsource(pk._k6_launch)
    assert "zeros" not in launch and "empty" in launch
