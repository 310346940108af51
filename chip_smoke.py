#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``ctagan_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and no network, and imports nothing of JAX. Phases:

1. build the CUDA kernels from ``ctagan_tpu_torch/csrc`` (``ops/_build.py``,
   one nvcc per source, all at once; ``-Xptxas -v`` shows each kernel's
   registers and shared memory);
2. ``kernels``: each kernel against its plain PyTorch version at the main
   paths' shapes, f32 and bf16, every variant a path uses (K1, K3, K2 at the
   serving generator's 512² shapes with N=2; K3 also at a ragged (1, 72,
   104, 64) (a partial tile on a 36×52 grid), at a halo case whose norm
   means are ±1.5 (a normalized zero staged for the zero pad would be far
   off), and without a norm; K2 also at a ragged (1, 36, 52, 256) → (72,
   104, 128), at an edge case whose norm means are ±1.5 (the output
   padding's zero row and column) and at up1 with a norm; K4
   conv3x3_input_grad and K5
   conv3x3_weight_grad at the training body's (1, 128, 128, 256), both also
   at a ragged (1, 40, 40, 256) (K5 with skip) and at C = Cout = 128; K7
   conv3x3_reflect_s8 at the int8 body's (2, 128, 128, 256) in both input
   modes, f32 and bf16 out, and at the served batch's N=16 in mode (ii), at
   C = Cout = 128, at a ragged (1, 40, 40, 256) and with f32 raw input in
   mode (ii); K6 instance_norm_pallas at the int8 forward's
   norm shapes, f32 and bf16 I/O, at its served N=16 in f32, at the layer
   route's body (1, 128, 128, 256) in bf16 and at ragged (1, 48, 136, 20),
   (1, 48, 136, 36) and (1, 512, 520, 20) in both, each also required to
   give the same bits on a second call); times the kernel, the plain
   version and
   one PyTorch library call (cuDNN, ``F.instance_norm``, or for K7 the int8
   GEMM alone: yardsticks the port never calls) with CUDA events, and
   computes each case's bound from its operations and bytes; K1 also at a
   ragged (1, 40, 40, 256) and at C = Cout = 128; K4's, K3's, K2's, K7's
   and K6's kernels alone (K6 with its plan's route and the clusters the
   card runs at once), and their wrappers' device time by kernel beside
   the host time; K1's, K2's, K3's, K4's and K5's built kernels are held to
   hold ``HGMMA`` (``wgmma``) instructions, and K7's ``IGMMA`` (int8
   ``wgmma``) and no ``IDP4A`` (``cuobjdump -sass``);
3. ``generator``: the full-width generator (9 blocks, base 64, 11,365,633
   parameters, seeded weights) at 512², b=2: the serving kernel route
   against the plain layer route, 18 K1, 2 K3 and 2 K2 launches per forward;
   forward times at b=1 and b=16; then ``configs/HdGan_fast.yaml`` (bf16,
   ``pad_mode: zero``) built by ``build_generator`` and served a few
   requests through its layer route, no kernel launched, then again with
   the InstanceNorm switch on: 23 K6 launches per forward, each response
   within the same bound of the switch-off forward;
4. ``int8``: the same generator quantized (``ops/quantize.py``) at 512²,
   b=2, with the InstanceNorm switch on: ``generator_int8_forward`` through
   K7 and K6 against the same forward through their plain versions and
   against the f32 plain route (PSNR), 18 K7 and 5 K6 launches per forward;
   forward times at b=1 and b=16 beside the f32 kernel route;
5. ``grad``: the generator's training route (``fused_body_grad``) against
   the plain layer route at 512², b=1, f32: output and every parameter's
   gradient, 18 K1 launches per forward, 18 K4 and 18 K5 per backward;
6. ``serving``, a main path: ``serve_async`` on ``configs/HdGan.yaml``,
   concurrent POST /synthesize of synthetic DICOM slices, each response
   checked, one against the plain route;
7. ``int8_serving``, a main path: the same on a copy of the config with
   ``serve_quantize: int8`` and the InstanceNorm switch on, every response
   against the f32 plain route (JAX's int8 service bound);
8. ``training``, a main path: ``python -m ctagan_tpu_torch --mode train``'s
   ``train()`` on ``configs/HdGan.yaml`` with its list paths pointed at a
   seeded 512² corpus: finite losses, G, R and D all updated, 36 K1, 18 K4
   and 18 K5 launches per step; the p50 step time of the kernel route and
   of the plain route (``fused_body_grad: off``).

The launch counts of the three main paths (each counted from zero) are the
``launches`` of the kernels line. ``--phases a,b`` runs a subset and stops
before the result lines; ``--cases K2,K3`` keeps only the kernel phase's
cases and timing lines of those kernels (and stops there too). Any failure
exits nonzero before the last line. The last line is ``{"ok": true,
"device": {...}}``; the line before it is the kernels JSON, and the one
before that the card's name and power limit.
"""
import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances, stated once: f32 max |kernel − plain| <= 1e-4 · max(1, |plain|)
# (accumulation order over K = 9·C, or over the 16,384 pixels K5 sums with
# atomics); bf16 <= 2^-7 · max(1, |plain|) (two bf16 ulps: f32 sums that
# differ in the last bits round to neighbouring bf16 values). Stats relative
# to their largest magnitude: f32 1e-4, bf16 1e-2.
OUT_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
STATS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# kernel route vs plain layer route of the whole f32 generator (tanh output)
GEN_TOL = 1e-3
# training route: every parameter's gradient is held against a float64 run
# of the plain route, as is the plain f32 route's. Both f32 routes sum in
# other orders than f64 (K1's stats and K5's partial sums with atomics,
# cuDNN's own algorithms), and ReLU masks that flip where rounding moves a
# pre-activation across 0, through 18 InstanceNorm backwards, leave the f32
# gradient of this net ~1e-3 (Frobenius) to ~2e-2 (largest element) from
# the f64 one on either route (measured on an H100). So the check is
# relative:
# ||g_kernel - g64|| <= GRAD_RATIO * ||g_plain - g64|| + GRAD_TOL * ||g64||,
# Frobenius norms per tensor, ||g64|| floored at GRAD_FLOOR times the
# largest gradient norm of the net (a conv bias before an InstanceNorm has
# a gradient that is zero in exact arithmetic).
GRAD_RATIO = 2.0
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-3
# served pixel (0..4095 stored values) vs the plain route on the same input
PIXEL_TOL = 4.0
# K7: the int32 sums are exact and the dequant is one rounding per operation
# in a fixed order, so out equals the plain version's exactly; its stats are
# summed with atomics in another order: 1e-4 relative
K7_OUT_TOL = {"float32": 0.0, "bfloat16": 0.0}
# K6: f32 1e-5 relative (rsqrtf, sum order of the statistics); bf16 two
# bf16 ulps (the OUT_TOL bound)
K6_OUT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# the int8 forward through K7/K6 vs the same forward through their plain
# versions: a last-bit difference of a statistic (atomics) can move a value
# across an int8 rounding boundary, one step of that tensor's scale, and each
# later InstanceNorm and re-quantization carries it on through 9 blocks, so
# the two int8 routes differ by int8-grade noise, only a little less than
# int8 differs from f32 on this random-weight net. Held to a max of an eighth
# of the [-1, 1] range, a mean below what int8 vs f32 gives, and a PSNR
# between the two int8 routes above int8 vs f32 by INT8_PSNR_MARGIN dB (a
# forward that skipped the quantization sits at the f32 distance). Measured
# on an H100: mean 0.0189-0.0193 kernel vs plain, 0.0234 int8 vs f32; PSNR
# 38.3-38.5 against 36.6 dB.
INT8_MAX_TOL = 0.25
INT8_MEAN_TOL = 0.021
INT8_PSNR_MARGIN = 1.0
# an int8 forward vs the f32 route: JAX's quality contract
# (tests/test_quantize.py), PSNR over the [-1, 1] range
INT8_PSNR_MIN = 30.0
# a served int8 slice vs the f32 route on the same DICOM: the JAX int8
# service's own bound (tests/test_quantize.py::
# test_int8_through_serving_service), mean |error| over the [-1, 1] range
INT8_SERVED_MEAN_TOL = 0.05
N_REQUESTS = 16
# configs/HdGan_fast.yaml (bf16, pad_mode: zero) served through the layer
# route: each response against the same generator's forward on its slice
# alone, mean |error| over [-1, 1] per slice. Batch composition changes
# cuDNN's bf16 algorithms, so the two differ at bf16 grade (the CPU test
# measured 0.0065 between the port's and JAX's bf16 forwards); reflect
# padding in place of zero padding is ~0.24 away
ZERO_PAD_REQUESTS = 4
ZERO_PAD_MEAN_TOL = 2.0 ** -6
# with the InstanceNorm switch on, the layer route runs every one of the
# generator's InstanceNorms through K6: head, 2 downs, 18 in the 9 residual
# blocks, 2 ups
ZERO_PAD_NORMS = 23
TRAIN_STEPS = 12  # kernel route; the p50 skips the first 2 steps
PLAIN_STEPS = 6   # plain route, for its p50 beside the kernel route's
# H100 SXM peaks (NVIDIA's H100 data sheet, 700 W): f32 outside
# the tensor cores, bf16, int8 and TF32 dense tensor cores, HBM3 bytes/s
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_INT8, PEAK_TF32 = 1979e12, 495e12
# the kernels on wgmma, by name: K1, K2, K3 and K4 csrc/conv_wgmma.cuh, K5
# csrc/fused_resblock_grad.cuh
WGMMA_KERNELS = {"K1": "k1_wgmma_kernel", "K2": "k2_wgmma_kernel",
                 "K3": "k3_wgmma_kernel", "K4": "k4_wgmma_kernel",
                 "K5": "wgrad_kernel"}
# K7 (csrc/fused_s8.cu) on int8 wgmma: its input (int8, f32 or bf16 raw)
# by output (f32 or bf16) types, each at one tile width or more; IDP4A
# would be the CUDA-core dot product of its first version
K7_WGMMA_KERNEL = "k7_wgmma_kernel"
K7_KINDS = 6
ALL_PHASES = ("kernels", "generator", "int8", "grad", "serving",
              "int8_serving", "training")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e!r}")
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(torch, got, want):
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if hasattr(t, "element_size"))


def as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


CONV_PEAKS = {"float32": (PEAK_F32, "f32 CUDA cores"),
              "bfloat16": (PEAK_BF16, "bf16 tensor cores")}


def kernel_cases(torch):
    """(kernel, case, fn, plain_fn, make_inputs, library_fn, flops[, spec]):
    the main paths' shapes; make_inputs(dtype) returns the keyword
    arguments, library_fn(kw) one PyTorch call of the same function on them
    (a yardstick only) and flops(kw) the case's operations. ``spec``
    overrides the tolerances (``out_tol``, ``stats_tol``) and the peak rate
    of each dtype (``peaks``: dtype -> (ops/s, label)), ``also`` adds
    (ops/s, label) bounds printed beside the case's own, ``dtypes`` keeps
    only those dtypes and ``repeat`` requires a second call on the same
    inputs to give the same bits."""
    import torch.nn.functional as F

    from ctagan_tpu_torch.ops import (
        fused_convt,
        fused_down,
        fused_resblock,
        fused_resblock_grad,
        fused_s8,
        pallas_kernels,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def normed(x):
        xf = x.float()
        mean = xf.mean(dim=(1, 2))
        rstd = torch.rsqrt(xf.var(dim=(1, 2)) + 1e-5)
        return torch.stack([mean, rstd], dim=1)

    def nchw(x):  # a channels-last NCHW view of an NHWC tensor
        return x.permute(0, 3, 1, 2)

    def oihw(w, dt):  # (3, 3, I, O) -> (O, I, 3, 3), channels last
        return w.permute(3, 2, 0, 1).to(dt).contiguous(
            memory_format=torch.channels_last)

    def conv_flops(n, h, w, c, co):
        return 2.0 * n * h * w * 9 * c * co

    def k1(variant, n=2, hw=128, c=256):
        def make(dt):
            x = randn(n, hw, hw, c).to(dt)
            kw = dict(x=x, w=randn(3, 3, c, c, scale=0.02),
                      b=randn(c, scale=0.1))
            if variant != "plain":
                kw["norm"] = normed(x)
            if variant in ("norm_relu", "emit_norm_relu"):
                kw["relu"] = True
            if variant == "norm_skip":
                kw["skip"] = randn(n, hw, hw, c).to(dt)
            if variant == "emit_norm_relu":
                kw["emit_input"] = True
            return kw
        return make

    def k1_lib(kw):
        w = oihw(kw["w"], kw["x"].dtype)
        b = kw["b"].to(kw["x"].dtype)
        return lambda: F.conv2d(nchw(kw["x"]), w, b, padding=1)

    def k3(c, co, n=2, hw=None, norm=True, offset=0.0):
        # offset: channel offsets of alternating sign, so the norm's mean is
        # far from 0 and relu((0 - mean) rstd) is too on half the channels
        def make(dt):
            h, wd = hw or ((512, 512) if c == 64 else (256, 256))
            x = randn(n, h, wd, c)
            if offset:
                x = x + offset * (torch.arange(c, device=dev) % 2 * 2 - 1)
            x = x.to(dt)
            kw = dict(x=x, w=randn(3, 3, c, co, scale=0.04),
                      b=randn(co, scale=0.1))
            if norm:
                kw.update(norm=normed(x), relu=True)
            return kw
        return make

    def k3_lib(kw):
        w = oihw(kw["w"], kw["x"].dtype)
        b = kw["b"].to(kw["x"].dtype)
        return lambda: F.conv2d(nchw(kw["x"]), w, b, stride=2, padding=1)

    def k2(c, co, prenorm, n=2, hw=None, offset=0.0):
        # offset: as k3's, so a normalized zero at the edge is far from 0
        def make(dt):
            h, wd = hw or ((128, 128) if c == 256 else (256, 256))
            x = randn(n, h, wd, c)
            if offset:
                x = x + offset * (torch.arange(c, device=dev) % 2 * 2 - 1)
            x = x.to(dt)
            kw = dict(x=x, kernel_t=randn(c, co, 3, 3, scale=0.03),
                      bias=randn(co, scale=0.1))
            if prenorm:
                kw.update(norm=normed(x), relu=True)
            return kw
        return make

    def k2_lib(kw):
        dt = kw["x"].dtype
        w = kw["kernel_t"].to(dt).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv_transpose2d(
            nchw(kw["x"]), w, kw["bias"].to(dt), stride=2, padding=1,
            output_padding=1)

    def k4(hw=128, c=256):
        def make(dt):
            return dict(g=randn(1, hw, hw, c).to(dt),
                        w=randn(3, 3, c, c, scale=0.02))
        return make

    def k4_lib(kw):
        g = kw["g"]
        w = oihw(kw["w"], g.dtype)
        return lambda: torch.nn.grad.conv2d_input(
            (g.shape[0], w.shape[1], g.shape[1], g.shape[2]), w, nchw(g),
            padding=1)

    def k4_flops(kw):
        n, h, wd, co = kw["g"].shape
        c = kw["w"].shape[2]
        # interior correlation + the 4 border lines (3 taps) and 4 corners
        return conv_flops(n, h, wd, co, c) + 2.0 * n * co * c * (
            3 * (2 * h + 2 * wd) + 4)

    def k5(variant, hw=128, c=256):
        def make(dt):
            x = randn(1, hw, hw, c).to(dt)
            kw = dict(x=x, g=randn(1, hw, hw, c).to(dt))
            if variant != "plain":
                kw.update(norm=normed(x), relu=True)
            if variant == "norm_relu_skip":
                kw["skip"] = randn(1, hw, hw, c).to(dt)
            return kw
        return make

    def k5_lib(kw):
        x, g = kw["x"], kw["g"]
        return lambda: torch.nn.grad.conv2d_weight(
            nchw(x), (g.shape[3], x.shape[3], 3, 3), nchw(g), padding=1)

    def x_flops(co_of):
        def flops(kw):
            n, h, w, c = kw["x"].shape
            return conv_flops(n, h, w, c, co_of(kw))
        return flops

    def down_flops(kw):
        n, h, w, c = kw["x"].shape
        return conv_flops(n, h // 2, w // 2, c, kw["w"].shape[3])

    def k7(mode, n=2, hw=(128, 128), c=256, cout=256, raw=torch.bfloat16):
        # dt is the output dtype; mode (i) takes the int8 trunk, mode (ii)
        # the chain's bf16 raw h1 (or f32 raw input) with its norm
        def make(dt):
            kw = dict(w_q=torch.randint(-127, 128, (3, 3, c, cout),
                                        generator=gen, device=dev,
                                        dtype=torch.int8),
                      w_scale=torch.rand(cout, generator=gen, device=dev)
                      * 1e-3 + 1e-4,
                      b=randn(cout, scale=0.1), out_dtype=dt)
            x = randn(n, *hw, c)
            if mode == "i":
                kw["x_scale"] = x.abs().amax() / 127.0
                kw["x"] = torch.round(x / kw["x_scale"]).to(torch.int8)
            else:
                kw["x"] = (x * 3.0 + 0.5).to(raw)
                kw["norm"] = normed(kw["x"])
            return kw
        return make

    def k7_lib(kw):  # the int8 GEMM alone, on a pre-unfolded matrix
        n, h, wd, c = kw["x"].shape
        cols = torch.randint(-127, 128, (n * h * wd, 9 * c), generator=gen,
                             device=dev, dtype=torch.int8)
        wmat = kw["w_q"].reshape(9 * c, -1).t().contiguous().t()  # faster
        return lambda: torch._int_mm(cols, wmat)

    def k6(shape, activation):
        def make(dt):
            return dict(x=(randn(*shape) * 2.0 + 0.5).to(dt),
                        activation=activation)
        return make

    def k6_lib(kw):
        return lambda: F.instance_norm(nchw(kw["x"]))

    def k6_flops(kw):  # sum, square-sum, subtract, multiply, activation
        return 5.0 * kw["x"].numel()

    r, d, t = fused_resblock, fused_down, fused_convt
    gr = fused_resblock_grad
    s8, pk = fused_s8, pallas_kernels
    k7_spec = {"out_tol": K7_OUT_TOL, "stats_tol": {"float32": 1e-4,
                                                    "bfloat16": 1e-4},
               "peaks": {dt: (PEAK_INT8, "int8 tensor cores")
                         for dt in CONV_PEAKS}}
    # K6 sums its statistics in a fixed order: a second call on the same
    # input must give the same bits
    k6_spec = {"out_tol": K6_OUT_TOL, "repeat": True,
               "peaks": {dt: (PEAK_F32, "f32 CUDA cores")
                         for dt in CONV_PEAKS}}
    # K1's, K2's, K3's, K4's and K5's f32 routes are three TF32 products on
    # the tensor cores (3xTF32)
    k1_spec = k2_spec = k3_spec = k4_spec = k5_spec = {
        "peaks": {"float32": (PEAK_TF32 / 3, "3 TF32 products, tensor cores"),
                  "bfloat16": CONV_PEAKS["bfloat16"]},
        "also": (CONV_PEAKS["float32"],)}
    k1_flops = x_flops(lambda kw: kw["w"].shape[3])
    k5_flops = x_flops(lambda kw: kw["g"].shape[3])
    return [
        ("conv3x3_reflect_stats", f"K1 {v} N=2 128^2x256->256",
         r.conv3x3_reflect_stats, r.conv3x3_reflect_stats_plain, k1(v),
         k1_lib, k1_flops, k1_spec)
        for v in ("norm_relu", "emit_norm_relu", "norm_skip", "plain")
    ] + [
        ("conv3x3_reflect_stats", "K1 norm_skip ragged N=1 40^2x256->256",
         r.conv3x3_reflect_stats, r.conv3x3_reflect_stats_plain,
         k1("norm_skip", n=1, hw=40), k1_lib, k1_flops, k1_spec),
        ("conv3x3_reflect_stats", "K1 norm_relu N=2 128^2x128->128",
         r.conv3x3_reflect_stats, r.conv3x3_reflect_stats_plain,
         k1("norm_relu", c=128), k1_lib, k1_flops, k1_spec),
    ] + [
        ("conv3x3_s2_zero_stats", case, d.conv3x3_s2_zero_stats,
         d.conv3x3_s2_zero_stats_plain, make, k3_lib, down_flops, k3_spec)
        for case, make in (
            ("K3 down1 N=2 64->128 512^2", k3(64, 128)),
            ("K3 down2 N=2 128->256 256^2", k3(128, 256)),
            ("K3 ragged N=1 72x104x64->128 (36x52 out)",
             k3(64, 128, n=1, hw=(72, 104))),
            ("K3 halo N=2 128^2x128->256 means +-1.5",
             k3(128, 256, hw=(128, 128), offset=1.5)),
            ("K3 no-norm N=1 256^2x64->128",
             k3(64, 128, n=1, hw=(256, 256), norm=False)))
    ] + [
        ("convt2x_stats", case, t.convt2x_stats, t.convt2x_stats_plain, make,
         k2_lib, x_flops(lambda kw: kw["kernel_t"].shape[1]), k2_spec)
        for case, make in (
            ("K2 up1 N=2 256->128 128^2", k2(256, 128, False)),
            ("K2 up2 N=2 128->64 256^2 norm", k2(128, 64, True)),
            ("K2 ragged N=1 36x52x256->128 (72x104 out)",
             k2(256, 128, False, n=1, hw=(36, 52))),
            ("K2 edge N=2 64^2x256->128 norm means +-1.5",
             k2(256, 128, True, hw=(64, 64), offset=1.5)),
            ("K2 up1 norm N=2 256->128 128^2", k2(256, 128, True)))
    ] + [
        ("conv3x3_input_grad", f"K4 N=1 {hw}^2x{c}->{c}",
         gr.conv3x3_input_grad, gr.conv3x3_input_grad_plain, k4(hw, c),
         k4_lib, k4_flops, k4_spec)
        for hw, c in ((128, 256), (40, 256), (128, 128))
    ] + [
        ("conv3x3_weight_grad", f"K5 {v} N=1 128^2x256->256",
         gr.conv3x3_weight_grad, gr.conv3x3_weight_grad_plain, k5(v), k5_lib,
         k5_flops, k5_spec)
        for v in ("norm_relu", "plain", "norm_relu_skip")
    ] + [
        ("conv3x3_weight_grad", "K5 norm_relu_skip ragged N=1 40^2x256->256",
         gr.conv3x3_weight_grad, gr.conv3x3_weight_grad_plain,
         k5("norm_relu_skip", hw=40), k5_lib, k5_flops, k5_spec),
        ("conv3x3_weight_grad", "K5 norm_relu N=1 128^2x128->128",
         gr.conv3x3_weight_grad, gr.conv3x3_weight_grad_plain,
         k5("norm_relu", c=128), k5_lib, k5_flops, k5_spec),
    ] + [
        ("conv3x3_reflect_s8", f"K7 mode ({m}) {shape} (dtype: out)",
         s8.conv3x3_reflect_s8, s8.conv3x3_reflect_s8_plain, make, k7_lib,
         x_flops(lambda kw: kw["w_q"].shape[3]), k7_spec)
        for m, shape, make in (
            ("i", "N=2 128^2x256->256", k7("i")),
            ("ii", "N=2 128^2x256->256", k7("ii")),
            ("ii", "N=16 128^2x256->256", k7("ii", n=16)),
            ("i", "N=2 128^2x128->128", k7("i", c=128, cout=128)),
            ("i", "ragged N=1 40^2x256->256", k7("i", n=1, hw=(40, 40))),
            ("ii", "ragged N=1 40^2x256->256", k7("ii", n=1, hw=(40, 40))),
            ("ii", "f32 raw N=2 128^2x256->256",
             k7("ii", raw=torch.float32)))
    ] + [
        ("instance_norm_pallas", f"K6 N=2 {h}^2x{c} {act}",
         pk.instance_norm_pallas, pk.instance_norm_pallas_plain,
         k6((2, h, h, c), act), k6_lib, k6_flops, k6_spec)
        for h, c, act in ((512, 64, "relu"), (128, 256, None),
                          (256, 128, "leaky_relu"))
    ] + [
        ("instance_norm_pallas", f"K6 {case}", pk.instance_norm_pallas,
         pk.instance_norm_pallas_plain, k6(shape, act), k6_lib, k6_flops,
         dict(k6_spec, dtypes=dts))
        for case, shape, act, dts in (
            ("int8 served N=16 512^2x64 relu", (16, 512, 512, 64), "relu",
             ("float32",)),
            ("int8 served N=16 128^2x256 relu", (16, 128, 128, 256), "relu",
             ("float32",)),
            ("layer route body N=1 128^2x256", (1, 128, 128, 256), None,
             ("bfloat16",)),
            ("ragged N=1 48x136x20 relu", (1, 48, 136, 20), "relu",
             ("float32", "bfloat16")),
            ("ragged N=1 48x136x36 leaky_relu", (1, 48, 136, 36),
             "leaky_relu", ("float32", "bfloat16")),
            ("ragged two-read N=1 512x520x20 relu", (1, 512, 520, 20),
             "relu", ("float32", "bfloat16")))
    ]


def bound_of(flops, moved, peak):
    """(bound ms, 'operations' or 'bytes'): the larger of the two times."""
    ops_ms, bytes_ms = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def check_kernels(torch, cases=None):
    """Phase 2: every kernel case vs its plain version, f32 and bf16.
    Returns {kernel: {...}}; the times and bound are those of the first
    case listed for the kernel, in f32. ``cases``: the kernels (K1..K7)
    whose cases run (all if None)."""
    results = {}
    for name, case, fn, plain, make, library, flops_of, *spec in (
            kernel_cases(torch)):
        if cases is not None and case.split()[0] not in cases:
            continue
        spec = spec[0] if spec else {}
        out_tol = spec.get("out_tol", OUT_TOL)
        stats_tol = spec.get("stats_tol", STATS_TOL)
        peaks = spec.get("peaks", CONV_PEAKS)
        labelled = sorted(set(peaks.values()) | set(spec.get("also", ())))
        for dt_name in spec.get("dtypes", ("float32", "bfloat16")):
            dt = getattr(torch, dt_name)
            kw = make(dt)
            got = as_tuple(fn(**kw))
            torch.cuda.synchronize()
            same = (torch.equal(as_tuple(fn(**kw))[0], got[0])
                    if spec.get("repeat") else True)
            want = as_tuple(plain(**kw))
            out_err = float((got[0].float() - want[0].float()).abs().max())
            out_rel = rel_err(torch, got[0], want[0])
            st_rel = (float((got[1] - want[1]).abs().max()
                            / want[1].abs().max().clamp_min(1.0))
                      if len(got) > 1 else 0.0)
            xn_rel = rel_err(torch, got[2], want[2]) if len(got) == 3 else 0.0
            ms = cuda_ms(torch, lambda: fn(**kw))
            plain_ms = cuda_ms(torch, lambda: plain(**kw))
            library_ms = cuda_ms(torch, library(kw))
            flops = flops_of(kw)
            moved = nbytes(*kw.values()) + nbytes(*got)
            bound_ms, bound_by = bound_of(flops, moved, peaks[dt_name][0])
            others = "; ".join(
                f"{label} {bound_of(flops, moved, pk)[0]:.3f} ms"
                for pk, label in labelled if label != peaks[dt_name][1])
            rep = f"; repeat bit-equal {same}" if spec.get("repeat") else ""
            ok = (same and out_rel <= out_tol[dt_name]
                  and xn_rel <= out_tol[dt_name]
                  and st_rel <= stats_tol[dt_name]
                  and got[0].dtype == want[0].dtype and bool(torch.isfinite(
                      got[0].float()).all()))
            print(f"kernel {case} {dt_name}: out max_abs_err {out_err:.3e} "
                  f"(scaled {out_rel:.3e}, tol {out_tol[dt_name]:.3e}), "
                  f"x_new scaled err {xn_rel:.3e}, stats rel err "
                  f"{st_rel:.3e} (tol {stats_tol[dt_name]:.0e}){rep}; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
                  f"{library_ms:.3f} ms; {flops / 1e9:.2f} G ops, "
                  f"{moved / 1e6:.1f} MB: bound {bound_ms:.3f} ms by "
                  f"{bound_by} ({peaks[dt_name][1]}"
                  f"{'; ' + others if others else ''}), kernel at "
                  f"{flops / ms / 1e9:.1f} T ops/s -> "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"{case} {dt_name} disagrees with its plain version")
            entry = results.setdefault(name, {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms})
            entry["max_abs_err"] = max(entry["max_abs_err"], out_err)
            del kw, got, want
    return results


def check_k5_operands(torch):
    """K5's B operand written by its one-pass kernel (``k5_operands`` on a
    CUDA tensor) against the plain version on the same g: the same
    roundings, so bit-equal; at the body's shape and a ragged two-sample
    one whose pixel pad is zeros."""
    from ctagan_tpu_torch.ops.fused_resblock_grad import (
        k5_operands,
        k5_operands_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in ((1, 128, 128, 256), (2, 40, 40, 128)):
        g = torch.randn(*shape, generator=gen, device="cuda") * 3.0
        for dt in (torch.float32, torch.bfloat16):
            got, want = k5_operands(g, dt), k5_operands_plain(g, dt)
            same = all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, want))
            print(f"K5 operands {shape} {dt}: kernel == plain {same}",
                  flush=True)
            if not same:
                fail(f"K5's operands kernel {shape} {dt} differs from plain")


def time_wrapper_parts(torch, cases=None):
    """K4 at the training body's (1, 128, 128, 256) -> 256, K3 at the
    serving path's down1 (2, 512, 512, 64) -> 128 and K2 at its up1 (2,
    128, 128, 256) -> 128 and up2 (2, 256, 256, 128) -> 64 with a norm, f32
    and bf16; K7 at the int8 body's (2, 128, 128, 256) -> 256 in both input
    modes, f32 and bf16 out: the kernel alone on a built B operand (CUDA
    events, beside its bound and its grid), and one wrapper call's device
    time by kernel (``torch.profiler``, 5 calls: B's build, the kernel, and
    for K4 the f32 cast, reflect folds and rounding, for K7 the combined
    scale) beside the host's time to enqueue it. ``cases``: the kernels to
    time (all if None)."""
    from ctagan_tpu_torch.ops import fused_convt as t
    from ctagan_tpu_torch.ops import fused_down as d
    from ctagan_tpu_torch.ops import fused_resblock_grad as gr
    from ctagan_tpu_torch.ops import fused_s8 as s8
    from ctagan_tpu_torch.ops.fused_resblock import k1_weight

    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def normed(x):
        return torch.stack([x.mean(dim=(1, 2)),
                            torch.rsqrt(x.var(dim=(1, 2)) + 1e-5)], dim=1)

    w4 = randn(3, 3, 256, 256, scale=0.02)
    g4 = randn(1, 128, 128, 256)
    x3, w3 = randn(2, 512, 512, 64), randn(3, 3, 64, 128, scale=0.04)
    b3 = randn(128, scale=0.1)
    norm3 = normed(x3)
    ups = {}
    for stage, (h, c, co) in (("up1", (128, 256, 128)),
                              ("up2", (256, 128, 64))):
        x2 = randn(2, h, h, c)
        ups[stage] = (x2, randn(c, co, 3, 3, scale=0.03),
                      randn(co, scale=0.1), normed(x2) if co == 64 else None)

    def grid(dt, n, pixels, cout, chunks, phases=1):
        """(blocks, tile, K chunks per block): the body's 128-pixel tiles;
        bf16 256 wide where Cout allows, else 128, else 64 (K2: its two
        column phases paired in one 128-wide tile, two row phases)."""
        widths = ((256,) if dt == torch.bfloat16 else ()) + (128, 64)
        bn = next(b for b in widths if cout % b == 0)
        tile = f"128 x {bn}"
        if bn == 64 and phases == 4:
            tile, phases, chunks = "128 x 2x64", 2, (chunks[1], 2 * chunks[1])
        blocks = n * -(-pixels // 128) * (cout // bn) * phases
        per = 128 // dt.itemsize  # channels per 128-byte K chunk
        return blocks, tile, "/".join(str(k // per) for k in chunks)

    def k4(dt):
        g = g4.to(dt)
        b = gr.k4_weight(w4, dt)
        n, h, wd, cout = g.shape
        c = w4.shape[2]
        return dict(shape=f"N=1 {h}^2x{cout}->{c}", n=n, pixels=h * wd,
                    cout=c, k=9 * cout,
                    grid=grid(dt, n, h * wd, c, (9 * cout,)),
                    kernel=lambda: gr._corr3x3_zero_kernel(g, *b),
                    call=lambda: gr.conv3x3_input_grad(g, w4),
                    moved=nbytes(g, *b) + n * h * wd * c * g.element_size())

    def k3(dt):
        x = x3.to(dt)
        b = k1_weight(w3, dt)
        n, h, wd, c = x.shape
        cout = w3.shape[3]
        pixels = (h // 2) * (wd // 2)
        return dict(shape=f"down1 N={n} {h}^2x{c}->{cout}", n=n,
                    pixels=pixels, cout=cout, k=9 * c,
                    grid=grid(dt, n, pixels, cout, (9 * c,)),
                    kernel=lambda: d._k3_kernel(x, *b, b3, norm3, True),
                    call=lambda: d.conv3x3_s2_zero_stats(x, w3, b3, norm3,
                                                         True),
                    moved=nbytes(x, *b) + n * pixels * cout
                    * x.element_size())

    def k2(stage):
        def parts(dt):
            x2, kt, b2, norm2 = ups[stage]
            x = x2.to(dt)
            b = t.k2_weight(kt, dt)
            n, h, wd, c = x.shape
            cout = kt.shape[1]
            relu = norm2 is not None
            # the input grid per phase; the phases' 1, 2, 2, 4 taps sum to 9
            return dict(shape=f"{stage} N={n} {h}^2x{c}->{cout}"
                        f"{' norm' if relu else ''}", n=n, pixels=h * wd,
                        cout=cout, k=9 * c,
                        grid=grid(dt, n, h * wd, cout,
                                  [taps * c for taps in (1, 2, 2, 4)],
                                  phases=4),
                        kernel=lambda: t._k2_kernel(x, *b, b2, norm2, relu),
                        call=lambda: t.convt2x_stats(x, kt, b2, norm2, relu),
                        moved=nbytes(x, *b) + n * 4 * h * wd * cout
                        * x.element_size())
        return parts

    def k7(mode):
        # N=2, the int8 body's (2, 128, 128, 256) -> 256; dt is the output
        # dtype, the input the int8 trunk (i) or the chain's bf16 h1 (ii)
        def parts(dt):
            x = x7[mode]
            wk = s8.k7_weight(w7)
            n, h, wd, c = x.shape
            cout = w7.shape[3]
            norm = norm7 if mode == "ii" else None
            x_scale = xs7 if mode == "i" else None
            scale = s8._combined_scale(ws7, x_scale, 8.0)
            blocks = n * -(-h // 8) * -(-wd // 16) * (cout // 256)
            return dict(shape=f"mode ({mode}) N={n} {h}^2x{c}->{cout} "
                        "(dtype: out)", n=n, pixels=h * wd,
                        cout=cout, k=9 * c,
                        grid=(blocks, "(8 x 16 pixels) x 256",
                              str(9 * c // 128)),
                        kernel=lambda: s8._k7_kernel(x, wk, scale, b7, norm,
                                                     8.0, dt),
                        call=lambda: s8.conv3x3_reflect_s8(
                            x, w7, ws7, b7, x_scale=x_scale, norm=norm,
                            out_dtype=dt),
                        moved=nbytes(x, wk) + n * h * wd * cout
                        * dt.itemsize)
        return parts

    w7 = torch.randint(-127, 128, (3, 3, 256, 256), generator=gen,
                       device="cuda", dtype=torch.int8)
    ws7 = torch.rand(256, generator=gen, device="cuda") * 1e-3 + 1e-4
    b7 = randn(256, scale=0.1)
    x7f = randn(2, 128, 128, 256)
    xs7 = x7f.abs().amax() / 127.0
    x7 = {"i": torch.round(x7f / xs7).to(torch.int8),
          "ii": (x7f * 3.0 + 0.5).to(torch.bfloat16)}
    norm7 = normed(x7["ii"].float())

    conv_dts = (("float32", (PEAK_TF32 / 3, "3 TF32 products")),
                ("bfloat16", CONV_PEAKS["bfloat16"]))
    int8_dts = tuple((d, (PEAK_INT8, "int8 tensor cores"))
                     for d in ("float32", "bfloat16"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, parts, dts in (
            ("K4", k4, conv_dts), ("K3", k3, conv_dts),
            ("K2", k2("up1"), conv_dts), ("K2", k2("up2"), conv_dts),
            ("K7", k7("i"), int8_dts), ("K7", k7("ii"), int8_dts)):
        if cases is not None and name not in cases:
            continue
        for dt_name, (peak, label) in dts:
            dt = getattr(torch, dt_name)
            q = parts(dt)
            flops = 2.0 * q["n"] * q["pixels"] * q["cout"] * q["k"]
            bound_ms, bound_by = bound_of(flops, q["moved"], peak)
            kernel_ms = cuda_ms(torch, q["kernel"])
            blocks, tile, chunks = q["grid"]
            print(f"{name} {dt_name} {q['shape']}: kernel alone "
                  f"{kernel_ms:.3f} ms (bound {bound_ms:.3f} ms by "
                  f"{bound_by}, {label}; {flops / kernel_ms / 1e9:.1f} T "
                  f"ops/s; {blocks} blocks of {tile}, {blocks / sms:.2f} "
                  f"waves on {sms} SMs, {chunks} K chunks each); "
                  + one_call(torch, q["call"]), flush=True)


def one_call(torch, call, reps=5):
    """One call's device time by kernel (``torch.profiler`` over ``reps``
    calls) beside the host's time to enqueue it (10 calls), as text."""
    cuda = torch.autograd.DeviceType.CUDA
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            k, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (k + 1, us + e.time_range.elapsed_us())
    device_ms = sum(us for _, us in by_name.values()) / reps / 1e3
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return (f"one wrapper call: device {device_ms:.3f} ms in "
            f"{sum(k for k, _ in by_name.values()) // reps} kernels, host "
            f"enqueue {host_ms:.3f} ms; largest: "
            + "; ".join(f"{kn[:60]} x{k // reps} {us / reps / 1e3:.4f} ms"
                        for kn, (k, us) in top))


def time_k6(torch):
    """K6 at the int8 forward's norm shapes (N=2 in f32 and bf16, the
    served N=16 in f32) and the layer route's body (N=1 bf16): its route
    (``k6_plan_for``: group, cluster or chunks, band, active clusters), the
    kernel alone on a built plan and output (CUDA events), one wrapper
    call's device time by kernel beside the host's enqueue time, and the
    bounds of one read and of two reads."""
    from ctagan_tpu_torch.ops import pallas_kernels as pk

    gen = torch.Generator(device="cuda").manual_seed(6)
    for shape, act, dts in (((2, 512, 512, 64), "relu", ("float32",
                                                          "bfloat16")),
                            ((2, 128, 128, 256), None, ("float32",
                                                        "bfloat16")),
                            ((2, 256, 256, 128), "leaky_relu",
                             ("float32", "bfloat16")),
                            ((16, 512, 512, 64), "relu", ("float32",)),
                            ((16, 128, 128, 256), "relu", ("float32",)),
                            ((1, 128, 128, 256), None, ("bfloat16",))):
        for dt_name in dts:
            x = (torch.randn(*shape, generator=gen, device="cuda") * 2.0
                 + 0.5).to(getattr(torch, dt_name))
            out = torch.empty_like(x)
            plan = pk.k6_plan_for(x)
            active = (pk.k6_active_clusters(x, plan)
                      if plan.route == "cluster" else "-")
            kernel_ms = cuda_ms(torch, lambda: pk._k6_launch(
                x, out, plan, 1e-5, act))
            one = nbytes(x) / PEAK_BYTES * 1e3
            blocks = shape[0] * plan.groups(shape[3]) * plan.chunks
            print(f"K6 {dt_name} N={shape[0]} {shape[1]}x{shape[2]}x"
                  f"{shape[3]} {act}: route {plan.route} (vec {plan.vec}, "
                  f"group {plan.group}, cluster {plan.cluster}, band "
                  f"{plan.band} px, {blocks} blocks of {plan.threads}, smem "
                  f"{plan.smem} B, active clusters {active}); kernel alone "
                  f"{kernel_ms:.4f} ms (bound one read {2 * one:.4f} ms, "
                  f"two reads {3 * one:.4f} ms: {2 * one / kernel_ms:.0%} "
                  f"of the first); "
                  + one_call(torch, lambda: pk.instance_norm_pallas(
                      x, activation=act)), flush=True)
            del x, out


def _counted():
    from ctagan_tpu_torch.ops import (
        fused_convt,
        fused_down,
        fused_resblock,
        fused_resblock_grad,
        fused_s8,
        pallas_kernels,
    )

    return {
        "conv3x3_reflect_stats": fused_resblock.conv3x3_reflect_stats,
        "conv3x3_s2_zero_stats": fused_down.conv3x3_s2_zero_stats,
        "convt2x_stats": fused_convt.convt2x_stats,
        "conv3x3_input_grad": fused_resblock_grad.conv3x3_input_grad,
        "conv3x3_weight_grad": fused_resblock_grad.conv3x3_weight_grad,
        "instance_norm_pallas": pallas_kernels.instance_norm_pallas,
        "conv3x3_reflect_s8": fused_s8.conv3x3_reflect_s8,
    }


def launch_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def counts_of(**nonzero):
    """Expected counts: the named kernels, every other one 0."""
    return {name: nonzero.get(name, 0) for name in _counted()}


PER_FORWARD = counts_of(conv3x3_reflect_stats=18, conv3x3_s2_zero_stats=2,
                        convt2x_stats=2)
PER_TRAIN_STEP = counts_of(conv3x3_reflect_stats=36, conv3x3_input_grad=18,
                           conv3x3_weight_grad=18)
# int8 forward with the InstanceNorm switch on: 2 K7 per residual block; K6
# after the head, the two downs and the two ups
PER_INT8_FORWARD = counts_of(conv3x3_reflect_s8=18, instance_norm_pallas=5)


def psnr(a, b):
    """PSNR over the [-1, 1] range (peak 2)."""
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))


@contextlib.contextmanager
def plain_versions():
    """K7 and K6 swapped for their plain versions inside the block: the
    module attributes through which the int8 forward reaches them."""
    from ctagan_tpu_torch.ops import fused_s8, pallas_kernels

    saved = fused_s8.conv3x3_reflect_s8, pallas_kernels.instance_norm_pallas
    fused_s8.conv3x3_reflect_s8 = fused_s8.conv3x3_reflect_s8_plain
    pallas_kernels.instance_norm_pallas = (
        pallas_kernels.instance_norm_pallas_plain)
    try:
        yield
    finally:
        fused_s8.conv3x3_reflect_s8, pallas_kernels.instance_norm_pallas = saved


@contextlib.contextmanager
def pallas_norm_switch(on=True):
    """``models.layers.USE_PALLAS_INSTANCE_NORM`` set inside the block, as a
    deployment that sets JAX's switch would run the int8 forward."""
    from ctagan_tpu_torch.models import layers

    layers.USE_PALLAS_INSTANCE_NORM = on
    try:
        yield
    finally:
        layers.USE_PALLAS_INSTANCE_NORM = False


def check_generator(torch, card):
    """Phase 3: full-width generator, serving kernel route vs plain route."""
    from ctagan_tpu_torch.models import Generator

    dev = torch.device("cuda")
    g = Generator(1, 1, n_residual_blocks=9, base_features=64)
    g = g.reset_parameters(0).to(dev).eval()
    n_params = sum(p.numel() for p in g.parameters())
    if n_params != 11_365_633:
        fail(f"generator has {n_params} parameters, expected 11,365,633")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(2, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        reset_counts()
        y = g(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != PER_FORWARD:
            fail(f"launches per forward {counts}, expected {PER_FORWARD}")
        g.fused_body = False
        y_plain = g(x)
        g.fused_body = True
    err = float((y.float() - y_plain.float()).abs().max())
    finite = bool(torch.isfinite(y).all())
    print(f"generator 9 blocks base 64 ({n_params} params) 512^2 b=2 f32: "
          f"kernel route vs plain route max_abs_err {err:.3e} (tol "
          f"{GEN_TOL:.0e}); launches per forward {counts}; finite {finite}",
          flush=True)
    if y.shape != (2, 512, 512, 1) or not finite or err > GEN_TOL:
        fail("generator kernel route disagrees with the plain route")
    for dt_name in ("float32", "bfloat16"):
        gd = Generator(1, 1, dtype=getattr(torch, dt_name))
        gd.load_state_dict(g.state_dict())
        gd = gd.to(dev).eval()
        for b in (1, 16):
            xb = torch.rand(b, 512, 512, 1, generator=gen, device=dev) * 2 - 1
            times = {}
            with torch.inference_mode():
                for route in ("plain", "kernels", "kernels", "plain"):
                    gd.fused_body = route == "kernels"
                    ms = cuda_ms(torch, lambda: gd(xb), iters=3, warmup=1)
                    times.setdefault(route, []).append(ms)
            print(f"generator forward {dt_name} 512^2 b={b}: kernel route "
                  f"{min(times['kernels']):.2f} ms, plain route "
                  f"{min(times['plain']):.2f} ms (best of 2 turns x 3 "
                  f"iters) [{card}]", flush=True)


def check_int8_generator(torch, card):
    """Phase 4: the full-width generator quantized, int8 forward through
    K7/K6 vs the same forward through their plain versions and vs the f32
    plain route, at 512² b=2; forward times at b=1 and b=16."""
    import numpy as np

    from ctagan_tpu_torch.models import Generator
    from ctagan_tpu_torch.ops.quantize import (
        generator_int8_forward,
        quantize_generator,
        quantized_size_bytes,
    )

    dev = torch.device("cuda")
    g = Generator(1, 1).reset_parameters(0).to(dev).eval()
    qp = quantize_generator(g)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(2, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        with pallas_norm_switch():
            reset_counts()
            y = generator_int8_forward(qp, x)
            torch.cuda.synchronize()
            counts = launch_counts()
            with plain_versions():
                y_plain = generator_int8_forward(qp, x)
                torch.cuda.synchronize()
            plain_counts = launch_counts()
        g.fused_body = False
        y_f32 = g(x)
        g.fused_body = True
    y, y_plain, y_f32 = (t.float().cpu().numpy() for t in (y, y_plain, y_f32))
    err = np.abs(y - y_plain)
    p_k, p_p = psnr(y, y_f32), psnr(y_plain, y_f32)
    finite = bool(np.isfinite(y).all())
    p_kp = psnr(y, y_plain)
    f32_mean = float(np.abs(y_plain - y_f32).mean())
    print(f"int8 generator ({quantized_size_bytes(qp) / 1e6:.2f} MB of "
          f"weights) 512^2 b=2: K7/K6 route vs plain versions max_abs_err "
          f"{err.max():.3e} (tol {INT8_MAX_TOL}), mean {err.mean():.3e} (tol "
          f"{INT8_MEAN_TOL}), PSNR {p_kp:.2f} dB (min {p_p:.2f} + "
          f"{INT8_PSNR_MARGIN} dB); plain versions vs the f32 plain route "
          f"mean {f32_mean:.3e}, PSNR {p_p:.2f} dB (K7/K6 route {p_k:.2f} "
          f"dB); min {INT8_PSNR_MIN} dB; launches per forward {counts}; "
          f"finite {finite}", flush=True)
    if y.shape != (2, 512, 512, 1) or not finite:
        fail("int8 generator: bad output")
    if counts != PER_INT8_FORWARD or plain_counts != counts:
        fail(f"int8 launches per forward {counts} (then {plain_counts} after "
             f"the plain versions), expected {PER_INT8_FORWARD}")
    if (err.max() > INT8_MAX_TOL or err.mean() > INT8_MEAN_TOL
            or p_kp < p_p + INT8_PSNR_MARGIN
            or min(p_k, p_p) < INT8_PSNR_MIN):
        fail("int8 generator disagrees with its plain versions or the f32 "
             "route")
    for b in (1, 16):
        xb = torch.rand(b, 512, 512, 1, generator=gen, device=dev) * 2 - 1
        times = {}
        with torch.inference_mode(), pallas_norm_switch():
            for route in ("int8", "f32 kernels", "f32 kernels", "int8"):
                fwd = ((lambda: generator_int8_forward(qp, xb))
                       if route == "int8" else (lambda: g(xb)))
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(torch, fwd, iters=3, warmup=1)
                times.setdefault(route, []).append(
                    (ms, torch.cuda.max_memory_allocated() / 1e9))
        best = {k: min(v) for k, v in times.items()}
        print(f"generator forward 512^2 b={b}: int8 route (K7 + K6) "
              f"{best['int8'][0]:.2f} ms (peak {best['int8'][1]:.2f} GB), "
              f"f32 kernel route (K1-K3) {best['f32 kernels'][0]:.2f} ms "
              f"(peak {best['f32 kernels'][1]:.2f} GB) (best of 2 turns x 3 "
              f"iters) [{card}]", flush=True)
    del g, qp
    torch.cuda.empty_cache()


def check_generator_grad(torch, card):
    """Phase 5: the generator's training route (FusedChainFunction) vs the
    plain layer route, output and every gradient, at 512² b=1 f32."""
    from ctagan_tpu_torch.models import Generator

    dev = torch.device("cuda")
    g = Generator(1, 1, fused_body=False, fused_body_grad=True)
    g = g.reset_parameters(0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand(1, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    cot = torch.randn(1, 512, 512, 1, generator=gen, device=dev)
    reset_counts()
    y = g(x)
    torch.cuda.synchronize()
    fwd = launch_counts()
    (y * cot).sum().backward()
    torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in launch_counts().items()}
    grads = [p.grad.detach().clone() for p in g.parameters()]
    g.zero_grad(set_to_none=True)
    g.fused_body_grad = False
    y_plain = g(x)
    (y_plain * cot).sum().backward()
    out_err = float((y - y_plain).abs().detach().max())
    grads_p = [p.grad.detach().clone() for p in g.parameters()]
    g64 = g.double()  # the plain route in float64: both routes' yardstick
    g64.zero_grad(set_to_none=True)
    (g64(x.double()) * cot.double()).sum().backward()
    floor = GRAD_FLOOR * max(float(p.grad.norm()) for p in g64.parameters())
    errs = {}  # name -> (kernel route, plain route) error vs float64
    for (name, p), gk, gp in zip(g64.named_parameters(), grads, grads_p):
        den = max(float(p.grad.norm()), floor)
        errs[name] = (float((gk.double() - p.grad).norm()) / den,
                      float((gp.double() - p.grad).norm()) / den)
    over = [n for n, (e_k, e_p) in errs.items()
            if e_k > GRAD_RATIO * e_p + GRAD_TOL]
    top = max(errs, key=lambda n: errs[n][0])
    finite = all(bool(torch.isfinite(t).all()) for t in grads)
    print(f"generator training route 512^2 b=1 f32: output max_abs_err "
          f"{out_err:.3e} (tol {GEN_TOL:.0e}); gradient errors vs a float64 "
          f"plain run (Frobenius, relative): largest {top} kernel route "
          f"{errs[top][0]:.3e}, plain route {errs[top][1]:.3e}; over the "
          f"limit ({GRAD_RATIO:g} x plain + {GRAD_TOL:.0e}): {over or 'none'}"
          f"; launches forward {fwd}, backward {bwd}; finite {finite}",
          flush=True)
    if out_err > GEN_TOL or over or not finite:
        fail("generator training route disagrees with the plain route")
    if fwd != counts_of(conv3x3_reflect_stats=18) or bwd != counts_of(
            conv3x3_input_grad=18, conv3x3_weight_grad=18):
        fail("training route: expected 18 K1 per forward, 18 K4 and 18 K5 "
             "per backward")
    del g, g64, grads, grads_p, y, y_plain
    torch.cuda.empty_cache()


def _post(port, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def check_serving(torch, card, quantize=""):
    """Phase 6, a main path: the port's HTTP server on HdGan.yaml. With
    ``quantize="int8"`` (phase 7, a main path of its own) the config copy
    sets ``serve_quantize: int8``, the service runs the int8 forward with
    the InstanceNorm switch on, and every response is held to the f32 plain
    route by the JAX int8 service's bound."""
    import numpy as np

    from ctagan_tpu_torch.__main__ import build_generator
    from ctagan_tpu_torch.data.dicom import (
        dicom_bytes,
        make_ct_slice,
        read_dicom,
    )
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
    from ctagan_tpu_torch.data.native import dual_window_native
    from ctagan_tpu_torch.serving.server import serve_async
    from ctagan_tpu_torch.utils.config import load_config

    path = os.path.join(REPO, "configs", "HdGan.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        if quantize:  # the config a deployment writes: serve_quantize: int8
            with open(path) as f:
                text = f.read() + f"\nserve_quantize: {quantize}\n"
            path = os.path.join(tmp, "HdGan_int8.yaml")
            with open(path, "w") as f:
                f.write(text)
        config = load_config(path)
    if config.serve_quantize != quantize:
        fail(f"serve_quantize read as {config.serve_quantize!r}")
    dev = torch.device("cuda")
    g = build_generator(config, dev)
    rng = np.random.default_rng(config.seed)
    slices = [make_ct_slice(synthetic_ct_pixels(rng, config.size))
              for _ in range(N_REQUESTS)]
    bodies = [dicom_bytes(ds) for ds in slices]
    with pallas_norm_switch(bool(quantize)):
        reset_counts()
        server, service, port = serve_async(
            g, size=config.size, max_batch=config.max_batch,
            quantize=config.serve_quantize,
            channels=config.input_nc * config.context_slices)
        try:
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as ex:
                replies = list(ex.map(lambda b: _post(port, b), bodies))
            wall = time.perf_counter() - t0
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            service.stop()
            torch.cuda.synchronize()
    counts = launch_counts()
    served = [read_dicom(body) for status, body in replies if status == 200]
    if len(served) != N_REQUESTS:
        fail(f"{N_REQUESTS - len(served)} requests were not answered 200")
    for ds_in, ds in zip(slices, served):
        px = ds.pixel_array().astype(np.float64)
        if px.shape != (config.size, config.size):
            fail(f"response shape {px.shape}")
        if ds.series_instance_uid == ds_in.series_instance_uid:
            fail("response kept the request's SeriesInstanceUID")
        if not (np.isfinite(px).all() and px.min() >= 0 and px.max() <= 4095):
            fail("response pixels outside [0, 4095]")
    # the responses against the plain layer route on the same inputs: the
    # first one (f32) or all of them (int8, whose per-tensor scales depend
    # on which slices share a batch)
    refs = slices[:N_REQUESTS if quantize else 1]
    full = np.stack([dual_window_native(ds.pixel_array())[1] for ds in refs])
    with torch.inference_mode():
        g.fused_body = False
        ref = g(torch.from_numpy(full[..., None]).to(dev))
        g.fused_body = True
    ref_px = (ref[..., 0].float().cpu().numpy() + 1.0) * 0.5 * 4095.0
    px = np.stack([ds.pixel_array() for ds in served[:len(refs)]]).astype(
        np.float64)
    px_err = float(np.abs(px - ref_px).max())
    got11, ref11 = px / 4095.0 * 2.0 - 1.0, ref_px / 4095.0 * 2.0 - 1.0
    per_slice = np.abs(got11 - ref11).mean(axis=(1, 2))
    px_mean, px_psnr = float(per_slice.max()), psnr(got11, ref11)
    if health.get("status") != "ok" or health.get("quantize") != (
            quantize or None):
        fail(f"/healthz: {health}")
    forwards = health["batches_served"] + 1  # + the warm-up forward
    per_forward = PER_INT8_FORWARD if quantize else PER_FORWARD
    expect = {k: v * forwards for k, v in per_forward.items()}
    check = (f"mean |error| per slice over [-1, 1] largest {px_mean:.4f} "
             f"(tol {INT8_SERVED_MEAN_TOL}), average {per_slice.mean():.4f}; "
             f"PSNR over the {len(refs)} slices {px_psnr:.2f} dB"
             if quantize else f"max_abs_err {px_err:.2f} (tol {PIXEL_TOL})")
    print(f"serving {config.name} size {config.size}"
          f"{' int8' if quantize else ''}: {N_REQUESTS} concurrent "
          f"requests answered 200 with valid DICOM in {wall:.3f} s "
          f"({N_REQUESTS / wall:.2f} slices/s over this liveness window, not "
          f"a throughput; {health['batches_served']} batches, p50 batch "
          f"{health['p50_batch_ms']:.1f} ms); pixels vs the f32 plain route "
          f"{check}; launches {counts} [{card}]", flush=True)
    if ((px_mean > INT8_SERVED_MEAN_TOL) if quantize
            else (px_err > PIXEL_TOL)):
        fail("served pixels disagree with the plain route")
    if counts != expect:
        fail(f"main-path launches {counts}, expected {expect}")
    return counts


def check_zero_pad_serving(torch, card, norm_switch=False):
    """``configs/HdGan_fast.yaml`` (bf16, ``pad_mode: zero``) built by the
    serve entry point's ``build_generator`` (``fused_body`` on) and served:
    the generator's layer route, as JAX's ``chain_ok`` leaves zero pad out of
    its fused body; no kernel launches. With ``norm_switch`` JAX's
    ``USE_PALLAS_INSTANCE_NORM`` is on while it serves: all 23 of the
    generator's InstanceNorms run K6 (23 launches per forward), and each
    response is held to the switch-off forward by the same bound."""
    import numpy as np

    from ctagan_tpu_torch.__main__ import build_generator
    from ctagan_tpu_torch.data.dicom import (
        dicom_bytes,
        make_ct_slice,
        read_dicom,
    )
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
    from ctagan_tpu_torch.data.native import dual_window_native
    from ctagan_tpu_torch.serving.server import serve_async
    from ctagan_tpu_torch.utils.config import load_config

    config = load_config(os.path.join(REPO, "configs", "HdGan_fast.yaml"))
    if config.pad_mode != "zero":
        fail(f"HdGan_fast.yaml pad_mode read as {config.pad_mode!r}")
    dev = torch.device("cuda")
    g = build_generator(config, dev)
    rng = np.random.default_rng(config.seed)
    slices = [make_ct_slice(synthetic_ct_pixels(rng, config.size))
              for _ in range(ZERO_PAD_REQUESTS)]
    with pallas_norm_switch(norm_switch):
        reset_counts()
        server, service, port = serve_async(
            g, size=config.size, max_batch=config.max_batch,
            quantize=config.serve_quantize,
            channels=config.input_nc * config.context_slices)
        try:
            with concurrent.futures.ThreadPoolExecutor(len(slices)) as ex:
                replies = list(ex.map(
                    lambda ds: _post(port, dicom_bytes(ds)), slices))
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            service.stop()
            torch.cuda.synchronize()
    counts = launch_counts()
    # + the warm-up forward
    expect = counts_of(instance_norm_pallas=ZERO_PAD_NORMS * (
        health["batches_served"] + 1) if norm_switch else 0)
    served = [read_dicom(body) for status, body in replies if status == 200]
    if len(served) != len(slices):
        fail(f"zero pad: {len(slices) - len(served)} requests not answered")
    errs = []
    with torch.inference_mode():
        for ds_in, ds in zip(slices, served):
            full = dual_window_native(ds_in.pixel_array())[1]
            ref = g(torch.from_numpy(full[None, ..., None]).to(dev))
            ref11 = ref[0, ..., 0].float().cpu().numpy()
            px = ds.pixel_array().astype(np.float64)
            if px.shape != (config.size, config.size) or not (
                    np.isfinite(px).all() and px.min() >= 0
                    and px.max() <= 4095):
                fail(f"zero pad: bad response {px.shape}")
            errs.append(float(np.abs(px / 4095.0 * 2.0 - 1.0 - ref11).mean()))
    print(f"serving {config.name} (HdGan_fast.yaml: {config.compute_dtype}, "
          f"pad_mode {config.pad_mode}) size {config.size}"
          f"{', InstanceNorm switch on' if norm_switch else ''}: "
          f"{len(served)} requests answered 200 with valid DICOM through the "
          f"layer route in {health['batches_served']} batches; mean |error| "
          f"per slice over [-1, 1] vs the same forward alone"
          f"{' (switch off)' if norm_switch else ''} largest {max(errs):.4f} "
          f"(tol {ZERO_PAD_MEAN_TOL:.4f}); launches {counts} (expected "
          f"{expect}) [{card}]", flush=True)
    if counts != expect:
        fail(f"zero pad launched kernels {counts}, expected {expect}")
    if max(errs) > ZERO_PAD_MEAN_TOL:
        fail("zero pad: served pixels disagree with the layer route")
    del g
    torch.cuda.empty_cache()


def _smoke_config(tmp, train_list, extra=""):
    """configs/HdGan.yaml with its list paths pointed at ``train_list``."""
    with open(os.path.join(REPO, "configs", "HdGan.yaml")) as f:
        text = f.read()
    text += "".join(f"\n{k}_list: '{train_list}'"
                    for k in ("train", "val", "test")) + "\n" + extra
    path = os.path.join(tmp, f"HdGan_smoke{len(extra)}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def check_training(torch, card):
    """Phase 8, a main path: HD stage 1 through the train entry point."""
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.models import Discriminator, Generator, RegNet
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lists = make_corpus(tmp, n_patients=2, slices_per_patient=6,
                            size=512, seed=0, lists=("train",))
        config = load_config(_smoke_config(tmp, lists["train"]))
        reset_counts()
        trainer = train(config, dev, max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        counts = launch_counts()
        losses = trainer.loss_history
        init = {
            "G": Generator(1, 1).reset_parameters(config.seed),
            "R": RegNet().reset_parameters(config.seed + 1),
            "D": Discriminator().reset_parameters(config.seed + 2),
        }
        trained = {"G": trainer.g_model, "R": trainer.r_model,
                   "D": trainer.d_model}
        moved = {k: max(float((p.detach().cpu() - q.detach()).abs().max())
                        for p, q in zip(trained[k].parameters(),
                                        init[k].parameters()))
                 for k in init}
        p50 = trainer.timer.summary(skip=1)["p50_ms"]
        del trainer, trained
        torch.cuda.empty_cache()
        plain_cfg = load_config(_smoke_config(tmp, lists["train"],
                                              "fused_body_grad: off\n"))
        reset_counts()
        plain = train(plain_cfg, dev, max_steps=PLAIN_STEPS)
        plain_counts = launch_counts()
        plain_p50 = plain.timer.summary(skip=1)["p50_ms"]
        del plain
        torch.cuda.empty_cache()
    import math

    finite = all(math.isfinite(v) for lo in losses for v in lo.values())
    expect = {k: v * TRAIN_STEPS for k, v in PER_TRAIN_STEP.items()}
    print(f"training {config.name} HD stage 1 512^2 b=1 f32 (cuDNN TF32 "
          f"off): {len(losses)} steps, last losses {losses[-1]}, all finite "
          f"{finite}; largest parameter change G {moved['G']:.3e}, R "
          f"{moved['R']:.3e}, D {moved['D']:.3e}; launches {counts} "
          f"(expected {expect}); p50 step after 2 warm-up steps: kernel "
          f"route {p50:.1f} ms, plain route (fused_body_grad off) "
          f"{plain_p50:.1f} ms [{card}]", flush=True)
    if len(losses) != TRAIN_STEPS or not finite:
        fail("training: missing or non-finite losses")
    if min(moved.values()) <= 0.0:
        fail(f"training: a net was not updated {moved}")
    if counts != expect:
        fail(f"training launches {counts}, expected {expect}")
    if plain_counts != counts_of():
        fail(f"plain route launched kernels {plain_counts}")
    return counts


def check_tensor_cores(lib_path):
    """K1's, K2's, K3's, K4's and K5's kernels (each instantiation, f32 and
    bf16 I/O) hold HGMMA (wgmma) instructions in the built library's SASS,
    so one that runs on CUDA-core FMAs fails; K7's (each input and output
    type) hold IGMMA (int8 wgmma) and no IDP4A."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"cuobjdump: {e!r}")
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[-2000:]}")
    funcs = [(f.split("\n", 1)[0].strip(), f)
             for f in res.stdout.split("Function : ")[1:]]
    for k, kernel in WGMMA_KERNELS.items():
        counts = {name: f.count("HGMMA") for name, f in funcs
                  if kernel in name}
        print(f"sass: {k} kernels and their HGMMA instructions: {counts}",
              flush=True)
        dtypes = {"f32" if "kernelIf" in name else "bf16" for name in counts}
        if dtypes != {"f32", "bf16"} or not all(counts.values()):
            fail(f"{k}'s f32 and bf16 kernels must all run on wgmma (HGMMA)")
    k7 = {name: (f.count("IGMMA"), f.count("IDP4A")) for name, f in funcs
          if K7_WGMMA_KERNEL in name}
    print(f"sass: K7 kernels and their (IGMMA, IDP4A) instructions: {k7}",
          flush=True)
    # the mangled template arguments' types (input, output), without the
    # tile width: e.g. "af" for <signed char, float, 256>
    kinds = {re.sub(r"Li\d+E.*", "", name.split(K7_WGMMA_KERNEL + "I", 1)[1])
             for name in k7}
    if len(kinds) < K7_KINDS or not all(i > 0 and d == 0
                                         for i, d in k7.values()):
        fail(f"K7's {K7_KINDS} input/output kinds must all run on int8 "
             "wgmma (IGMMA) with no IDP4A")


SOURCES = {
    "conv3x3_reflect_stats": ("ctagan_tpu_torch/csrc/fused_resblock.cu",
                              "ctagan_tpu/ops/fused_resblock.py:172"),
    "conv3x3_s2_zero_stats": ("ctagan_tpu_torch/csrc/fused_down.cu",
                              "ctagan_tpu/ops/fused_down.py:121"),
    "convt2x_stats": ("ctagan_tpu_torch/csrc/fused_convt.cu",
                      "ctagan_tpu/ops/fused_convt.py:141"),
    "conv3x3_input_grad": ("ctagan_tpu_torch/csrc/fused_resblock_grad.cuh",
                           "ctagan_tpu/ops/fused_resblock_grad.py:100"),
    "conv3x3_weight_grad": ("ctagan_tpu_torch/csrc/fused_resblock_grad.cuh",
                            "ctagan_tpu/ops/fused_resblock_grad.py:282"),
    "instance_norm_pallas": ("ctagan_tpu_torch/csrc/instance_norm.cu",
                             "ctagan_tpu/ops/pallas_kernels.py:65"),
    "conv3x3_reflect_s8": ("ctagan_tpu_torch/csrc/fused_s8.cu",
                           "ctagan_tpu/ops/fused_s8.py:105"),
}


MAIN_PATHS = {"serving": check_serving,
              "int8_serving": lambda torch, card: check_serving(
                  torch, card, quantize="int8"),
              "training": check_training}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES)
                    + " (a subset stops before the result lines)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated kernels (K1..K7) whose cases and "
                    "timing lines the kernels phase runs (stops before the "
                    "result lines)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    cases = args.cases.split(",") if args.cases else None
    try:
        import torch
    except ImportError as e:
        fail(f"torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "ctagan_tpu_torch")):
        fail(f"ctagan_tpu_torch not found beside {__file__}")
    sys.path.insert(0, REPO)
    for mod in ("jax", "flax", "ctagan_tpu"):  # the port must not need them
        sys.modules[mod] = None
    # the plain versions are the oracle: f32 convs and matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from ctagan_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load_library(verbose=True)
    print(f"built kernels from {os.path.relpath(_build.SRC_DIR, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s -> {lib._name}", flush=True)
    check_tensor_cores(lib._name)

    kernels, launches = {}, {name: 0 for name in SOURCES}
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "kernels":
            kernels = check_kernels(torch, cases)
            if cases is None or "K5" in cases:
                check_k5_operands(torch)
            time_wrapper_parts(torch, cases)
            if cases is None or "K6" in cases:
                time_k6(torch)
        elif phase == "generator":
            check_generator(torch, card)
            check_zero_pad_serving(torch, card)
            check_zero_pad_serving(torch, card, norm_switch=True)
        elif phase == "int8":
            check_int8_generator(torch, card)
        elif phase == "grad":
            check_generator_grad(torch, card)
        elif phase in MAIN_PATHS:
            for name, n in MAIN_PATHS[phase](torch, card).items():
                launches[name] += n
        else:
            fail(f"unknown phase {phase!r}")
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    if tuple(phases) != ALL_PHASES or cases is not None:
        print(f"partial run ({','.join(phases)}"
              f"{'; cases ' + args.cases if cases else ''}): no result lines",
              flush=True)
        return 0
    line = []
    for name, (src, replaces) in SOURCES.items():
        if launches[name] < 1:
            fail(f"{name} was not launched on a main path")
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     **kernels[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
