#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``ctagan_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and no network, and imports nothing of JAX. Phases:

1. build the CUDA kernels from ``ctagan_tpu_torch/csrc`` (``ops/_build.py``,
   one nvcc per source, all at once; ``-Xptxas -v`` shows each kernel's
   registers and shared memory);
2. ``kernels``: each kernel against its plain PyTorch version at the main
   paths' shapes, f32 and bf16, every variant a path uses (K1, K3, K2 at the
   serving generator's 512² shapes with N=2; K4 conv3x3_input_grad and K5
   conv3x3_weight_grad at the training body's (1, 128, 128, 256)); times the
   kernel, the plain version and one PyTorch library call of the same
   function (cuDNN: a yardstick the port never calls) with CUDA events, and
   computes each case's bound from its FLOPs and bytes;
3. ``generator``: the full-width generator (9 blocks, base 64, 11,365,633
   parameters, seeded weights) at 512², b=2: the serving kernel route
   against the plain layer route, 18 K1, 2 K3 and 2 K2 launches per forward;
   forward times at b=1 and b=16;
4. ``grad``: the generator's training route (``fused_body_grad``) against
   the plain layer route at 512², b=1, f32: output and every parameter's
   gradient, 18 K1 launches per forward, 18 K4 and 18 K5 per backward;
5. ``serving``, a main path: ``serve_async`` on ``configs/HdGan.yaml``,
   concurrent POST /synthesize of synthetic DICOM slices, each response
   checked, one against the plain route;
6. ``training``, a main path: ``python -m ctagan_tpu_torch --mode train``'s
   ``train()`` on ``configs/HdGan.yaml`` with its list paths pointed at a
   seeded 512² corpus: finite losses, G, R and D all updated, 36 K1, 18 K4
   and 18 K5 launches per step; the p50 step time of the kernel route and
   of the plain route (``fused_body_grad: off``).

The launch counts of the two main paths (each counted from zero) are the
``launches`` of the kernels line. ``--phases a,b`` runs a subset and stops
before the result lines. Any failure exits nonzero before the last line.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels JSON, and the one before that the card's name and power limit.
"""
import argparse
import concurrent.futures
import json
import os
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
N_REQUESTS = 16
TRAIN_STEPS = 12  # kernel route; the p50 skips the first 2 steps
PLAIN_STEPS = 6   # plain route, for its p50 beside the kernel route's
# H100 SXM peaks (NVIDIA's H100 data sheet, 700 W): f32 outside
# the tensor cores, bf16 dense tensor cores, HBM3 bytes/s
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
ALL_PHASES = ("kernels", "generator", "grad", "serving", "training")


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


def kernel_cases(torch):
    """(kernel, case, fn, plain_fn, make_inputs, library_fn, flops): the
    main paths' shapes; make_inputs(dtype) returns the keyword arguments,
    library_fn(kw) one PyTorch call of the same function on them (cuDNN, a
    yardstick only) and flops(kw) the case's operations."""
    import torch.nn.functional as F

    from ctagan_tpu_torch.ops import (
        fused_convt,
        fused_down,
        fused_resblock,
        fused_resblock_grad,
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

    def k1(variant, n=2):
        def make(dt):
            x = randn(n, 128, 128, 256).to(dt)
            kw = dict(x=x, w=randn(3, 3, 256, 256, scale=0.02),
                      b=randn(256, scale=0.1))
            if variant != "plain":
                kw["norm"] = normed(x)
            if variant in ("norm_relu", "emit_norm_relu"):
                kw["relu"] = True
            if variant == "norm_skip":
                kw["skip"] = randn(n, 128, 128, 256).to(dt)
            if variant == "emit_norm_relu":
                kw["emit_input"] = True
            return kw
        return make

    def k1_lib(kw):
        w = oihw(kw["w"], kw["x"].dtype)
        b = kw["b"].to(kw["x"].dtype)
        return lambda: F.conv2d(nchw(kw["x"]), w, b, padding=1)

    def k3(c, co):
        def make(dt):
            h = 512 if c == 64 else 256
            x = randn(2, h, h, c).to(dt)
            return dict(x=x, w=randn(3, 3, c, co, scale=0.04),
                        b=randn(co, scale=0.1), norm=normed(x), relu=True)
        return make

    def k3_lib(kw):
        w = oihw(kw["w"], kw["x"].dtype)
        b = kw["b"].to(kw["x"].dtype)
        return lambda: F.conv2d(nchw(kw["x"]), w, b, stride=2, padding=1)

    def k2(c, co, prenorm):
        def make(dt):
            h = 128 if c == 256 else 256
            x = randn(2, h, h, c).to(dt)
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

    def k4(dt):
        return dict(g=randn(1, 128, 128, 256).to(dt),
                    w=randn(3, 3, 256, 256, scale=0.02))

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

    def k5(variant):
        def make(dt):
            x = randn(1, 128, 128, 256).to(dt)
            kw = dict(x=x, g=randn(1, 128, 128, 256).to(dt))
            if variant != "plain":
                kw.update(norm=normed(x), relu=True)
            if variant == "norm_relu_skip":
                kw["skip"] = randn(1, 128, 128, 256).to(dt)
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

    r, d, t = fused_resblock, fused_down, fused_convt
    gr = fused_resblock_grad
    return [
        ("conv3x3_reflect_stats", f"K1 {v} N=2 128^2x256->256",
         r.conv3x3_reflect_stats, r.conv3x3_reflect_stats_plain, k1(v),
         k1_lib, x_flops(lambda kw: kw["w"].shape[3]))
        for v in ("norm_relu", "emit_norm_relu", "norm_skip", "plain")
    ] + [
        ("conv3x3_s2_zero_stats", "K3 down1 N=2 64->128 512^2",
         d.conv3x3_s2_zero_stats, d.conv3x3_s2_zero_stats_plain, k3(64, 128),
         k3_lib, down_flops),
        ("conv3x3_s2_zero_stats", "K3 down2 N=2 128->256 256^2",
         d.conv3x3_s2_zero_stats, d.conv3x3_s2_zero_stats_plain,
         k3(128, 256), k3_lib, down_flops),
        ("convt2x_stats", "K2 up1 N=2 256->128 128^2", t.convt2x_stats,
         t.convt2x_stats_plain, k2(256, 128, False), k2_lib,
         x_flops(lambda kw: kw["kernel_t"].shape[1])),
        ("convt2x_stats", "K2 up2 N=2 128->64 256^2 norm", t.convt2x_stats,
         t.convt2x_stats_plain, k2(128, 64, True), k2_lib,
         x_flops(lambda kw: kw["kernel_t"].shape[1])),
        ("conv3x3_input_grad", "K4 N=1 128^2x256->256",
         gr.conv3x3_input_grad, gr.conv3x3_input_grad_plain, k4, k4_lib,
         k4_flops),
    ] + [
        ("conv3x3_weight_grad", f"K5 {v} N=1 128^2x256->256",
         gr.conv3x3_weight_grad, gr.conv3x3_weight_grad_plain, k5(v), k5_lib,
         x_flops(lambda kw: kw["g"].shape[3]))
        for v in ("norm_relu", "plain", "norm_relu_skip")
    ]


def bound_of(flops, moved, dt_name):
    """(bound ms, 'operations' or 'bytes'): the larger of the two times."""
    peak = PEAK_F32 if dt_name == "float32" else PEAK_BF16
    ops_ms, bytes_ms = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def check_kernels(torch):
    """Phase 2: every kernel case vs its plain version, f32 and bf16.
    Returns {kernel: {...}}; the times and bound are those of the first
    case listed for the kernel, in f32."""
    results = {}
    for name, case, fn, plain, make, library, flops_of in kernel_cases(torch):
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            kw = make(dt)
            got = as_tuple(fn(**kw))
            torch.cuda.synchronize()
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
            bound_ms, bound_by = bound_of(flops, moved, dt_name)
            other = bound_of(flops, moved, "bfloat16" if dt_name == "float32"
                             else "float32")[0]
            ok = (out_rel <= OUT_TOL[dt_name] and xn_rel <= OUT_TOL[dt_name]
                  and st_rel <= STATS_TOL[dt_name]
                  and got[0].dtype == want[0].dtype and bool(torch.isfinite(
                      got[0].float()).all()))
            print(f"kernel {case} {dt_name}: out max_abs_err {out_err:.3e} "
                  f"(scaled {out_rel:.3e}, tol {OUT_TOL[dt_name]:.3e}), "
                  f"x_new scaled err {xn_rel:.3e}, stats rel err "
                  f"{st_rel:.3e} (tol {STATS_TOL[dt_name]:.0e}); "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
                  f"{library_ms:.3f} ms; {flops / 1e9:.2f} GFLOP, "
                  f"{moved / 1e6:.1f} MB: bound {bound_ms:.3f} ms by "
                  f"{bound_by} ({'f32 CUDA cores' if dt_name == 'float32' else 'bf16 tensor cores'}"
                  f"; {'bf16 tensor cores' if dt_name == 'float32' else 'f32 CUDA cores'} "
                  f"{other:.3f} ms), kernel at {flops / ms / 1e9:.1f} "
                  f"TFLOP/s -> {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"{case} {dt_name} disagrees with its plain version")
            entry = results.setdefault(name, {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms})
            entry["max_abs_err"] = max(entry["max_abs_err"], out_err)
            del kw, got, want
    return results


def _counted():
    from ctagan_tpu_torch.ops import (
        fused_convt,
        fused_down,
        fused_resblock,
        fused_resblock_grad,
    )

    return {
        "conv3x3_reflect_stats": fused_resblock.conv3x3_reflect_stats,
        "conv3x3_s2_zero_stats": fused_down.conv3x3_s2_zero_stats,
        "convt2x_stats": fused_convt.convt2x_stats,
        "conv3x3_input_grad": fused_resblock_grad.conv3x3_input_grad,
        "conv3x3_weight_grad": fused_resblock_grad.conv3x3_weight_grad,
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


def check_generator_grad(torch, card):
    """Phase 4: the generator's training route (FusedChainFunction) vs the
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


def check_serving(torch, card):
    """Phase 5, a main path: the port's HTTP server on HdGan.yaml."""
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

    config = load_config(os.path.join(REPO, "configs", "HdGan.yaml"))
    dev = torch.device("cuda")
    g = build_generator(config, dev)
    rng = np.random.default_rng(config.seed)
    slices = [make_ct_slice(synthetic_ct_pixels(rng, config.size))
              for _ in range(N_REQUESTS)]
    bodies = [dicom_bytes(ds) for ds in slices]
    reset_counts()
    server, service, port = serve_async(
        g, size=config.size, max_batch=config.max_batch,
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
    # one response against the plain layer route on the same input
    _, full = dual_window_native(slices[0].pixel_array())
    with torch.inference_mode():
        g.fused_body = False
        ref = g(torch.from_numpy(full[None, :, :, None]).to(dev))
        g.fused_body = True
    ref_px = (ref[0, :, :, 0].float().cpu().numpy() + 1.0) * 0.5 * 4095.0
    px_err = float(np.abs(served[0].pixel_array() - ref_px).max())
    if health.get("status") != "ok":
        fail(f"/healthz: {health}")
    forwards = health["batches_served"] + 1  # + the warm-up forward
    expect = {k: v * forwards for k, v in PER_FORWARD.items()}
    print(f"serving {config.name} size {config.size}: {N_REQUESTS} concurrent "
          f"requests answered 200 with valid DICOM in {wall:.3f} s "
          f"({N_REQUESTS / wall:.2f} slices/s over this liveness window, not "
          f"a throughput; {health['batches_served']} batches, p50 batch "
          f"{health['p50_batch_ms']:.1f} ms); pixels vs "
          f"plain route max_abs_err {px_err:.2f} (tol {PIXEL_TOL}); launches "
          f"{counts} [{card}]", flush=True)
    if px_err > PIXEL_TOL:
        fail("served pixels disagree with the plain route")
    if counts != expect:
        fail(f"main-path launches {counts}, expected {expect}")
    return counts


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
    """Phase 6, a main path: HD stage 1 through the train entry point."""
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
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES)
                    + " (a subset stops before the result lines)")
    phases = ap.parse_args().phases.split(",")
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

    kernels, launches = {}, {name: 0 for name in SOURCES}
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "kernels":
            kernels = check_kernels(torch)
        elif phase == "generator":
            check_generator(torch, card)
        elif phase == "grad":
            check_generator_grad(torch, card)
        elif phase in ("serving", "training"):
            run = check_serving if phase == "serving" else check_training
            for name, n in run(torch, card).items():
                launches[name] += n
        else:
            fail(f"unknown phase {phase!r}")
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    if tuple(phases) != ALL_PHASES:
        print(f"partial run ({','.join(phases)}): no result lines",
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
