#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``ctagan_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and no network, and imports nothing of JAX. Phases:

1. build the CUDA kernels from ``ctagan_tpu_torch/csrc`` (``ops/_build.py``);
2. each kernel (K1 conv3x3_reflect_stats, K3 conv3x3_s2_zero_stats, K2
   convt2x_stats) against its plain PyTorch version at the generator's
   512² shapes, N=2, f32 and bf16, every variant the generator uses; times
   both with CUDA events;
3. the full-width generator (9 blocks, base 64, 11,365,633 parameters,
   seeded weights) at 512², b=2: kernel route against the plain layer route,
   with exactly 18 K1, 2 K3 and 2 K2 launches per forward; forward times at
   b=1 and b=16;
4. the main path: ``serve_async`` with ``configs/HdGan.yaml``, concurrent
   POST /synthesize of synthetic DICOM slices, each response checked, one
   against the plain route; the launch counts of this run are the
   ``launches`` of the kernels line.

Any failure exits nonzero before the last line. The last line is
``{"ok": true, "device": {...}}``; the line before it is the kernels JSON.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances, stated once: f32 max |kernel − plain| <= 1e-4 · max(1, |plain|)
# (accumulation order over K = 9·C); bf16 <= 2^-7 · max(1, |plain|) (two bf16
# ulps: f32 sums that differ in the last bits round to neighbouring bf16
# values). Stats relative to their largest magnitude: f32 1e-4, bf16 1e-2.
OUT_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
STATS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# kernel route vs plain layer route of the whole f32 generator (tanh output)
GEN_TOL = 1e-3
# served pixel (0..4095 stored values) vs the plain route on the same input
PIXEL_TOL = 4.0
N_REQUESTS = 16


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


def kernel_cases(torch):
    """(kernel, case, fn, plain_fn, make_inputs) at the 512² main-path
    shapes with N=2; make_inputs(dtype) returns the keyword arguments."""
    from ctagan_tpu_torch.ops import fused_convt, fused_down, fused_resblock

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def normed(x):
        xf = x.float()
        mean = xf.mean(dim=(1, 2))
        rstd = torch.rsqrt(xf.var(dim=(1, 2)) + 1e-5)
        return torch.stack([mean, rstd], dim=1)

    def k1(variant):
        def make(dt):
            x = randn(2, 128, 128, 256).to(dt)
            kw = dict(x=x, w=randn(3, 3, 256, 256, scale=0.02),
                      b=randn(256, scale=0.1))
            if variant != "plain":
                kw["norm"] = normed(x)
            if variant in ("norm_relu", "emit_norm_relu"):
                kw["relu"] = True
            if variant == "norm_skip":
                kw["skip"] = randn(2, 128, 128, 256).to(dt)
            if variant == "emit_norm_relu":
                kw["emit_input"] = True
            return kw
        return make

    def k3(c, co):
        def make(dt):
            h = 512 if c == 64 else 256
            x = randn(2, h, h, c).to(dt)
            return dict(x=x, w=randn(3, 3, c, co, scale=0.04),
                        b=randn(co, scale=0.1), norm=normed(x), relu=True)
        return make

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

    r = fused_resblock
    d = fused_down
    t = fused_convt
    return [
        ("conv3x3_reflect_stats", f"K1 {v}", r.conv3x3_reflect_stats,
         r.conv3x3_reflect_stats_plain, k1(v))
        for v in ("norm_relu", "emit_norm_relu", "norm_skip", "plain")
    ] + [
        ("conv3x3_s2_zero_stats", "K3 down1 64->128 512^2",
         d.conv3x3_s2_zero_stats, d.conv3x3_s2_zero_stats_plain, k3(64, 128)),
        ("conv3x3_s2_zero_stats", "K3 down2 128->256 256^2",
         d.conv3x3_s2_zero_stats, d.conv3x3_s2_zero_stats_plain,
         k3(128, 256)),
        ("convt2x_stats", "K2 up1 256->128 128^2", t.convt2x_stats,
         t.convt2x_stats_plain, k2(256, 128, False)),
        ("convt2x_stats", "K2 up2 128->64 256^2 norm", t.convt2x_stats,
         t.convt2x_stats_plain, k2(128, 64, True)),
    ]


def check_kernels(torch):
    """Phase 2: every kernel case vs its plain version, f32 and bf16.
    Returns {kernel: {"max_abs_err", "ms", "plain_ms"}}; the times are
    those of the first case listed for the kernel, in f32."""
    results = {}
    for name, case, fn, plain, make in kernel_cases(torch):
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            kw = make(dt)
            got = fn(**kw)
            torch.cuda.synchronize()
            want = plain(**kw)
            out_err = float((got[0].float() - want[0].float()).abs().max())
            out_rel = rel_err(torch, got[0], want[0])
            st_rel = float((got[1] - want[1]).abs().max()
                           / want[1].abs().max().clamp_min(1.0))
            xn_rel = rel_err(torch, got[2], want[2]) if len(got) == 3 else 0.0
            ms = cuda_ms(torch, lambda: fn(**kw))
            plain_ms = cuda_ms(torch, lambda: plain(**kw))
            ok = (out_rel <= OUT_TOL[dt_name] and xn_rel <= OUT_TOL[dt_name]
                  and st_rel <= STATS_TOL[dt_name]
                  and got[0].dtype == dt and bool(torch.isfinite(
                      got[0].float()).all()))
            print(f"kernel {case} {dt_name}: out max_abs_err {out_err:.3e} "
                  f"(scaled {out_rel:.3e}, tol {OUT_TOL[dt_name]:.3e}), "
                  f"x_new scaled err {xn_rel:.3e}, stats rel err "
                  f"{st_rel:.3e} (tol {STATS_TOL[dt_name]:.0e}); "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                  f"-> {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"{case} {dt_name} disagrees with its plain version")
            entry = results.setdefault(
                name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms})
            entry["max_abs_err"] = max(entry["max_abs_err"], out_err)
    return results


def launch_counts():
    from ctagan_tpu_torch.ops import fused_convt, fused_down, fused_resblock

    return {
        "conv3x3_reflect_stats":
            fused_resblock.conv3x3_reflect_stats.launches,
        "conv3x3_s2_zero_stats": fused_down.conv3x3_s2_zero_stats.launches,
        "convt2x_stats": fused_convt.convt2x_stats.launches,
    }


def reset_counts():
    from ctagan_tpu_torch.ops import fused_convt, fused_down, fused_resblock

    fused_resblock.conv3x3_reflect_stats.launches = 0
    fused_down.conv3x3_s2_zero_stats.launches = 0
    fused_convt.convt2x_stats.launches = 0


PER_FORWARD = {"conv3x3_reflect_stats": 18, "conv3x3_s2_zero_stats": 2,
               "convt2x_stats": 2}


def check_generator(torch, card):
    """Phase 3: full-width generator, kernel route vs plain route."""
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
    return g


def _post(port, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def check_serving(torch, card):
    """Phase 4, the main path: the port's HTTP server on HdGan.yaml."""
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


def main():
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
    lib = _build.load_library()
    print(f"built kernels from {os.path.relpath(_build.SRC_DIR, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s -> {lib._name}", flush=True)

    kernels = check_kernels(torch)
    check_generator(torch, card)
    launches = check_serving(torch, card)
    sources = {
        "conv3x3_reflect_stats": ("ctagan_tpu_torch/csrc/fused_resblock.cu",
                                  "ctagan_tpu/ops/fused_resblock.py:172"),
        "conv3x3_s2_zero_stats": ("ctagan_tpu_torch/csrc/fused_down.cu",
                                  "ctagan_tpu/ops/fused_down.py:121"),
        "convt2x_stats": ("ctagan_tpu_torch/csrc/fused_convt.cu",
                          "ctagan_tpu/ops/fused_convt.py:141"),
    }
    line = []
    for name, (src, replaces) in sources.items():
        if launches[name] < 1:
            fail(f"{name} was not launched on the main path")
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": kernels[name]["max_abs_err"],
                     "ms": kernels[name]["ms"],
                     "plain_ms": kernels[name]["plain_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
