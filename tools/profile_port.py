#!/usr/bin/env python3
"""Where the time goes in the port's serving path, on one CUDA card.

Run from the repository root: ``python3 tools/profile_port.py``. It imports
nothing of JAX. Phases, all at 512² on ``configs/HdGan.yaml``'s generator
(9 blocks, base 64, seeded weights):

1. generator forward at b=16 under ``torch.profiler`` (3 forwards after 2
   warm-ups) for f32 with TF32 off, f32 with cuDNN's TF32 on (PyTorch's
   default, which ``python -m ctagan_tpu_torch`` leaves in place) and
   bf16: device time of K1, K3, K2 (by kernel name), of the 7×7 head and
   tail convs (by the weight shape of their ``aten::convolution``), the rest,
   and the device idle share of the window;
2. host cost per 512² request: DICOM decode + dual window, and writeback +
   encode, mean over 64 requests;
3. the HTTP service (``serve_async``, the config's ``max_batch``): 256
   requests at 16 and at 64 concurrent clients, untraced (slices/s, request
   latency p50/p99, batches), then the same 64-client window under
   ``torch.profiler`` for the device idle share.

The device idle share is 1 − (union of the device activity intervals) /
(host wall time of the window). Results are printed and written to
``chiprun_out/profile_port.json`` in the repository.
"""
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SERVE = 256
KERNEL_MODE = {"0": "K1", "1": "K3", "2": "K2"}  # conv_stats.cuh's Mode


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    return res.stdout.strip().splitlines()[0]


def device_events(torch, prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def busy_us(events):
    """Length of the union of the events' [start, end) intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_us(evt):
    """Device time of a CPU op and its children (torch >= 2.4 name first)."""
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def breakdown(torch, prof, wall_s, n_fwd):
    """Per-forward device ms by part, and the idle share of the window."""
    dev = device_events(torch, prof)
    if not dev:
        return None
    parts = {"K1": 0.0, "K3": 0.0, "K2": 0.0, "head 7x7": 0.0,
             "tail 7x7": 0.0}
    for e in dev:
        m = re.search(r"conv_stats_kernel<(\d)", e.name)
        if m:
            parts[KERNEL_MODE[m.group(1)]] += e.time_range.elapsed_us()
    for e in prof.events():
        if e.name != "aten::convolution" or not e.input_shapes:
            continue
        w = e.input_shapes[1]  # (O, I, kh, kw)
        if len(w) == 4 and w[2] == 7:
            parts["head 7x7" if w[1] == 1 else "tail 7x7"] += device_us(e)
    busy = busy_us(dev)
    total = sum(e.time_range.elapsed_us() for e in dev)
    parts["rest"] = total - sum(parts.values())
    out = {k: v / 1e3 / n_fwd for k, v in parts.items()}
    out["device busy ms"] = busy / 1e3 / n_fwd
    out["idle share"] = 1.0 - busy / (wall_s * 1e6)
    return out


def profile_forward(torch, card):
    from ctagan_tpu_torch.models import Generator

    dev = torch.device("cuda")
    base = Generator(1, 1).reset_parameters(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(16, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    results = {}
    for route, dtype, tf32 in (("f32, TF32 off", torch.float32, False),
                               ("f32, cuDNN TF32 on", torch.float32, True),
                               ("bf16", torch.bfloat16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        g = Generator(1, 1, dtype=dtype)
        g.load_state_dict(base.state_dict())
        g = g.to(dev).eval()
        with torch.inference_mode():
            for _ in range(2):
                g(x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                g(x)
            end.record()
            end.synchronize()
            untraced = start.elapsed_time(end) / 3
            with torch.profiler.profile(activities=act,
                                        record_shapes=True) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    g(x)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        b = breakdown(torch, prof, wall, 3)
        results[route] = {"forward ms (CUDA events)": untraced,
                          "forward ms (traced, host wall)": wall / 3 * 1e3,
                          "breakdown": b}
        shown = ("profiler saw no device time" if b is None else ", ".join(
            f"{k} {v:.4f}" if k == "idle share" else f"{k} {v:.2f} ms"
            for k, v in b.items()))
        print(f"forward 512^2 b=16 {route}: {untraced:.2f} ms per forward "
              f"(CUDA events); traced per forward: {shown} [{card}]",
              flush=True)
        del g
    torch.backends.cudnn.allow_tf32 = False
    return results


def host_costs(config):
    import numpy as np

    from ctagan_tpu_torch.data.dicom import (
        dicom_bytes,
        generate_uid,
        make_ct_slice,
        read_dicom,
    )
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
    from ctagan_tpu_torch.data.native import dual_window_native

    rng = np.random.default_rng(config.seed)
    bodies = [dicom_bytes(make_ct_slice(synthetic_ct_pixels(rng,
                                                            config.size)))
              for _ in range(64)]
    fake = rng.uniform(-1, 1, (config.size, config.size)).astype(np.float32)
    t_in = t_out = 0.0
    for body in bodies:
        t0 = time.perf_counter()
        ds = read_dicom(body)
        dual_window_native(ds.pixel_array())
        t1 = time.perf_counter()
        ds.set_pixel_data((fake + 1.0) * 0.5 * 4095.0)
        ds.series_instance_uid = generate_uid()
        dicom_bytes(ds)
        t2 = time.perf_counter()
        t_in += t1 - t0
        t_out += t2 - t1
    out = {"decode + window ms": t_in / len(bodies) * 1e3,
           "writeback + encode ms": t_out / len(bodies) * 1e3}
    print(f"host per 512^2 request (numpy): {out}", flush=True)
    return out, bodies


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                 data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        r.read()
        if r.status != 200:
            raise RuntimeError(f"status {r.status}")
    return time.perf_counter() - t0


def _health(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=60) as r:
        return json.loads(r.read())


def profile_serving(torch, config, bodies, card):
    import numpy as np

    from ctagan_tpu_torch.__main__ import build_generator
    from ctagan_tpu_torch.serving.server import serve_async

    g = build_generator(config, torch.device("cuda"))
    server, service, port = serve_async(
        g, size=config.size, max_batch=config.max_batch,
        channels=config.input_nc * config.context_slices)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    results = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:  # warm-up
            list(ex.map(lambda b: _post(port, b), bodies[:16]))
        for clients, traced in ((16, False), (64, False), (64, True)):
            work = [bodies[i % len(bodies)] for i in range(N_SERVE)]
            before = _health(port)["batches_served"]
            prof = (torch.profiler.profile(activities=act) if traced
                    else None)
            if prof is not None:
                prof.__enter__()
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(clients) as ex:
                lat = list(ex.map(lambda b: _post(port, b), work))
            wall = time.perf_counter() - t0
            if prof is not None:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
            health = _health(port)
            key = f"{clients} clients" + (", traced" if traced else "")
            r = {"slices/s": N_SERVE / wall, "wall s": wall,
                 "latency p50 ms": float(np.percentile(lat, 50) * 1e3),
                 "latency p99 ms": float(np.percentile(lat, 99) * 1e3),
                 "batches": health["batches_served"] - before,
                 "p50 batch ms (last 200)": health["p50_batch_ms"]}
            if prof is not None:
                dev = device_events(torch, prof)
                r["idle share"] = (1.0 - busy_us(dev) / (wall * 1e6)
                                   if dev else None)
            results[key] = r
            print(f"serving {config.name} {config.size}^2, {N_SERVE} "
                  f"requests, {key}: {r} [{card}]", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
    return results


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    sys.path.insert(0, REPO)
    for mod in ("jax", "flax", "ctagan_tpu"):
        sys.modules[mod] = None
    from ctagan_tpu_torch.ops import _build
    from ctagan_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    _build.load_library()
    config = load_config(os.path.join(REPO, "configs", "HdGan.yaml"))
    report = {"card": card, "torch": torch.__version__}
    report["forward"] = profile_forward(torch, card)
    report["host"], bodies = host_costs(config)
    torch.backends.cudnn.allow_tf32 = True  # as the entry point serves
    report["serving"] = profile_serving(torch, config, bodies, card)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_port.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
