#!/usr/bin/env python3
"""Where the time goes in the port's serving and training paths, on one
CUDA card.

Run from the repository root: ``python3 tools/profile_port.py [--only
training]``. It imports nothing of JAX. Phases, all at 512² on
``configs/HdGan.yaml``'s generator (9 blocks, base 64, seeded weights):

1. generator forward at b=16 under ``torch.profiler`` (3 forwards after 2
   warm-ups) for f32 with TF32 off, f32 with cuDNN's TF32 on (PyTorch's
   default, which ``python -m ctagan_tpu_torch`` leaves in place), bf16
   and the int8 forward (``serve_quantize: int8``, TF32 off, the
   InstanceNorm switch on): device time of K1, K3, K2, K7 and K6 (by kernel
   name), of the int8 GEMMs of the downs and ups (``aten::_int_mm``), of the
   7×7 head and tail convs (by the weight shape of their
   ``aten::cudnn_convolution``; each op's own kernels), the rest, and the
   device idle share of the window;
2. host cost per 512² request: DICOM decode + dual window, and writeback +
   encode, mean over 64 requests;
3. the HTTP service (``serve_async``, the config's ``max_batch``) on the
   generator ``--mode serve`` builds (``__main__.serving_generator``: the
   newest checkpoint in the config's ``save_root``, else seeded): 256
   requests at 16 and at 64 concurrent clients, untraced (slices/s, request
   latency p50/p99, batches), then the same 64-client window under
   ``torch.profiler`` for the device idle share.

4. the HD stage-1 training step (``HdTrainerStage1`` on a seeded 512²
   corpus, b=1, f32) under ``torch.profiler`` over 20 steps after 2 warm-up
   steps, for the kernel route with cuDNN's TF32 off and on (PyTorch's
   default, which ``--mode train`` keeps) and the plain route: device time
   per step of K1, K4, K5 (by kernel name), of the RegNet, the
   discriminator and the generator's plain layers (each profiled alone on
   the step's shapes, doing the step's share of work: R forward + backward;
   D three forwards, one input backward and one weight backward; the
   generator's head and tail forward twice and backward once), the rest,
   and the device idle share of the window.

The device idle share is 1 − (union of the device activity intervals) /
(host wall time of the window). Results are printed and written to
``chiprun_out/profile_port.json`` in the repository.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SERVE = 256
TRAIN_STEPS = 20


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


def breakdown(torch, prof, wall_s, n_fwd):
    """Per-forward device ms by part, and the idle share of the window."""
    dev = device_events(torch, prof)
    if not dev:
        return None
    parts = {"K1": 0.0, "K3": 0.0, "K2": 0.0, "K7": 0.0, "K6": 0.0,
             "int8 GEMM": 0.0, "head 7x7": 0.0, "tail 7x7": 0.0}
    for e in dev:
        part = kernel_part(e.name)
        if part:
            parts[part] += e.time_range.elapsed_us()
        elif "k7_wgmma_kernel" in e.name:
            parts["K7"] += e.time_range.elapsed_us()
        elif "inorm::k6_" in e.name:  # csrc/instance_norm.cu
            parts["K6"] += e.time_range.elapsed_us()
    seen = set()
    for e in prof.events():
        # the op's own kernels, each event once: torch 2.11's device totals
        # of CPU ops over-counted the int8 route's last 7x7 conv fourfold
        if e.id in seen or e.name not in ("aten::_int_mm",
                                          "aten::cudnn_convolution"):
            continue
        seen.add(e.id)
        own_us = sum(k.duration for k in e.kernels)
        if e.name == "aten::_int_mm":
            parts["int8 GEMM"] += own_us
            continue
        w = e.input_shapes[1] if e.input_shapes else ()  # (O, I, kh, kw)
        if len(w) == 4 and w[2] == 7:
            parts["head 7x7" if w[1] == 1 else "tail 7x7"] += own_us
    busy = busy_us(dev)
    total = sum(e.time_range.elapsed_us() for e in dev)
    parts["rest"] = total - sum(parts.values())
    out = {k: v / 1e3 / n_fwd for k, v in parts.items()
           if v or k == "rest"}
    out["device busy ms"] = busy / 1e3 / n_fwd
    out["idle share"] = 1.0 - busy / (wall_s * 1e6)
    return out


def profile_forward(torch, card):
    from ctagan_tpu_torch.models import Generator, layers
    from ctagan_tpu_torch.ops.quantize import (
        generator_int8_forward,
        quantize_generator,
    )

    dev = torch.device("cuda")
    base = Generator(1, 1).reset_parameters(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(16, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    results = {}
    for route, dtype, tf32 in (("f32, TF32 off", torch.float32, False),
                               ("f32, cuDNN TF32 on", torch.float32, True),
                               ("bf16", torch.bfloat16, False),
                               ("int8, TF32 off", None, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        g = Generator(1, 1, dtype=dtype)
        g.load_state_dict(base.state_dict())
        g = g.to(dev).eval()
        if dtype is None:  # int8: K7 body, K6 norms (the switch on)
            qp = quantize_generator(g)
            layers.USE_PALLAS_INSTANCE_NORM = True

            def fwd():
                return generator_int8_forward(qp, x)
        else:
            def fwd():
                return g(x)
        with torch.inference_mode():
            for _ in range(2):
                fwd()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fwd()
            end.record()
            end.synchronize()
            untraced = start.elapsed_time(end) / 3
            with torch.profiler.profile(activities=act,
                                        record_shapes=True) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    fwd()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        layers.USE_PALLAS_INSTANCE_NORM = False
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

    from ctagan_tpu_torch.__main__ import serving_generator
    from ctagan_tpu_torch.serving.server import serve_async

    g, _ = serving_generator(config, torch.device("cuda"))
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


# K1-K5 by their wgmma kernels' names
KERNEL_PARTS = (("k1_wgmma_kernel", "K1"), ("k2_wgmma_kernel", "K2"),
                ("k3_wgmma_kernel", "K3"), ("k4_wgmma_kernel", "K4"),
                ("wgrad_kernel", "K5"))


def kernel_part(name):
    """K1-K5 by the kernel's name, or None."""
    return next((part for kernel, part in KERNEL_PARTS if kernel in name),
                None)


def device_ms(torch, fn, reps=5):
    """Device time per call of ``fn`` under torch.profiler (sum of its
    device events / reps), after one untraced call."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = device_events(torch, prof)
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


def component_ms(torch, trainer):
    """Device ms per step of R, D and the generator's plain layers, each run
    alone on the step's shapes with the step's share of work."""
    dev = trainer.device
    g, r, d = trainer.g_model, trainer.r_model, trainer.d_model
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand(*shape, grad=False):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1
                ).requires_grad_(grad)

    img, real = rand(1, 512, 512, 1), rand(1, 512, 512, 1)
    body = rand(1, 128, 128, 256, grad=True)
    fake = rand(1, 512, 512, 1, grad=True)

    def g_plain():
        head = g.model_head(img)
        tail = g.model_tail(body)
        torch.autograd.backward([head, tail], [torch.ones_like(head),
                                               torch.ones_like(tail)])
        with torch.no_grad():  # the D update's re-forward
            g.model_tail(g.model_head(img))

    def r_step():
        flow = r(fake, real)
        flow.backward(torch.ones_like(flow))

    def d_step():
        out = d(fake)  # G's adversarial term: input gradient only
        torch.autograd.grad(out.sum(), fake)
        loss = d(fake.detach()).square().mean() + d(real).square().mean()
        torch.autograd.grad(loss, list(d.parameters()))

    out = {"G plain layers": device_ms(torch, g_plain),
           "RegNet": device_ms(torch, r_step), "D": device_ms(torch, d_step)}
    for m in (g, r, d):
        m.zero_grad(set_to_none=True)
    return out


def _train_config(tmp, train_list, extra=""):
    with open(os.path.join(REPO, "configs", "HdGan.yaml")) as f:
        text = f.read()
    text += "".join(f"\n{k}_list: '{train_list}'"
                    for k in ("train", "val", "test"))
    text += f"\nsave_root: '{tmp}/model/'\n" + extra
    path = os.path.join(tmp, f"HdGan_profile{len(extra)}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def profile_training(torch, card):
    """HD stage-1 step breakdown over TRAIN_STEPS profiled steps."""
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.train.trainers import HdTrainerStage1
    from ctagan_tpu_torch.utils.config import load_config

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 24 slices: an epoch outlasts the 2 + TRAIN_STEPS steps, so no
        # epoch-end checkpoint lands in the profiled window
        lists = make_corpus(tmp, n_patients=2, slices_per_patient=12,
                            size=512, seed=0, lists=("train",))
        for route, tf32, extra in (
                ("kernel route, TF32 off", False, ""),
                ("kernel route, cuDNN TF32 on (--mode train)", True, ""),
                ("plain route, TF32 off", False, "fused_body_grad: off\n")):
            torch.backends.cudnn.allow_tf32 = tf32
            config = load_config(_train_config(tmp, lists["train"], extra))
            trainer = HdTrainerStage1(config, torch.device("cuda"),
                                      quiet=True)
            trainer.train(max_steps=2)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=act) as prof:
                t0 = time.perf_counter()
                trainer.train(max_steps=2 + TRAIN_STEPS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev = device_events(torch, prof)
            per = {"K1": 0.0, "K4": 0.0, "K5": 0.0}
            for e in dev:
                part = kernel_part(e.name)
                if part in per:
                    per[part] += e.time_range.elapsed_us()
            busy = busy_us(dev)
            total = sum(e.time_range.elapsed_us() for e in dev)
            row = {k: v / 1e3 / TRAIN_STEPS for k, v in per.items()}
            row.update(component_ms(torch, trainer))
            row["device total ms"] = total / 1e3 / TRAIN_STEPS
            row["rest"] = row["device total ms"] - sum(
                row[k] for k in ("K1", "K4", "K5", "G plain layers",
                                 "RegNet", "D"))
            row["step ms (traced, host wall)"] = wall / TRAIN_STEPS * 1e3
            row["idle share"] = 1.0 - busy / (wall * 1e6)
            results[route] = row
            print(f"training step 512^2 b=1 f32, {route}: " + ", ".join(
                f"{k} {v:.4f}" if k == "idle share" else f"{k} {v:.2f}"
                for k, v in row.items()) + f" [{card}]", flush=True)
            del trainer
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["forward", "serving", "training"],
                    help="run one part (default: all)")
    only = ap.parse_args().only
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
    if only in (None, "forward"):
        report["forward"] = profile_forward(torch, card)
    if only in (None, "serving"):
        report["host"], bodies = host_costs(config)
        torch.backends.cudnn.allow_tf32 = True  # as the entry point serves
        report["serving"] = profile_serving(torch, config, bodies, card)
        torch.backends.cudnn.allow_tf32 = False
    if only in (None, "training"):
        report["training"] = profile_training(torch, card)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "profile_port.json" if only is None else f"profile_{only}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
