#!/usr/bin/env python3
"""K5 (conv3x3_weight_grad) on the card: where a K chunk's time goes.

Run from the repository root on a machine with one CUDA card and nvcc::

    python3 tools/k5_phases.py [--compare DIR[,DIR...]] [--out FILE]

It builds ``ctagan_tpu_torch/csrc/fused_resblock.cu`` with
``-DCTK_K5_PHASES`` (``clock64`` marks in K5's main loop, read by thread 0
of each block; the port's own build has none) into ``build/k5_phases/``,
and at the training body's (1, 128, 128, 256) -> 256 with the norm+ReLU
prologue, in f32 and bf16 (``--compare DIR,...``: also the same from the
sources in each DIR, e.g. a parent checkout's ``ctagan_tpu_torch/csrc``,
with the same C interface, measured in turns with the repo's: repo, each
DIR, each DIR again in reverse order, repo):

- the cycles per K chunk of each phase of the main loop, averaged over
  every block's chunks, beside the chunk's tensor-core time at the peak
  rate (989 TFLOP/s bf16, 495 TF32, at the top SM clock ``nvidia-smi``
  reads);
- with CUDA events (mean of 20 after 3 warm-ups, the port's own library):
  the kernel alone on ready operands and the whole wrapper
  ``conv3x3_weight_grad``; with ``torch.profiler`` (device time per call,
  5 calls), the wrapper's K-major copy of g (``k5_operands``: one launch,
  too short to time with events behind the host's launch cost) and, by
  kernel name, what cuDNN runs for the same function
  (``torch.nn.grad.conv2d_weight``, TF32 off), a yardstick the port never
  calls.

Imports torch and the port, never JAX. Prints one JSON object as its last
line and writes it to ``--out``.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("wgmma issue", "A loads' arrival + prologue + split",
          "A shared-memory stores", "next chunk's A loads + B copies issue",
          "wait for the tensor cores", "f32 sums + B arrival + barrier",
          "pipeline fill (per block)", "epilogue atomics (per block)")
PEAK = {"float32": 495e12 / 3, "bfloat16": 989e12}  # f32: 3 TF32 products


def build(src_dir, tag, nvcc_flags, nvcc, signature):
    """The instrumented library of ``src_dir``'s fused_resblock.cu."""
    out_dir = os.path.join(REPO, "build", "k5_phases")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"libk5_phases_{tag}.so")
    cmd = [nvcc, *nvcc_flags, "-DCTK_K5_PHASES", "-Xptxas", "-v", "-shared",
           "-o", path, os.path.join(src_dir, "fused_resblock.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed: {res.stderr[-4000:]}")
    print(f"{tag}: " + "\n".join(
        line for line in res.stderr.splitlines()
        if "wgrad_kernel" in line or "registers" in line), flush=True)
    lib = ctypes.CDLL(path)
    lib.ctk_conv3x3_weight_grad.argtypes = signature
    lib.ctk_conv3x3_weight_grad.restype = ctypes.c_int
    lib.ctk_k5_phases.argtypes = [ctypes.c_void_p]
    lib.ctk_k5_phases.restype = ctypes.c_int
    return lib


def max_sm_clock_hz():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    return float(res.stdout.split()[0]) * 1e6


def events_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def profiled(torch, fn, reps=5):
    """{device kernel name: ms per call} of ``fn`` under torch.profiler,
    after one untraced call."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {k: v / 1e3 / reps for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "k5_phases.json"))
    ap.add_argument("--compare", default="",
                    help="comma-separated csrc directories to measure in "
                         "turns with the repo's")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this measures K5 on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    from ctagan_tpu_torch.ops import _build
    from ctagan_tpu_torch.ops.fused_resblock_grad import (
        _sm_count,
        conv3x3_weight_grad,
        k5_operands,
        k5_plan,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    sig = _build._SIGNATURES["ctk_conv3x3_weight_grad"]
    libs = {"repo": build(_build.SRC_DIR, "repo", _build.NVCC_FLAGS,
                          _build._nvcc(), sig)}
    dirs = [d for d in opts.compare.split(",") if d]
    for d in dirs:
        libs[d] = build(os.path.abspath(d), f"compare{len(libs)}",
                        _build.NVCC_FLAGS, _build._nvcc(), sig)
    turns = ["repo", *dirs, *dirs[::-1], "repo"] if dirs else ["repo"]
    _build.load_library()  # the port's own build, for the wrapper timings

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, h, w, c, cout = 1, 128, 128, 256, 256
    flops = 2.0 * n * h * w * 9 * c * cout
    # the peak rates are at the top SM clock: per SM and cycle
    max_hz = max_sm_clock_hz()
    sms = _sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "max_sm_clock_mhz": max_hz / 1e6,
              "compare": opts.compare or None, "dtypes": {}}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        x = torch.randn(n, h, w, c, generator=gen, device=dev).to(dt)
        g = torch.randn(n, h, w, cout, generator=gen, device=dev).to(dt)
        xf = x.float()
        norm = torch.stack([xf.mean(dim=(1, 2)),
                            torch.rsqrt(xf.var(dim=(1, 2)) + 1e-5)], dim=1)
        ghi, glo = k5_operands(g, dt)
        bn, hwp, per, splits = k5_plan(n, h * w, c, cout, dt, sms)
        dw = torch.zeros(3, 3, c, cout, device=dev)

        def kernel(lib):
            rc = lib.ctk_conv3x3_weight_grad(
                x.data_ptr(), None, ghi.data_ptr(),
                glo.data_ptr() if glo is not None else None, norm.data_ptr(),
                dw.data_ptr(), n, h, w, c, cout, hwp, 1, bn, per, splits,
                int(dt == torch.bfloat16), stream)
            if rc:
                sys.exit(f"launch failed: CUDA error {rc}")

        tiles = 9 * (c // 128) * (cout // bn)
        reps = 5
        blocks = tiles * splits * reps
        chunks = tiles * (n * hwp // (128 // x.element_size())) * reps
        chunk_flops = flops / (chunks / reps)
        mma = chunk_flops / (PEAK[dt_name] / sms / max_hz)
        cyc = {tag: [0] * 8 for tag in libs}
        inst = {tag: [] for tag in libs}
        for tag in turns:
            lib, buf = libs[tag], (ctypes.c_ulonglong * 8)()
            kernel(lib)
            torch.cuda.synchronize()
            if lib.ctk_k5_phases(buf):  # reset after the warm-up call
                sys.exit("ctk_k5_phases failed")
            for _ in range(reps):
                kernel(lib)
            torch.cuda.synchronize()
            if lib.ctk_k5_phases(buf):
                sys.exit("ctk_k5_phases failed")
            cyc[tag] = [a + b / turns.count(tag) for a, b in zip(cyc[tag],
                                                                 buf)]
            inst[tag].append(events_ms(torch, lambda: kernel(lib)))
        copy = profiled(torch, lambda: k5_operands(g, dt))
        cudnn = profiled(torch, lambda: torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (cout, c, 3, 3), g.permute(0, 3, 1, 2),
            padding=1))

        def port_kernel():  # the port's build on ready operands
            _build.launch(
                "ctk_conv3x3_weight_grad", x.data_ptr(), None, ghi.data_ptr(),
                glo.data_ptr() if glo is not None else None, norm.data_ptr(),
                dw.data_ptr(), n, h, w, c, cout, hwp, 1, bn, per, splits,
                int(dt == torch.bfloat16), stream)

        kernel_ms = events_ms(torch, port_kernel)
        wrapper_ms = events_ms(
            torch, lambda: conv3x3_weight_grad(x, g, norm=norm, relu=True))
        r = {
            "plan": {"bn": bn, "hwp": hwp, "chunks_per_block": per,
                     "splits": splits, "blocks": tiles * splits},
            "tensor_core_cycles_per_chunk_at_peak": mma,
            "k_major_copy_device_ms": copy,
            "cudnn_conv2d_weight_device_ms": cudnn,
            "kernel_alone_ms": kernel_ms,
            "wrapper_ms": wrapper_ms,
        }
        for tag in libs:
            per_chunk = {name: cyc[tag][i] / chunks
                         for i, name in enumerate(PHASES[:6])}
            r[tag] = {
                "cycles_per_chunk": per_chunk,
                "cycles_per_block": {
                    name: cyc[tag][i] / blocks
                    for i, name in enumerate(PHASES[6:], start=6)},
                "loop_cycles_per_chunk": sum(per_chunk.values()),
                "instrumented_kernel_ms": inst[tag],
            }
        result["dtypes"][dt_name] = r
        print(f"K5 {dt_name} 128^2x256->256 norm+relu [{card}]: "
              f"{json.dumps(r)}", flush=True)
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
