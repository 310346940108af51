"""How far the demons registrar cuts the error of JAX's e2e registration
fixture grown to a CT series' size, by the fixture's design: the port's
registrar on the card or a CPU, or the JAX package's on a CPU.

The fixture is ``chip_smoke.py::_demons_pair`` (designs "radii", "scaled",
"vessels"; the smoke's is "vessels"), stored as a DICOM round trip stores
it (uint16 truncation). Each design goes through the package's
``register_demons_volumes`` (the rigid pre-shift and the pyramid with the
default levels and iterations); the result is written back as
``align_patient`` writes it (int16 truncation). Printed per design: the
interior mean |error| against fixed + 80 HU before and after (the last
slice and a 4-voxel border left out, as JAX's e2e test does), the cut,
the mean end-point error over the anatomy and the seconds; ``--f64``
(the port) adds the distance of ``demons_register``'s f32 φ on the raw
pair from its float64 run, which grounds the smoke's card-against-CPU
tolerance (``--depth 16 --size 128 --seed 1``). ``--profile``
(the port on the card) adds the device time by op of two iterations of
the finest level, and one call of ``smooth3d`` on a 6-channel field and
of a 3-channel ``warp_field``.

Run from the repository root:

    python3 tests/demons_fixture_study.py --package port --device cuda \\
        --depth 128 --size 512 --design radii,scaled,vessels --profile
    JAX_PLATFORMS=cpu python3 tests/demons_fixture_study.py \\
        --package jax --depth 16 --size 512 --design radii

The port's run imports nothing of JAX; ``--package jax`` imports the JAX
package (CPU only).
"""
import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def study(package, dev, D, size, design, seed=0, f64=False):
    import numpy as np
    import torch

    from chip_smoke import _demons_pair

    if package == "jax":
        from ctagan_tpu.data import registration
        from ctagan_tpu.ops import registration3d as reg3d
        kw = {}
    else:
        from ctagan_tpu_torch.data import registration
        from ctagan_tpu_torch.ops import registration3d as reg3d
        kw = {"device": dev}
    fixed, moving, anatomy, field = _demons_pair(torch, D, size, seed=seed,
                                                 dev=dev, design=design)
    stored = {k: v.clamp(0, 4095).to(torch.int32).cpu().numpy()
              for k, v in (("fixed", fixed), ("moving", moving))}
    hu = {k: v.astype(np.float32) - 1024.0 for k, v in stored.items()}
    seen = {}
    demons = reg3d.demons_register
    shift_of = registration.phase_correlation_shift

    def demons_spy(f, m, **k):
        seen["phi"] = demons(f, m, **k)
        return seen["phi"]

    def shift_spy(f, m):
        seen["shift"] = shift_of(f, m)
        return seen["shift"]

    reg3d.demons_register = demons_spy
    registration.phase_correlation_shift = shift_spy
    try:
        t0 = time.perf_counter()
        warped = registration.register_demons_volumes(hu["fixed"],
                                                      hu["moving"], **kw)
        secs = time.perf_counter() - t0
    finally:
        reg3d.demons_register = demons
        registration.phase_correlation_shift = shift_of
    written = np.clip(np.asarray(warped) + 1024.0, 0, 4095).astype(
        np.int16).astype(np.float32) - 1024.0
    target = (fixed.cpu().numpy() + 80.0 - 1024.0)[:-1, 4:-4, 4:-4]
    before = float(np.abs(hu["moving"][:-1, 4:-4, 4:-4] - target).mean())
    after = float(np.abs(written[:-1, 4:-4, 4:-4] - target).mean())
    # the residual φ(x) − s + u(x + φ(x) − s) over the anatomy (s the rigid
    # pre-shift, u the field that made the moving volume)
    phi = seen["phi"]
    if not isinstance(phi, torch.Tensor):  # JAX's
        phi = torch.as_tensor(np.asarray(phi))
    phi = phi.to(dev)
    s = [float(v) for v in seen["shift"]]
    ry, rx = phi[..., 1] - s[1], phi[..., 2] - s[2]
    uy, ux = field(torch.arange(size, device=dev).view(1, size, 1) + ry,
                   torch.arange(size, device=dev).view(1, 1, size) + rx)
    epe = torch.sqrt((phi[..., 0] - s[0]) ** 2 + (ry + uy) ** 2
                     + (rx + ux) ** 2)[anatomy > 0.1]
    print(f"{package} {design} {D}x{size}x{size} seed {seed} on {dev}: "
          f"interior |error| {before:.3f} -> {after:.3f} HU = "
          f"{before / after:.2f}x; mean EPE over the anatomy "
          f"{float(epe.mean()):.3f} voxel (pre-shift {s}); {secs:.1f} s",
          flush=True)
    if f64:  # the port's f32 registrar against its float64 run
        phi64 = reg3d._register(fixed.double(), moving.double(), 3,
                                (30, 40, 60), 3.0, 1.0, 0.02, 0.02, 0.5, 4)
        phi32 = reg3d.demons_register(fixed.cpu().numpy(),
                                      moving.cpu().numpy(), device=dev)
        gap = float((phi32.double() - phi64).abs().max())
        print(f"  demons_register(fixed, moving) in f32 against float64: "
              f"max |φ32 − φ64| {gap:.3e} voxel, |φ| max "
              f"{float(phi64.abs().max()):.3f}", flush=True)


def profile(dev, D, size):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from chip_smoke import _demons_pair
    from ctagan_tpu_torch.ops import registration3d as reg3d

    fixed, moving, _, _ = _demons_pair(torch, D, size, seed=0, dev=dev)
    f = reg3d._zscore(fixed.clamp(0, 4095).floor())
    m = reg3d._zscore(moving.clamp(0, 4095).floor())
    phi = torch.zeros((D, size, size, 3), device=dev)
    kw = dict(sigma_w=3.0, sigma_diff=1.0, lam_rel=0.02, lam_abs=0.02,
              step_cap=0.5, n_squarings=4)
    reg3d._demons_level(f, m, phi, iters=1, **kw)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        reg3d._demons_level(f, m, phi, iters=2, **kw)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=16), flush=True)
    x = torch.randn((D, size, size, 6), device=dev)
    d = x[..., :3].contiguous()
    for name, fn in (("smooth3d, 6 channels, sigma 3",
                      lambda: reg3d.smooth3d(x, 3.0)),
                     ("warp_field, 3 channels",
                      lambda: reg3d.warp_field(d, d * 0.1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        print(f"{name}: {(time.perf_counter() - t0) / 3 * 1e3:.2f} ms",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["port", "jax"], default="port")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--design", default="vessels",
                    help="comma-separated subset of radii,scaled,vessels")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f64", action="store_true",
                    help="the port's f32 demons_register on the raw pair "
                    "against its float64 run")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.package == "port":
        for mod in ("jax", "flax", "ctagan_tpu"):
            sys.modules[mod] = None
    elif args.device != "cpu":
        sys.exit("--package jax runs on the CPU only")
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    if args.device.startswith("cuda"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
        print(f"card: {card}; torch {torch.__version__}", flush=True)
    for design in args.design.split(","):
        study(args.package, args.device, args.depth, args.size, design,
              args.seed, args.f64 and args.package == "port")
    if args.profile:
        profile(args.device, args.depth, args.size)


if __name__ == "__main__":
    main()
