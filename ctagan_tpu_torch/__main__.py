"""Command line of the port, with the JAX entry point's (``train.py``)
modes and flags::

    python -m ctagan_tpu_torch --config configs/HdGan.yaml --mode MODE \
        [--device cuda|cpu] [--generator-ckpt G] [--resume] \
        [--train-list F] [--val-list F] [--test-list F]

- ``train``: the trainer of the config's ``name`` (``P2p``: pix2pix,
  ``CycleGan``, ``RegGan``, ``HdGan``: HD stage 1, ``HdGan2``: HD stage 2,
  ``P3d``: the 3-D family; ``train/trainers.py::build_trainer``) from
  seeded weights on ``train_list`` (or from the newest checkpoint in
  ``save_root``, the port's ``.pt`` or the JAX package's ``.ckpt``, with
  ``resume: true`` or ``--resume``), printing the running-mean losses
  every ``log_every`` steps, writing ``<save_root>/<name>_losses.csv``,
  the live panel and ``dashboard.html``, validating every ``val_every``
  epochs, saving a checkpoint after every epoch and a step-time summary
  at the end (``--max-steps N`` caps each epoch at N steps, as JAX's
  ``train.py``). A fresh stage-2 run first loads G and R from
  ``stage1_ckpt``, else from the newest ``*_hd1_e*`` in ``save_root``;
  with none it warns and starts from seeded weights. ``--supervise N``
  runs the command (without ``--supervise``) in a child process and
  relaunches it with ``--resume`` up to N times after a nonzero exit, such
  as the stall watchdog's 42 (config ``stall_timeout``).
- ``test``: the trainer's ``test()`` on ``test_list``: the generator from
  ``--generator-ckpt`` (a reference ``.pth``, a port ``.pt`` or a JAX
  ``.ckpt``), else ``generator_ckpt``, else the newest checkpoint of the
  trainer in ``save_root``, else the bootstrapped (stage 2) or seeded
  weights. It prints the masked window and full-range aggregates (and
  LPIPSw/LPIPS with ``lpips_weights``) and writes the synthetic SE2 series
  under ``image_save`` (``--no-write`` skips the writeback).
- ``train_test``: ``train``, then ``test`` with the same trainer.
- ``infer --series DIR``: a whole SE0 series through the generator
  (``parallel/serve.py::infer_series``) into ``<image_save>/volume/SE2``;
  a P3d config with ``infer_depth_sharded: true`` runs JAX's exact
  depth-sharded forward over the ranks of a group, one a visible card.
- ``figures``: qualitative PNG panels of the first test slices under
  ``<image_save>/panels`` (``TrainerBase.make_figures``), from the weights
  the trainer has (``--resume`` reads the newest checkpoint), as JAX's.
- ``export [--out PATH]``: a ``torch.export`` artifact of the generator's
  plain route (``serving/export.py``), by default
  ``<save_root>/generator.ctpt``.
- ``serve``: the HTTP service (``serving/server.py``) on the generator of
  the config's trainer, found as ``infer`` and ``export`` find it.

``infer``, ``export`` and ``serve`` take the generator as JAX's entry point
does: ``--generator-ckpt`` / ``generator_ckpt``, else the newest checkpoint
of the trainer's prefix in ``save_root``, else seeded weights; its EMA with
``ema_decay`` > 0. Every mode runs on the CUDA card unless ``--device cpu``
is given; with no card and no ``--device`` they stop with an error.

Several cards (the dp, fsdp, tp, sp and depth plans,
``parallel/mesh.py``): with ``data_parallel: true`` (the default) and more
than one visible card, ``train`` and ``train_test`` start one rank per
card themselves through ``torchrun`` (``mesh: {dp: M, fsdp: N}``, ``{dp:
M, tp: N}``, ``{dp: M, sp: N}`` or ``{dp: M, depth: N}``: M × N ranks),
after building the kernels once, and each rank trains ``batchSize`` rows
of every global batch (under tp, sp and depth the N ranks of a dp column
the same rows, under sp each its strip of them, under depth each its
slab of every volume). ``infer`` with ``infer_depth_sharded: true``
starts one rank per visible card likewise (JAX's branch uses every device
of its host). Under ``torchrun`` (its env set) the process joins the
launcher's group: ``torchrun --nproc-per-node N -m ctagan_tpu_torch
...``, with ``--device cpu`` a gloo group on the CPU. ``figures``,
``export``, ``serve`` and ``infer`` without that key run in one process,
as in JAX. ``--supervise`` wraps the launcher, which exits nonzero when a
rank does, so the whole world is relaunched.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Optional, Tuple

import torch

from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.parallel import dist
from ctagan_tpu_torch.utils.config import Config, load_config

# the modes that run over the ranks of a process group
_DP_MODES = ("train", "test", "train_test")


def _device(name: str | None) -> torch.device:
    """The card unless the caller names another device: no quiet CPU."""
    if name is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is available: the port runs on "
                             "the card; pass --device cpu to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return dev


def _trainer(config: Config, device: torch.device):
    """The config's trainer by name; a fresh HD stage-2 run (``HdGan2`` at
    epoch 0) bootstraps G and R from the newest stage-1 checkpoint, as the
    JAX package's ``train.py`` does."""
    from ctagan_tpu_torch.train.trainers import build_trainer

    trainer = build_trainer(config, device)
    if config.name == "HdGan2" and trainer.start_epoch == 0:
        try:
            trainer.bootstrap_from_stage1()
        except FileNotFoundError:
            print("warning: no stage-1 checkpoint found; training from "
                  "scratch", flush=True)
    return trainer


def _say(*args) -> None:
    """print, on rank 0 alone."""
    if dist.is_host0():
        print(*args, flush=True)


def _train(trainer, max_steps: Optional[int] = None,
           max_steps_per_epoch: Optional[int] = None):
    config, device = trainer.config, trainer.device
    n, ranks = trainer.plan.batch_scale, dist.world()
    _say(f"training {config.name} ({trainer.title}) at {config.size}^2 on "
         f"{device}, fused_body_grad {config.fused_body_grad}"
         + (f", {ranks} ranks, global batch {config.batchSize * n}"
            if ranks > 1 else "")
         + (f", max {max_steps} steps" if max_steps is not None else "")
         + (f", max {max_steps_per_epoch} steps an epoch"
            if max_steps_per_epoch is not None else ""))
    trainer.train(max_steps=max_steps,
                  max_steps_per_epoch=max_steps_per_epoch)
    s = trainer.timer.summary()
    if s and dist.is_host0():
        print(f"{trainer.steps_done} steps; over steps 2-{trainer.steps_done}"
              f": p50 {s['p50_ms']:.1f} ms, p90 {s['p90_ms']:.1f} ms, mean "
              f"{s['mean_ms']:.1f} ms per step", flush=True)
    return trainer


def _test(trainer, write_dicom: bool = True):
    config, device = trainer.config, trainer.device
    route = ("serving route (fused_body)" if config.fused_body else
             f"training route (fused_body_grad {config.fused_body_grad})")
    _say(f"testing {config.name} ({trainer.title}) at {config.size}^2 on "
         f"{device}, {route}, eval_batch {config.eval_batch}")
    t0 = time.perf_counter()
    agg = trainer.test(write_dicom=write_dicom)
    secs = time.perf_counter() - t0
    n = len(trainer.test_dataset)
    _say(f"test: {n} slices in {secs:.2f} s ({n / secs:.2f} slices/s)"
         + (f"; SE2 series under {config.image_save}" if write_dicom
            else ""))
    return trainer, agg, secs


def train(config: Config, device: torch.device,
          max_steps: Optional[int] = None,
          max_steps_per_epoch: Optional[int] = None):
    """Run the config's trainer (``max_steps``: in all, ending the run;
    ``max_steps_per_epoch``: in each epoch, the CLI's ``--max-steps``);
    returns the trainer."""
    return _train(_trainer(config, device), max_steps, max_steps_per_epoch)


def test(config: Config, device: torch.device, write_dicom: bool = True):
    """Run the config's trainer's ``test()``; returns the trainer, the
    aggregate metrics and the seconds ``test()`` took."""
    return _test(_trainer(config, device), write_dicom)


def train_test(config: Config, device: torch.device,
               max_steps_per_epoch: Optional[int] = None,
               write_dicom: bool = True):
    """``train``, then ``test()`` on the same trainer (which reads the
    newest checkpoint the run saved); returns what :func:`test` does."""
    return _test(train(config, device,
                       max_steps_per_epoch=max_steps_per_epoch), write_dicom)


def infer(config: Config, device: torch.device, series: str,
          times: Optional[dict] = None) -> str:
    """A whole SE0 series into ``<image_save>/volume/SE2``; returns that
    directory (``times``: see ``infer_series``)."""
    from ctagan_tpu_torch.parallel.serve import infer_series

    return infer_series(_trainer(config, device), series, config.image_save,
                        times)


def figures(config: Config, device: torch.device) -> str:
    """The qualitative panels; returns their directory."""
    return _trainer(config, device).make_figures()


def export(config: Config, device: torch.device,
           out: Optional[str] = None) -> str:
    """The generator's artifact at ``out`` (default
    ``<save_root>/generator.ctpt``); returns the path."""
    from ctagan_tpu_torch.serving.export import export_generator

    trainer = _trainer(config, device)
    trainer.load_inference_generator()
    out = out or os.path.join(config.save_root, "generator.ctpt")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    return export_generator(trainer._eval_model(), out, size=config.size,
                            channels=config.input_nc * config.context_slices)


def serving_generator(config: Config, device: torch.device
                      ) -> Tuple[Generator, Optional[str]]:
    """The generator ``serve`` serves, found as the JAX entry point's serve
    finds it: the config's trainer, its G from ``generator_ckpt`` (a
    reference ``.pth``, a port ``.pt`` or a JAX ``.ckpt``), else the newest
    checkpoint of its prefix in ``save_root`` (``.pt`` or ``.ckpt``), else
    seeded from ``config.seed``; the EMA with ``ema_decay`` > 0. Returned on
    the serving route (K3, K1, K2; the layer route with ``pad_mode: zero``),
    with the path loaded (or None)."""
    trainer = _trainer(config, device)
    path = trainer.load_inference_generator()
    g = trainer._eval_model()
    g.fused_body = True
    return g.eval(), path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ctagan_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", default="serve",
                    choices=["train", "test", "train_test", "infer",
                             "figures", "serve", "export"])
    ap.add_argument("--generator-ckpt", default="",
                    help="a reference .pth, a port .pt or a JAX .ckpt "
                         "(default: config generator_ckpt)")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: cuda; without a "
                         "card, only an explicit cpu runs)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="train: cap each epoch at this many steps")
    ap.add_argument("--no-write", action="store_true",
                    help="test: skip the SE2 DICOM writeback")
    ap.add_argument("--series", default=None,
                    help="infer: an SE0 series directory (whole volume)")
    ap.add_argument("--out", default=None,
                    help="export: the artifact's path (default "
                         "<save_root>/generator.ctpt)")
    ap.add_argument("--train-list", default=None,
                    help="override config train_list")
    ap.add_argument("--val-list", default=None,
                    help="override config val_list")
    ap.add_argument("--test-list", default=None,
                    help="override config test_list")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint (overrides "
                         "config)")
    ap.add_argument("--supervise", type=int, default=0, metavar="N",
                    help="run the command in a child process and relaunch "
                         "it with --resume up to N times after a nonzero "
                         "exit (a crash, or the stall_timeout watchdog's "
                         "42)")
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = ap.parse_args(argv)
    if opts.supervise > 0:
        if dist.launched():
            ap.error("--supervise relaunches the whole world: run it "
                     "outside torchrun")
        return _supervise(argv, opts.supervise)
    if opts.mode == "infer" and not opts.series:
        ap.error("--mode infer requires --series <SE0 dir>")
    config = load_config(opts.config)
    for key in ("train_list", "val_list", "test_list"):
        if getattr(opts, key):
            setattr(config, key, getattr(opts, key))
    if opts.resume:
        config.resume = True
    config.generator_ckpt = opts.generator_ckpt or config.generator_ckpt
    device = _device(opts.device)
    # the 3-D family's depth-sharded infer runs over the ranks of a group
    sharded_infer = (opts.mode == "infer" and config.name == "P3d"
                     and config.infer_depth_sharded)
    if dist.launched():
        if opts.mode not in _DP_MODES and not sharded_infer:
            if int(os.environ["WORLD_SIZE"]) > 1:
                raise SystemExit(f"--mode {opts.mode} runs in one process, "
                                 "not over the ranks of a group")
        else:
            device = dist.init(device)
            try:
                return _run(opts, config, device)
            finally:
                dist.shutdown()
    elif opts.mode in ("train", "train_test") or sharded_infer:
        n = (card_ranks(device, opts.device) if sharded_infer
             else dp_ranks(config, device, opts.device))
        if n > 1:
            if not sharded_infer:  # the 3-D forward launches no kernel
                from ctagan_tpu_torch.ops import _build

                _build.build()  # once, before the ranks would race on it
            return subprocess.call([sys.executable, "-m",
                                    "torch.distributed.run", "--standalone",
                                    f"--nproc-per-node={n}", "-m",
                                    "ctagan_tpu_torch", *argv])
    return _run(opts, config, device)


def card_ranks(device: torch.device, device_arg: Optional[str]) -> int:
    """One rank a visible card on an unnamed CUDA device, else one."""
    if device.type != "cuda" or device_arg not in (None, "cuda"):
        return 1
    return torch.cuda.device_count()


def dp_ranks(config: Config, device: torch.device,
             device_arg: Optional[str]) -> int:
    """The ranks ``--mode train`` starts itself outside a launcher: one a
    visible card under the dp, fsdp, tp, sp and depth plans (``mesh: {dp:
    M, fsdp: N}``, ``{dp: M, tp: N}``, ``{dp: M, sp: N}`` or ``{dp: M,
    depth: N}``: M × N, which the cards must hold; else every card with
    ``data_parallel``), one on the CPU, on a named card or with
    ``data_parallel: false``."""
    if device.type != "cuda" or device_arg not in (None, "cuda"):
        return 1
    cards = torch.cuda.device_count()
    if config.mesh:
        n = 1
        for axis in ("dp", "fsdp", "tp", "sp", "depth"):
            n *= int(config.mesh.get(axis, 1))
        if n > cards:
            raise SystemExit(f"mesh {config.mesh} needs {n} devices, have "
                             f"{cards}")
        return n
    return cards if config.data_parallel else 1


def _run(opts, config: Config, device: torch.device) -> int:
    if opts.mode == "train":
        train(config, device, max_steps_per_epoch=opts.max_steps)
    elif opts.mode == "test":
        test(config, device, write_dicom=not opts.no_write)
    elif opts.mode == "train_test":
        train_test(config, device, opts.max_steps,
                   write_dicom=not opts.no_write)
    elif opts.mode == "infer":
        print("synthetic CTA written to:", infer(config, device, opts.series),
              flush=True)
    elif opts.mode == "figures":
        print("panels:", figures(config, device), flush=True)
    elif opts.mode == "export":
        print("artifact written to:", export(config, device, opts.out),
              flush=True)
    else:
        _serve(config, device)
    return 0


def supervised_argv(argv) -> list:
    """The child's command: ``python -m ctagan_tpu_torch`` and ``argv``
    without ``--supervise N`` / ``--supervise=N``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--supervise":
            skip = True
        elif not a.startswith("--supervise="):
            out.append(a)
    return [sys.executable, "-m", "ctagan_tpu_torch", *out]


def _supervise(argv, max_restarts: int) -> int:
    """JAX's ``train.py --supervise``: the child until it exits 0,
    ``--resume`` from the second attempt on."""
    from ctagan_tpu_torch.utils.watchdog import supervise

    return supervise(supervised_argv(argv), max_restarts=max_restarts)


def _serve(config: Config, device: torch.device) -> None:
    from ctagan_tpu_torch.serving.server import serve

    g, path = serving_generator(config, device)
    port = config.serve_port
    print(
        f"serving CT->CTA synthesis on :{port} (POST /synthesize) on {device}"
        + (f"; weights {path}" if path
           else f"; seeded weights (seed {config.seed}): no checkpoint "
                f"given or found in {config.save_root}")
        + (f" [{config.serve_quantize}]" if config.serve_quantize else ""),
        flush=True)
    serve(g, port=port, size=config.size, max_batch=config.max_batch,
          quantize=config.serve_quantize,
          channels=config.input_nc * config.context_slices)


if __name__ == "__main__":
    sys.exit(main())
