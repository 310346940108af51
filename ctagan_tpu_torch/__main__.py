"""Command line of the port::

    python -m ctagan_tpu_torch --config configs/HdGan.yaml --mode serve \
        [--generator-ckpt G.pth] [--device cuda|cpu]
    python -m ctagan_tpu_torch --config configs/HdGan.yaml --mode train \
        [--max-steps N] [--device cuda|cpu]
    python -m ctagan_tpu_torch --config configs/HdGan.yaml --mode test \
        [--generator-ckpt G.pth|G.pt] [--no-write] [--device cuda|cpu]

``serve`` serves the generator over HTTP (``serving/server.py``), like the
``--mode serve`` branch of the JAX package's ``train.py``. The checkpoint is
a reference-format ``.pth`` state dict (``model_head.1.weight`` ...), such
as the one ``ctagan_tpu.models.torch_export.save_state_dict`` writes from a
JAX checkpoint. Without one, the generator serves weights drawn from the
config's ``seed``.

``train`` runs the trainer of the config's ``name`` (``P2p``: pix2pix,
``CycleGan``, ``RegGan``, ``HdGan``: HD stage 1, ``HdGan2``: HD stage 2;
``train/trainers.py::build_trainer``; ``P3d`` raises naming its ROADMAP
item) from seeded
weights on the config's ``train_list`` (or from the newest checkpoint in
``save_root`` with ``resume: true``), printing the losses every
``log_every`` steps, validating every ``val_every`` epochs and saving a
checkpoint after every epoch, and a step-time summary at the end. A fresh
stage-2 run first loads G and R from ``stage1_ckpt``, else from the newest
``*_hd1_e*.pt`` in ``save_root``; with none it warns and starts from seeded
weights.

``test`` runs the same trainer's ``test()`` on the config's
``test_list``: the generator from ``--generator-ckpt`` (a reference-format
``.pth`` or a port ``.pt`` checkpoint), else ``generator_ckpt``, else the
newest checkpoint of the trainer in ``save_root``, else the bootstrapped
(stage 2) or seeded weights. It prints the
masked window and full-range aggregates (MAE, PSNR, SSIM, UQI) as the
reference does and writes the synthetic SE2 series under ``image_save``
(``--no-write`` skips the writeback).

All three run on the CUDA card unless ``--device cpu`` is given; with no
card and no ``--device`` they stop with an error.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.utils.config import Config, load_config


def build_generator(config: Config, device: torch.device,
                    ckpt: str = "") -> Generator:
    """The config's full-width generator on ``device``: weights from the
    ``.pth`` at ``ckpt``, or seeded from ``config.seed``."""
    g = Generator(
        config.input_nc * config.context_slices, config.output_nc,
        dtype=(torch.bfloat16 if config.compute_dtype == "bfloat16"
               else None),
        pad_mode=config.pad_mode,
    )
    if ckpt:
        g.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True), strict=True)
    else:
        g.reset_parameters(config.seed)
    return g.to(device).eval()


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


def train(config: Config, device: torch.device,
          max_steps: int | None = None):
    """Run the config's trainer; returns the trainer."""
    trainer = _trainer(config, device)
    print(f"training {config.name} ({trainer.title}) at {config.size}^2 on "
          f"{device}, fused_body_grad {config.fused_body_grad}"
          + (f", max {max_steps} steps" if max_steps is not None else ""),
          flush=True)
    trainer.train(max_steps=max_steps)
    s = trainer.timer.summary()
    if s:
        print(f"{trainer.steps_done} steps; over steps 2-{trainer.steps_done}"
              f": p50 {s['p50_ms']:.1f} ms, p90 {s['p90_ms']:.1f} ms, mean "
              f"{s['mean_ms']:.1f} ms per step", flush=True)
    return trainer


def test(config: Config, device: torch.device, write_dicom: bool = True):
    """Run the config's trainer's ``test()``; returns the trainer, the
    aggregate metrics and the seconds ``test()`` took."""
    trainer = _trainer(config, device)
    route = ("serving route (fused_body)" if config.fused_body else
             f"training route (fused_body_grad {config.fused_body_grad})")
    print(f"testing {config.name} ({trainer.title}) at {config.size}^2 on "
          f"{device}, {route}, eval_batch {config.eval_batch}", flush=True)
    t0 = time.perf_counter()
    agg = trainer.test(write_dicom=write_dicom)
    secs = time.perf_counter() - t0
    n = len(trainer.test_dataset)
    print(f"test: {n} slices in {secs:.2f} s ({n / secs:.2f} slices/s)"
          + (f"; SE2 series under {config.image_save}" if write_dicom
             else ""), flush=True)
    return trainer, agg, secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ctagan_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", choices=["serve", "train", "test"],
                    default="serve")
    ap.add_argument("--generator-ckpt", default="",
                    help="reference-format .pth, or for test also a port "
                         ".pt checkpoint (default: config generator_ckpt)")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: cuda; without a "
                         "card, only an explicit cpu runs)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="train: stop after this many steps")
    ap.add_argument("--no-write", action="store_true",
                    help="test: skip the SE2 DICOM writeback")
    opts = ap.parse_args(argv)
    config = load_config(opts.config)
    device = _device(opts.device)
    if opts.mode == "train":
        train(config, device, opts.max_steps)
        return 0
    if opts.mode == "test":
        config.generator_ckpt = opts.generator_ckpt or config.generator_ckpt
        test(config, device, write_dicom=not opts.no_write)
        return 0
    ckpt = opts.generator_ckpt or config.generator_ckpt
    g = build_generator(config, device, ckpt)
    from ctagan_tpu_torch.serving.server import serve

    port = config.serve_port
    print(
        f"serving CT->CTA synthesis on :{port} (POST /synthesize) on {device}"
        + (f", weights {ckpt}" if ckpt
           else f", seeded weights (seed {config.seed}): no checkpoint given"),
        flush=True,
    )
    serve(g, port=port, size=config.size, max_batch=config.max_batch,
          quantize=config.serve_quantize,
          channels=config.input_nc * config.context_slices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
