"""Command line of the port::

    python -m ctagan_tpu_torch --config configs/HdGan.yaml --mode serve \
        [--generator-ckpt G.pth] [--device cuda|cpu]
    python -m ctagan_tpu_torch --config configs/HdGan.yaml --mode train \
        [--max-steps N] [--device cuda|cpu]

``serve`` serves the generator over HTTP (``serving/server.py``), like the
``--mode serve`` branch of the JAX package's ``train.py``. The checkpoint is
a reference-format ``.pth`` state dict (``model_head.1.weight`` ...), such
as the one ``ctagan_tpu.models.torch_export.save_state_dict`` writes from a
JAX checkpoint. Without one, the generator serves weights drawn from the
config's ``seed``.

``train`` runs HD stage 1 (``train/trainers.py::HdTrainerStage1``) from
seeded weights on the config's ``train_list``, printing the losses every
``log_every`` steps and a step-time summary at the end.

Both run on the CUDA card unless ``--device cpu`` is given; with no card
and no ``--device`` they stop with an error.
"""
from __future__ import annotations

import argparse
import sys

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


def train(config: Config, device: torch.device,
          max_steps: int | None = None):
    """Run HD stage 1 on ``config``; returns the trainer."""
    from ctagan_tpu_torch.train.trainers import HdTrainerStage1

    trainer = HdTrainerStage1(config, device)
    print(f"training {config.name} (HD stage 1) at {config.size}^2 on "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ctagan_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", choices=["serve", "train"], default="serve")
    ap.add_argument("--generator-ckpt", default="",
                    help="reference-format .pth (default: config "
                         "generator_ckpt, else seeded weights)")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: cuda; without a "
                         "card, only an explicit cpu runs)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="train: stop after this many steps")
    opts = ap.parse_args(argv)
    config = load_config(opts.config)
    device = _device(opts.device)
    if opts.mode == "train":
        train(config, device, opts.max_steps)
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
