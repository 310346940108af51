"""Command line of the port: ``python -m ctagan_tpu_torch --config
configs/HdGan.yaml --mode serve [--generator-ckpt G.pth] [--device cuda]``.

Serves the generator over HTTP (``serving/server.py``), like the ``--mode
serve`` branch of the JAX package's ``train.py``. The checkpoint is a
reference-format ``.pth`` state dict (``model_head.1.weight`` ...), such as
the one ``ctagan_tpu.models.torch_export.save_state_dict`` writes from a
JAX checkpoint. Without one, the generator serves weights drawn from the
config's ``seed``.
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
    if name is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ctagan_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mode", choices=["serve"], default="serve")
    ap.add_argument("--generator-ckpt", default="",
                    help="reference-format .pth (default: config "
                         "generator_ckpt, else seeded weights)")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: cuda if present)")
    opts = ap.parse_args(argv)
    config = load_config(opts.config)
    device = _device(opts.device)
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
