"""The HD stage-1 trainer of the port (``ctagan_tpu/train/trainers.py::
HdTrainerStage1`` on a minimal ``TrainerBase``).

The epoch loop redraws the oversampled ``DualWindowDataset`` every epoch,
feeds raw uint16 pixels and windows them on the device
(``device_windowing``), and runs :func:`~ctagan_tpu_torch.train.steps.
reg_train_step`. The learning-rate schedule keeps the reference's
accelerating decay (the decrement is recomputed from the already-decayed lr)
and the HD family's frozen D lr. Not ported yet (ROADMAP M6): validation,
checkpoints, resume, the watchdog, live panels and the collapse guard.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ctagan_tpu_torch.data.datasets import DualWindowDataset
from ctagan_tpu_torch.data.loader import PrefetchLoader
from ctagan_tpu_torch.models import Discriminator, Generator, RegNet
from ctagan_tpu_torch.ops.windowing import dual_window_from_stored
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.utils.config import Config


def _dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def _fused_body_grad(cfg: Config):
    """config fused_body_grad -> the Generator's True / False / 'auto'."""
    v = cfg.fused_body_grad
    if isinstance(v, bool) or v == "auto":
        return v
    return v == "on"


class StepTimer:
    """Wall time between consecutive steps; on a CUDA device each tick
    first waits for the card, so a step's time is its device time plus its
    host time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def summary(self, skip: int = 0) -> Dict[str, float]:
        arr = np.asarray(self.times[skip:])
        if not arr.size:
            return {}
        return {"steps": int(arr.size),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
                "mean_ms": float(arr.mean() * 1e3)}


class TrainerBase:
    family = "base"

    def __init__(self, config: Config, device: torch.device,
                 quiet: bool = False):
        if config.context_slices > 1:
            raise NotImplementedError(
                "context_slices > 1 belongs to the P2p family (ROADMAP M8)")
        self.config = config
        self.device = torch.device(device)
        self.quiet = quiet
        self.lr = float(config.lr)
        self.lr_d = float(config.lrd)
        self.start_epoch = int(config.epoch)
        self.steps_done = 0
        # every step's losses (read after the step timer's synchronize)
        self.loss_history: List[Dict[str, float]] = []
        self._data_rng = np.random.default_rng(config.seed)
        self.g_model = Generator(
            config.input_nc, config.output_nc, dtype=_dtype(config),
            pad_mode=config.pad_mode, fused_body=False,
            fused_body_grad=_fused_body_grad(config),
        ).reset_parameters(config.seed).to(self.device)
        self._build_models()
        self.state = self._init_state()
        self.timer = StepTimer(self.device)

    def _build_models(self):
        raise NotImplementedError

    def _init_state(self):
        raise NotImplementedError

    def _step(self, batch, lr, lr_d):
        raise NotImplementedError

    # -- schedule -----------------------------------------------------------
    def update_learning_rate(self) -> None:
        """'reference': lr -= lr / decay_epoch from the already-decayed lr
        (geometric, never 0); 'linear': a straight ramp to 0. The HD family's
        D lr stays frozen either way."""
        if self.config.decay_mode == "linear":
            new_lr = max(0.0, self.lr - self.config.lr / self.config.decay_epoch)
        else:
            new_lr = self.lr - self.lr / self.config.decay_epoch
        if not self.quiet:
            print(f"update learning rate: {self.lr:f} -> {new_lr:f}")
        self.lr = new_lr
        if self.family not in ("hd1", "hd2"):
            self.lr_d = new_lr

    # -- data ---------------------------------------------------------------
    def _train_loader(self) -> PrefetchLoader:
        cfg = self.config
        ds = DualWindowDataset(cfg.train_list, oversample=True,
                               rng=self._data_rng, size=cfg.size,
                               raw_feed=cfg.device_windowing)
        loader = PrefetchLoader(ds, batch_size=cfg.batchSize, shuffle=True,
                                drop_last=True, num_threads=cfg.n_cpu,
                                rng=self._data_rng)
        if len(loader) == 0:
            raise ValueError(
                f"train loader is EMPTY: {len(ds)} samples for batchSize "
                f"{cfg.batchSize} (drop_last); grow the training list")
        return loader

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            if k.endswith("_path"):
                continue
            if v.dtype == np.uint16:
                # two bytes a pixel over the link: int16 bits, unsigned again
                # on the device
                t = torch.from_numpy(v.view(np.int16)).to(self.device)
                v = t.to(torch.int32) & 0xFFFF
            else:
                v = torch.from_numpy(v).to(self.device)
            out[k] = v
        return self._window_device_batch(out)

    def _window_device_batch(self, db):
        """device_windowing: the host sent raw stored pixels; derive the
        dual-window views on the device, bit-exact with the host codec."""
        if not (self.config.device_windowing and "A" in db
                and not db["A"].is_floating_point()):
            return db
        a1, a2 = dual_window_from_stored(db["A"])
        b1, b2 = dual_window_from_stored(db["B"])
        return {"A1": a1, "A2": a2, "B1": b1, "B2": b2}

    # -- loop ---------------------------------------------------------------
    def train(self, max_steps: Optional[int] = None) -> "TrainerBase":
        cfg = self.config
        for epoch in range(self.start_epoch + 1, cfg.total_epochs + 1):
            if max_steps is not None and self.steps_done >= max_steps:
                break
            if epoch > cfg.n_epochs:
                self.update_learning_rate()
            loader = self._train_loader()  # per-epoch oversampling redraw
            n_batches = len(loader)
            for i, batch in enumerate(loader):
                if max_steps is not None and self.steps_done >= max_steps:
                    break
                losses = self._step(self._device_batch(batch), self.lr,
                                    self.lr_d)
                self.steps_done += 1
                self.timer.tick()
                losses = {k: float(v) for k, v in losses.items()}
                self.loss_history.append(losses)
                if not self.quiet and ((i + 1) % cfg.log_every == 0
                                       or i + 1 == n_batches):
                    shown = " | ".join(f"{k}: {v:.4f}"
                                       for k, v in losses.items())
                    print(f"Epoch {epoch:03d}/{cfg.total_epochs:03d} "
                          f"[{i + 1:04d}/{n_batches:04d}] -- {shown}",
                          flush=True)
        return self


class HdTrainerStage1(TrainerBase):
    """CTA-GAN stage 1: RegGAN losses on dual-window data with a separate,
    frozen D lr."""

    family = "hd1"

    def _build_models(self):
        cfg = self.config
        self.r_model = RegNet(cfg.input_nc, cfg.input_nc, dtype=_dtype(cfg)
                              ).reset_parameters(cfg.seed + 1).to(self.device)
        self.d_model = Discriminator(cfg.input_nc, dtype=_dtype(cfg)
                                     ).reset_parameters(cfg.seed + 2
                                                        ).to(self.device)

    def _init_state(self):
        return steps.init_reg_state(self.g_model, self.r_model, self.d_model,
                                    self.config.seed)

    def _step(self, batch, lr, lr_d):
        cfg = {k: getattr(self.config, k) for k in (
            "Adv_lamda1", "Corr_lamda1", "Smooth_lamda", "noise_level",
            "aligned_aug", "d_refwd", "grad_accum", "ema_decay", "r1_gamma",
            "warp_max_disp", "reg_downsample")}
        return steps.reg_train_step(self.state, cfg, batch, lr, lr_d=lr_d,
                                    dual_window_mode=True)
