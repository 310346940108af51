"""Training logger of the port (``ctagan_tpu/utils/logging.py``, copied):
running-mean losses + ETA to stdout, CSV persistence.

The reference's visdom Logger (trainer/utils.py:50-117) as a
dependency-free equivalent: the same per-batch running-mean loss line with
an ETA estimate, plus per-epoch rows of ``<log_dir>/<name>_losses.csv`` (an
``epoch`` header, then the loss keys sorted; epoch numbers absolute after a
resume), byte-equal to the JAX package's for the same losses, and optional
image dumps as .npy. At each epoch boundary it regenerates
``dashboard.html`` (``utils/dashboard.py``).
"""
from __future__ import annotations

import csv
import os
import sys
import time
from typing import Dict, Optional

import numpy as np


class TrainLogger:
    def __init__(
        self,
        name: str,
        n_epochs: int,
        batches_per_epoch: int,
        log_dir: Optional[str] = None,
        log_every: int = 1,
        quiet: bool = False,
        start_epoch: int = 0,
    ):
        self.name = name
        self.n_epochs = n_epochs
        self.batches_epoch = max(1, batches_per_epoch)
        self.log_every = max(1, log_every)
        self.quiet = quiet
        # resume continuity: epoch numbers (stdout line, CSV rows, .npy
        # panel names) are absolute, so a resumed run appends where the
        # previous process left off instead of restarting at 1
        self.start_epoch = int(start_epoch)
        self.epoch = self.start_epoch + 1
        self.batch = 1
        self.prev_time = time.time()
        self.mean_period = 0.0
        self.losses: Dict[str, float] = {}
        self.log_dir = log_dir
        self._csv = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_path = os.path.join(log_dir, f"{name}_losses.csv")

    def set_epoch_size(self, batches_per_epoch: int):
        """The HD trainers rebuild the loader (and logger) each epoch for
        re-randomized oversampling (HdTrainer.py:175-182) — here just the
        epoch size updates."""
        self.batches_epoch = max(1, batches_per_epoch)

    def log(self, losses: Dict[str, float], images: Optional[Dict] = None):
        now = time.time()
        self.mean_period += now - self.prev_time
        self.prev_time = now

        for k, v in losses.items():
            self.losses[k] = self.losses.get(k, 0.0) + float(v)

        if not self.quiet and (
            self.batch % self.log_every == 0 or self.batch == self.batches_epoch
        ):
            parts = [
                f"{k}: {v / self.batch:.4f}" for k, v in self.losses.items()
            ]
            # ETA extrapolates from THIS process's observed rate only
            batches_done = (
                self.batches_epoch * (self.epoch - 1 - self.start_epoch)
                + self.batch
            )
            batches_left = (
                self.batches_epoch * (self.n_epochs - self.epoch)
                + self.batches_epoch
                - self.batch
            )
            eta = batches_left * self.mean_period / max(batches_done, 1)
            sys.stdout.write(
                f"\rEpoch {self.epoch:03d}/{self.n_epochs:03d} "
                f"[{self.batch:04d}/{self.batches_epoch:04d}] -- "
                + " | ".join(parts)
                + f" -- ETA: {eta:.0f}s"
            )
            sys.stdout.flush()

        if images and self.log_dir and self.batch == 1:
            for iname, arr in images.items():
                np.save(
                    os.path.join(
                        self.log_dir, f"{self.name}_e{self.epoch}_{iname}.npy"
                    ),
                    np.asarray(arr),
                )

        if self.batch % self.batches_epoch == 0:
            if self.log_dir:
                write_header = not os.path.exists(self._csv_path)
                with open(self._csv_path, "a", newline="") as f:
                    w = csv.writer(f)
                    if write_header:
                        w.writerow(["epoch"] + sorted(self.losses))
                    w.writerow(
                        [self.epoch]
                        + [
                            self.losses[k] / self.batch
                            for k in sorted(self.losses)
                        ]
                    )
                # live view over the CSVs (visdom replacement) — the page
                # self-refreshes, so regenerating here (once per epoch, off
                # the hot loop) is all the "server" there is
                from ctagan_tpu_torch.utils.dashboard import write_dashboard

                write_dashboard(self.log_dir, self.name)
            self.losses = {}
            self.epoch += 1
            self.batch = 1
            if not self.quiet:
                sys.stdout.write("\n")
        else:
            self.batch += 1
