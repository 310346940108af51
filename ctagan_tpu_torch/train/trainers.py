"""The trainers of the port (``ctagan_tpu/train/trainers.py``): pix2pix
(``P2pTrainer``), CycleGAN (``CycTrainer``), RegGAN (``RegTrainer``), HD
stage 1 and 2 (``HdTrainerStage1`` and ``HdTrainerStage2``, on RegGAN's
step) and the 3-D family (``P3dTrainer``), on ``TrainerBase``, and
:func:`build_trainer`, which picks one by the config's ``name`` as the JAX
package does.

The P2p, Cyc and Reg families read ``PairedSliceDataset`` (the full-range
pair, with ``unaligned`` a fresh B per visit, with ``context_slices`` the
2.5-D stack for P2p); the HD family redraws the oversampled
``DualWindowDataset`` every epoch. Both feed raw uint16 pixels and map them
on the device (``device_windowing``). P3d reads ``VolumePatchDataset``'s
full-range depth windows (``data/volumes.py``). The learning-rate schedule
keeps the reference's accelerating decay (the decrement is recomputed from the
already-decayed lr) and the HD family's frozen D lr. After every epoch the
loop validates (masked PSNR and SSIM, every ``val_every`` epochs) and saves
a checkpoint, stamped with the metrics when it validated; it also saves
every ``checkpoint_every_iters`` steps and, on an exception, before
re-raising. ``resume`` starts from the newest checkpoint, and the collapse
guard restores the best stamped one when validation falls
``collapse_drop_db`` below it. As in JAX, the loop writes
``<save_root>/<name>_losses.csv`` (``utils/logging.py``),
``<name>_val.csv``, ``<name>_latest_panel.png`` (with ``live_panels``, at
each log point) and ``dashboard.html`` (``utils/dashboard.py``), and with
``stall_timeout`` > 0 arms the stall watchdog (``utils/watchdog.py``).
``test()`` scores the test list with the eight masked metrics and writes the synthetic SE2 series
(``train/evaluation.py``), with LPIPSw and LPIPS when ``lpips_weights``
names a weights file (``ops/lpips.py``). ``make_figures`` writes the
qualitative PNG panels (``utils/figures.py``). With ``ema_decay`` > 0,
validation, test, figures, the collapse guard's comparison and
``load_generator`` read and write G's EMA.

Every reader of a checkpoint (``resume``, ``load_generator``, the stage-2
bootstrap, test(), and through :meth:`TrainerBase.load_inference_generator`
series inference, export and serving) takes the port's ``.pt`` and the JAX
package's flax msgpack ``.ckpt`` alike (``utils/checkpoint.py``,
``models/convert.py::load_jax_state``). A state resumed from a JAX file
draws its augmentation from the port's own seeded generator: JAX's PRNG key
has no torch counterpart.

Validation and test run the generator's serving route (K3, K1, K2) with
``fused_body``, else the training model's route (on CUDA with
``fused_body_grad: auto``, the body through K1), on the same parameters.
JAX's orbax checkpoints are not read yet (they raise).

The data-parallel plan (``parallel/mesh.py``, JAX's default
``data_parallel: true``, or ``mesh: {dp: N}``) trains over the N ranks of a
process group (``parallel/dist.py``): each rank feeds its ``batchSize``
rows of every global batch (``PrefetchLoader.shard``), the steps
mean-reduce the gradients, and the weights stay alike on every rank. Rank
0 alone prints and writes the checkpoints, the CSVs, the panels and the
dashboard; the other ranks wait for each checkpoint. The decisions that
steer the loop (the resume file, the collapse guard) are rank 0's,
broadcast, so every rank reaches the same collectives. Validation and
test() split each eval batch over the ranks when ``eval_batch`` divides
over them (else rank 0 evaluates alone), gather every slice's metrics to
every rank, and write each rank's own SE2 slices into the tree one process
writes.

The fsdp plan (``mesh: {fsdp: N}`` or ``{dp: M, fsdp: N}``) trains over M
× N ranks as dp does, with the state sharded over each block of N after
init (``parallel/fsdp.py``): the steps gather each net they read. The
checkpoint state, a loaded G (``load_generator``, the collapse guard) and
the stage-2 bootstrap go through the one-process layout
(``fsdp.unsharded_state``, every rank gathering), so a ``.pt`` is the same
under any plan and any plan resumes from it, or from a JAX ``.ckpt``.
validate() and test() gather the eval G for their pass, the panels for
theirs. An emergency save is skipped: a rank that another rank's failure
stopped may never reach the gather. pp raises naming its ROADMAP item
(M12e).

The tp plan (``mesh: {tp: N}`` or ``{dp: M, tp: N}``) trains over M × N
ranks with the residual pairs of G and R split over each block of N after
init (``parallel/tensor.py``); the N ranks of a block read their dp
column's rows. Checkpoints, loads and the bootstrap go through the
one-process layout (``tensor.unsharded_state``), validate() and test()
gather the eval G whole on every rank and split their batches over all M
× N ranks, as under fsdp; the emergency save is skipped alike. The split
step runs no kernel (``Generator.forward``'s gate); the gathered eval G
takes its configured route.

The sp plan (``mesh: {sp: N}`` or ``{dp: M, sp: N}``: P2p, CycleGAN,
RegGAN and HD stage 1 and 2) trains over M × N ranks with the rows of
every activation split over each block of N (``parallel/spatial.py``);
the N ranks of a block read their dp column's rows, and the state stays
replicated, so checkpoints, loads, validate() and test() run as under dp
(the whole model, its configured route, each eval batch split over all M
× N ranks). CycleGAN's pools hold one process's whole fakes, so its
``.pt`` is one process's too. The sp step runs no kernel
(``Generator.forward``'s gate).

The depth plan (``mesh: {depth: N}`` or ``{dp: M, depth: N}``) trains P3d
over M × N ranks with the D axis of every volume split over each block of
N (``parallel/volume.py``); P3d under ``{sp: N}`` or ``{dp: M, sp: N}``
takes the same depth step, as JAX's sp placement ``P(data, spatial)``
splits axis 1 of the (N, D, H, W, 1) batch, a volume's depth (a D that
does not split raises JAX's "needs H divisible"). The 2-D families under
the depth plan take the sp step on their rows: JAX's depth placement
splits axis 1 of their NHWC batch, its H, and jits the same plain step.
The state stays replicated, so checkpoints, loads, validate() and test()
run as under sp.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ctagan_tpu_torch.data.datasets import (
    DualWindowDataset,
    PairedSliceDataset,
)
from ctagan_tpu_torch.data.dicom import generate_uid, read_dicom
from ctagan_tpu_torch.data.loader import PrefetchLoader, _collate
from ctagan_tpu_torch.data.volumes import VolumePatchDataset
from ctagan_tpu_torch.models import (
    Discriminator,
    Generator,
    MultiScaleDiscriminator,
    RegNet,
)
from ctagan_tpu_torch.models.volumetric import Discriminator3D, Generator3D
from ctagan_tpu_torch.ops.metrics import masked_psnr, ssim
from ctagan_tpu_torch.ops.windowing import (
    dual_window_from_stored,
    fullrange_from_stored,
)
from ctagan_tpu_torch.train import steps
from ctagan_tpu_torch.models.convert import (
    generator_state_dict,
    jax_generator_params,
    jax_generator_state_dict,
    load_jax_state,
    regnet_state_dict,
)
from ctagan_tpu_torch.ops.lpips import make_lpips_fn
from ctagan_tpu_torch.parallel import dist, fsdp, spatial, tensor, volume
from ctagan_tpu_torch.parallel.mesh import (
    MeshPlan,
    pad_batch_to,
    plan_from_spec,
    shard_batch,
)
from ctagan_tpu_torch.train.evaluation import (
    METRIC_KEYS,
    DicomWriteback,
    _metric_suite,
    aggregate,
    evaluate_pair,
)
from ctagan_tpu_torch.utils.checkpoint import (
    checkpoint_name,
    find_checkpoints,
    find_latest_checkpoint,
    find_latest_of_family,
    is_jax_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from ctagan_tpu_torch.utils.config import Config
from ctagan_tpu_torch.utils.dashboard import append_val_csv, write_dashboard
from ctagan_tpu_torch.utils.figures import (
    save_qualitative_panel,
    write_png_gray,
)
from ctagan_tpu_torch.utils.logging import TrainLogger
from ctagan_tpu_torch.utils.watchdog import Watchdog


def _dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def _fused_body_grad(cfg: Config):
    """config fused_body_grad -> the Generator's True / False / 'auto'."""
    v = cfg.fused_body_grad
    if isinstance(v, bool) or v == "auto":
        return v
    return v == "on"


@contextlib.contextmanager
def _one_process(state):
    """The state in the one-process layout for the block, under fsdp or tp
    (every rank gathering); as it is under dp."""
    with fsdp.unsharded_state(state), tensor.unsharded_state(state):
        yield


@contextlib.contextmanager
def _whole(model):
    """``model``'s weights gathered whole for the block, under fsdp or
    tp."""
    with fsdp.gathered(model), tensor.gathered(model):
        yield


def _sharded(state) -> bool:
    return fsdp.is_sharded(state) or tensor.is_sharded(state)


def panel_uint8(t: torch.Tensor) -> torch.Tensor:
    """A [-1, 1] image as the live panel's uint8, by JAX's formula:
    clip((t + 1) · 127.5, 0, 255) in f32, truncated."""
    return torch.clamp((t.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)


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
                "steps_per_sec": float(1.0 / np.median(arr)),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
                "mean_ms": float(arr.mean() * 1e3)}


class TrainerBase:
    family = "base"
    dual_window = False

    def __init__(self, config: Config, device: torch.device,
                 quiet: bool = False):
        if config.context_slices > 1 and self.family != "p2p":
            raise ValueError(
                "context_slices > 1 is supported by the P2p family only")
        self.plan = self._plan(config)
        self.config = config
        self.device = torch.device(device)
        # rank 0 speaks for the world
        self.quiet = quiet or not dist.is_host0()
        if not self.quiet and (config.mesh or self.plan.batch_scale > 1):
            print(self.plan.describe(), flush=True)
        self.lr = float(config.lr)
        self.lr_d = float(config.lrd)
        self.start_epoch = int(config.epoch)
        self._current_epoch = self.start_epoch
        # best validation of this run: (psnr, stamped checkpoint name)
        self._best_val: Optional[Tuple[float, str]] = None
        self.steps_done = 0
        # every step's losses (read after the step timer's synchronize)
        self.loss_history: List[Dict[str, float]] = []
        self._data_rng = np.random.default_rng(config.seed)
        # G from ``seed``; each family seeds its other nets from seed + 1 on
        self.g_model = self._generator(config.seed)
        self._build_models()
        self.state = self._init_state()
        if self.plan.kind == "fsdp":
            fsdp.shard_state_fsdp(self.state, fsdp.make_fsdp_mesh(
                self.plan.dp, self.plan.fsdp))
        elif self.plan.kind == "tp":
            tensor.shard_state_tp(self.state, tensor.make_tp_mesh(
                self.plan.dp, self.plan.tp))
        elif self.plan.kind in ("sp", "depth"):
            plan = self.plan
            n = plan.sp * plan.depth  # the one of them above 1
            if self.family == "p3d":  # the depth step, whichever axis
                mesh = (volume.make_dp_depth_mesh if plan.kind == "depth"
                        else spatial.make_sp_mesh)(plan.dp, n)
                volume.shard_p3d_state_depth(self.state, mesh)
            else:  # the sp step on the rows of the 2-D families
                spatial.shard_state_sp(self.state, spatial.make_sp_mesh(
                    plan.dp, n))
        self.timer = StepTimer(self.device)
        if config.resume:
            self._try_resume()

    @staticmethod
    def _plan(config: Config) -> MeshPlan:
        """JAX's choice: an explicit ``mesh`` wins; else ``data_parallel``
        trains over every rank of the process group (one without a
        group)."""
        world = dist.world()
        if config.mesh:
            return plan_from_spec(config.mesh, world)
        return plan_from_spec({"dp": world if config.data_parallel else 1},
                              world)

    def _generator(self, seed: int) -> Generator:
        cfg = self.config
        return Generator(
            cfg.input_nc * cfg.context_slices, cfg.output_nc,
            dtype=_dtype(cfg), pad_mode=cfg.pad_mode, fused_body=False,
            fused_body_grad=_fused_body_grad(cfg), remat=cfg.remat,
        ).reset_parameters(seed).to(self.device)

    def _build_models(self):
        raise NotImplementedError

    def _init_state(self):
        raise NotImplementedError

    def _step(self, batch, lr, lr_d):
        raise NotImplementedError

    @property
    def _ema_on(self) -> bool:
        return self.config.ema_decay > 0

    def _eval_model(self) -> Generator:
        """The generator that val, test and the SE2 writeback run: G's EMA
        with ``ema_decay`` > 0, else the live G."""
        ema = getattr(self.state, "g_ema", None)
        return ema if self._ema_on and ema is not None else self.g_model

    def _set_g_params(self, sd) -> None:
        """Loaded G weights; they overwrite the EMA shadow too."""
        with _one_process(self.state):
            self.g_model.load_state_dict(sd, strict=True)
            ema = getattr(self.state, "g_ema", None)
            if ema is not None:
                ema.load_state_dict(sd, strict=True)

    def _step_cfg(self, *keys) -> Dict[str, object]:
        """The step's config dict; ``ema_decay`` as JAX passes it (0 →
        0.999, read only when an EMA exists)."""
        cfg = {k: getattr(self.config, k) for k in (
            "noise_level", "aligned_aug", "grad_accum", *keys)}
        cfg["ema_decay"] = self.config.ema_decay or 0.999
        return cfg

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
    def _train_dataset(self):
        """The HD family's oversampled list, redrawn every epoch; the
        others' one ``PairedSliceDataset`` (its unaligned draws count every
        visit across epochs)."""
        cfg = self.config
        if self.dual_window:
            return DualWindowDataset(cfg.train_list, oversample=True,
                                     rng=self._data_rng, size=cfg.size,
                                     raw_feed=cfg.device_windowing)
        if self._paired_train is None:
            self._paired_train = PairedSliceDataset(
                cfg.train_list, size=cfg.size, unaligned=cfg.unaligned,
                context_slices=cfg.context_slices, seed=cfg.seed,
                raw_feed=cfg.device_windowing)
        return self._paired_train

    _paired_train: Optional[PairedSliceDataset] = None

    def _eval_dataset(self, list_file: str):
        cfg = self.config
        if self.dual_window:
            return DualWindowDataset(list_file, size=cfg.size,
                                     raw_feed=cfg.device_windowing)
        return PairedSliceDataset(list_file, size=cfg.size,
                                  context_slices=cfg.context_slices,
                                  raw_feed=cfg.device_windowing)

    # the train loader's threads (None: ``n_cpu``)
    _loader_threads: Optional[int] = None

    def _train_loader(self) -> PrefetchLoader:
        """``batchSize`` rows a rank of global batches of ``batchSize`` ×
        the ranks."""
        cfg = self.config
        ds = self._train_dataset()
        n = self.plan.batch_scale
        loader = PrefetchLoader(ds, batch_size=cfg.batchSize, shuffle=True,
                                drop_last=True,
                                num_threads=self._loader_threads or cfg.n_cpu,
                                rng=self._data_rng,
                                shard=(self.plan.batch_rank(dist.rank()), n)
                                if n > 1 else None)
        if len(loader) == 0:
            raise ValueError(
                f"train loader is EMPTY: {len(ds)} samples for a global "
                f"batch of batchSize {cfg.batchSize} x {n} rank(s) = "
                f"{cfg.batchSize * n} (drop_last); grow the training list")
        return loader

    def _to_device(self, v: np.ndarray) -> torch.Tensor:
        if v.dtype == np.uint16:
            # two bytes a pixel over the link: int16 bits, unsigned again on
            # the device
            t = torch.from_numpy(v.view(np.int16)).to(self.device)
            return t.to(torch.int32) & 0xFFFF
        return torch.from_numpy(v).to(self.device)

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {k: self._to_device(v) for k, v in batch.items()
               if not k.endswith("_path")}
        return self._window_device_batch(out)

    def _window_device_batch(self, db):
        """device_windowing: the host sent raw stored pixels; derive the
        dual-window views (HD) or the full-range pair on the device,
        bit-exact with the host codec."""
        if not (self.config.device_windowing and "A" in db
                and not db["A"].is_floating_point()):
            return db
        if not self.dual_window:
            return {"A": fullrange_from_stored(db["A"]),
                    "B": fullrange_from_stored(db["B"])}
        a1, a2 = dual_window_from_stored(db["A"])
        b1, b2 = dual_window_from_stored(db["B"])
        return {"A1": a1, "A2": a2, "B1": b1, "B2": b2}

    # -- checkpoints --------------------------------------------------------
    @property
    def ckpt_prefix(self) -> str:
        return f"{self.config.name}_{self.family}"

    # the state's nets (checkpoint key, state attribute; G first), its
    # optimizers and EMAs (by attribute, which is their key)
    _NETS: Tuple[Tuple[str, str], ...] = ()
    _OPTS: Tuple[str, ...] = ()
    _EMAS: Tuple[str, ...] = ("g_ema",)

    def _checkpoint_state(self) -> Dict[str, object]:
        """The state in the one-process layout (under fsdp every rank
        gathers it)."""
        st = self.state
        with _one_process(st):
            out: Dict[str, object] = {key: getattr(st, net).state_dict()
                                      for key, net in self._NETS}
            for name in self._OPTS + self._EMAS:
                if getattr(st, name) is not None:
                    out[name] = getattr(st, name).state_dict()
        out["rng"] = st.gen.get_state()
        return out

    def _load_state(self, state) -> None:
        st = self.state
        with _one_process(st):
            for key, net in self._NETS:
                getattr(st, net).load_state_dict(state[key])
            for name in self._OPTS + self._EMAS:
                if getattr(st, name) is not None:
                    getattr(st, name).load_state_dict(state[name])
        st.gen.set_state(state["rng"])

    # set by train()'s exception handler: the emergency save waits for no
    # rank (another may be gone)
    _emergency = False

    def _save(self, epoch: int, psnr: Optional[float] = None,
              ssim_v: Optional[float] = None) -> Optional[str]:
        """Rank 0 writes the checkpoint (the state in the one-process
        layout, plan-portable as JAX's ``_canonical_state`` makes it; under
        fsdp every rank gathers it) and every rank waits for it; returns
        its path on rank 0. Under fsdp an emergency save is skipped."""
        sharded = _sharded(self.state)
        if sharded and self._emergency:
            if not self.quiet:
                print("\nemergency checkpoint skipped: the state is sharded "
                      "over the ranks, and a rank may be gone", flush=True)
            return None
        path = None
        state = (self._checkpoint_state() if dist.is_host0() or sharded
                 else None)
        if dist.is_host0():
            payload = {"state": state, "epoch": epoch,
                       "lr": self.lr, "lr_d": self.lr_d}
            path = save_checkpoint(self.config.save_root, self.ckpt_prefix,
                                   epoch, payload, psnr, ssim_v)
        if not self._emergency:
            dist.barrier()
        return path

    def _newest_readable(self):
        """(path, payload) of the newest readable checkpoint, the port's or
        JAX's, or None; an unreadable one (torn by a crash mid-write, or a
        dying disk) is renamed ``.corrupt`` and the next newest is tried. An
        orbax directory raises (not read yet)."""
        for path, _ in find_checkpoints(self.config.save_root,
                                        self.ckpt_prefix):
            try:
                return path, load_checkpoint(path)
            except NotImplementedError:
                raise
            except Exception as e:  # unreadable: keep it aside, go on
                quarantined = path + ".corrupt"
                try:
                    os.replace(path, quarantined)
                except OSError:
                    quarantined = path
                print(f"[resume] checkpoint {path} unreadable ({e}) — "
                      f"quarantined as {quarantined}, trying the next newest",
                      file=sys.stderr, flush=True)
        return None

    def _try_resume(self) -> None:
        """Restore the newest readable checkpoint (:meth:`_newest_readable`):
        rank 0 picks it and every rank reads that file."""
        found = self._newest_readable() if dist.is_host0() else None
        path = dist.broadcast_object(found[0] if found else None)
        if path is None:
            return
        payload = found[1] if found else load_checkpoint(path)
        if is_jax_checkpoint(path):
            with _one_process(self.state):
                load_jax_state(self.state, payload["state"])
        else:
            self._load_state(payload["state"])
        self.start_epoch = self._current_epoch = int(payload["epoch"])
        self.lr = float(payload["lr"])
        self.lr_d = float(payload["lr_d"])
        if not self.quiet:
            print(f"resumed from {path} (epoch {self.start_epoch})")

    def load_generator(self, path: str) -> None:
        """G's weights (and the EMA's) from a reference-format ``.pth`` state
        dict, a port checkpoint (told apart by content) or a JAX ``.ckpt``
        (its state's G: ``g_params``, CycleGAN's ``g_a2b_params``)."""
        self._set_g_params(generator_weights(path))

    def load_inference_generator(self) -> Optional[str]:
        """G for series inference, export and serving, as the JAX entry
        point finds it: ``generator_ckpt``, else the newest checkpoint of
        the trainer's prefix in ``save_root`` (``.pt`` or ``.ckpt``), else
        the weights G has. Returns the path loaded, or None."""
        cfg = self.config
        path = cfg.generator_ckpt
        if not path:
            found = find_latest_checkpoint(cfg.save_root, self.ckpt_prefix)
            path = found[0] if found else ""
        if path:
            self.load_generator(path)
        return path or None

    def _collapse_guard(self, epoch: int, psnr_v: float, ssim_v: float
                        ) -> bool:
        """GAN collapse guard (config ``collapse_guard``, on by default):
        when a validation lands ``collapse_drop_db`` below the best of this
        run, the whole train state (nets, optimizers, EMAs, replay pools)
        restores from the best stamped checkpoint and the D lr is multiplied
        by ``collapse_lrd_backoff``. Returns True when it fired. Rank 0
        decides, and every rank takes its decision and its best."""
        cfg = self.config
        best_path = (self._collapse_decision(epoch, psnr_v, ssim_v)
                     if dist.is_host0() else None)
        self._best_val, best_path = dist.broadcast_object(
            (self._best_val, best_path))
        if best_path is None:
            return False
        best_psnr, best_name = self._best_val
        self._load_state(load_checkpoint(best_path)["state"])
        self.lr_d = float(self.lr_d) * float(cfg.collapse_lrd_backoff)
        if not self.quiet:
            print(f"[collapse guard] val PSNR {psnr_v:.2f} fell "
                  f"{best_psnr - psnr_v:.2f} dB below best {best_psnr:.2f} — "
                  f"restored {best_name}, D lr backed off to {self.lr_d:g}",
                  flush=True)
        return True

    def _collapse_decision(self, epoch: int, psnr_v: float, ssim_v: float
                           ) -> Optional[str]:
        """The best-val bookkeeping; the stamped best's path when the guard
        fires, else None."""
        cfg = self.config
        name = checkpoint_name(self.ckpt_prefix, epoch, psnr_v, ssim_v)
        if self._best_val is None or psnr_v > self._best_val[0]:
            self._best_val = (psnr_v, name)
            return None
        best_psnr, best_name = self._best_val
        if not cfg.collapse_guard or best_psnr - psnr_v < cfg.collapse_drop_db:
            return None
        best_path = os.path.join(cfg.save_root, best_name)
        if not os.path.exists(best_path):
            return None  # the stamped best was pruned or moved
        return best_path

    # -- loop ---------------------------------------------------------------
    _watchdog: Optional[Watchdog] = None  # armed by train() (stall_timeout)

    def train(self, max_steps: Optional[int] = None,
              max_steps_per_epoch: Optional[int] = None) -> "TrainerBase":
        """Epochs from ``start_epoch + 1``, as JAX's ``train()``: the
        running-mean loss line and ``<save_root>/<name>_losses.csv`` rows
        (:class:`TrainLogger`), the live panel and ``dashboard.html`` at
        each log point with ``live_panels``, and with ``stall_timeout`` > 0
        the stall watchdog (exit 42; paused around the first step and
        validation, one beat a step, stopped on the way out).
        ``max_steps_per_epoch`` caps each epoch's steps (JAX's ``--max-steps``;
        a cut epoch still validates and saves). ``max_steps`` stops the run
        after that many steps in all; an epoch it cuts ends without its
        validation and checkpoint. On an exception (or an interrupt) an
        emergency checkpoint is saved and the exception re-raised."""
        cfg = self.config
        logger = TrainLogger(cfg.name, cfg.total_epochs, 1,
                             log_dir=(cfg.save_root or None)
                             if dist.is_host0() else None,
                             log_every=cfg.log_every, quiet=self.quiet,
                             start_epoch=self.start_epoch)
        self._watchdog = None
        if cfg.stall_timeout and cfg.stall_timeout > 0:
            self._watchdog = Watchdog(cfg.stall_timeout).start()
        try:
            self._train_epochs(logger, max_steps, max_steps_per_epoch)
        except (KeyboardInterrupt, Exception):
            self._emergency = True
            if self._save(self._current_epoch) and not self.quiet:
                print(f"\nemergency checkpoint saved at epoch "
                      f"{self._current_epoch}", flush=True)
            raise
        finally:
            self._emergency = False
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
        return self

    def _train_epochs(self, logger: TrainLogger, max_steps: Optional[int],
                      max_steps_per_epoch: Optional[int]) -> None:
        cfg = self.config
        wd = self._watchdog
        first_step = True
        for epoch in range(self.start_epoch + 1, cfg.total_epochs + 1):
            if max_steps is not None and self.steps_done >= max_steps:
                return
            self._current_epoch = epoch
            if epoch > cfg.n_epochs:
                self.update_learning_rate()
            loader = self._train_loader()  # per-epoch oversampling redraw
            n_batches = len(loader)
            logger.set_epoch_size(n_batches)
            pending: List[Dict[str, float]] = []
            for i, batch in enumerate(loader):
                if max_steps is not None and self.steps_done >= max_steps:
                    return
                if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                    for lo in pending:
                        logger.log(lo)
                    pending = []
                    logger.epoch += 1
                    logger.batch = 1
                    break
                db = self._device_batch(batch)
                if first_step and wd is not None:
                    wd.pause()  # the first step builds the kernels (nvcc)
                try:
                    losses = self._step(db, self.lr, self.lr_d)
                finally:
                    if first_step and wd is not None:
                        wd.resume()
                first_step = False
                self.steps_done += 1
                losses = {k: float(v) for k, v in losses.items()}
                self.loss_history.append(losses)
                pending.append(losses)
                if len(pending) >= cfg.log_every or i + 1 == n_batches:
                    for lo in pending:
                        logger.log(lo)
                    pending = []
                    if cfg.live_panels:
                        with _whole(self._eval_model()):
                            self._refresh_live_panel(db)
                if (i + 1) % cfg.checkpoint_every_iters == 0:
                    self._save(epoch)
                self.timer.tick()
                if wd is not None:
                    wd.beat()
            s = self.timer.summary()
            if not self.quiet and s:
                print(f"\n[epoch {epoch}] {s['steps_per_sec']:.2f} steps/s "
                      f"(p50 {s['p50_ms']:.1f} ms, p90 {s['p90_ms']:.1f} ms)",
                      flush=True)
            if epoch % cfg.val_every == 0:
                if wd is not None:
                    wd.pause()
                try:
                    psnr_v, ssim_v = self.validate()
                finally:
                    if wd is not None:
                        wd.resume()
                if not self.quiet:
                    print(f"PSNR: {psnr_v}\nSSIM: {ssim_v}", flush=True)
                with _whole(self._eval_model()):
                    self._log_val_dashboard(epoch, psnr_v, ssim_v)
                self._save(epoch, psnr_v, ssim_v)
                self._collapse_guard(epoch, psnr_v, ssim_v)
            else:
                self._save(epoch)

    @torch.no_grad()
    def _panel_images(self, a: torch.Tensor, b: torch.Tensor):
        """input (its centre channel) | fake | target of the first sample,
        G on the eval route; 3-D batches by their centre depth slice."""
        fake = self._eval_model()(a[:1], fused_body=self.config.fused_body)
        a, b, fake = (self._eval_slices(t[:1, ..., c:c + 1])[0]
                      for t, c in ((a, a.shape[-1] // 2), (b, 0),
                                   (fake, 0)))
        return a, fake, b

    def _refresh_live_panel(self, db: Dict[str, torch.Tensor]) -> None:
        """The live batch's first sample through the eval G (the EMA with
        ``ema_decay``), input | fake | target packed to uint8 as JAX packs
        it (:func:`panel_uint8`), into ``<name>_latest_panel.png`` and
        ``dashboard.html``. 3-D batches have no panel, as in JAX. Writing
        the panel and the dashboard is best-effort (an error prints
        "skipped" and training goes on); the forward is not. Rank 0 alone,
        from its own rows."""
        cfg = self.config
        if not cfg.save_root or not dist.is_host0():
            return
        if self.dual_window and "A2" in db:
            a, b = db["A2"], db["B2"]
        elif "A" in db and "B" in db:
            a, b = db["A"], db["B"]
        else:
            return
        if a.dim() != 4:
            return
        panel = np.hstack([panel_uint8(t).cpu().numpy()
                           for t in self._panel_images(a, b)])
        try:
            write_png_gray(os.path.join(cfg.save_root,
                                        f"{cfg.name}_latest_panel.png"),
                           panel)
            write_dashboard(cfg.save_root, cfg.name)
        except Exception as e:  # observability only: never fatal
            if not self.quiet:
                print(f"\n[live panel] skipped: {e}", file=sys.stderr)

    def _log_val_dashboard(self, epoch: int, psnr_v: float,
                           ssim_v: float) -> None:
        """After a validation: a row of ``<name>_val.csv``, the panel of the
        first val slice (input | synthesized | target, its centre depth
        slice for a 3-D window) and ``dashboard.html``; the writing
        best-effort as in :meth:`_refresh_live_panel`. Rank 0 alone."""
        cfg = self.config
        if not cfg.save_root or not dist.is_host0():
            return
        imgs = []
        if len(self.val_dataset):
            a, b = self._val_pairs(_collate([self.val_dataset[0]]))
            imgs = [t.float().cpu().numpy() for t in self._panel_images(
                self._eval_input(self._eval_put(a)),
                self._eval_input(self._eval_put(b)))]
        try:
            append_val_csv(cfg.save_root, cfg.name, epoch, float(psnr_v),
                           float(ssim_v))
            if imgs:
                save_qualitative_panel(cfg.save_root,
                                       f"{cfg.name}_latest_panel", imgs)
            write_dashboard(cfg.save_root, cfg.name)
        except Exception as e:  # observability only: never fatal
            if not self.quiet:
                print(f"\n[dashboard] skipped: {e}", file=sys.stderr)

    # -- evaluation -----------------------------------------------------------
    # the eval datasets are built at first use: a run that never validates
    # needs no val or test list
    @functools.cached_property
    def val_dataset(self):
        return self._eval_dataset(self.config.val_list)

    @functools.cached_property
    def test_dataset(self):
        return self._eval_dataset(self.config.test_list)

    @staticmethod
    def _val_pairs(batch):
        """The full-range pair: the host's views, or raw stored pixels."""
        if "A2" in batch:
            return batch["A2"], batch["B2"]
        return batch["A"], batch["B"]

    def _eval_put(self, x) -> torch.Tensor:
        return self._to_device(np.asarray(x))

    @staticmethod
    def _eval_input(x: torch.Tensor) -> torch.Tensor:
        """Raw stored pixels -> full range on the device; floats as they
        are."""
        return x if x.is_floating_point() else fullrange_from_stored(x)

    @staticmethod
    def _eval_slices(x: torch.Tensor) -> torch.Tensor:
        """The (N, H, W) slices val and test score: each 2-D sample's first
        channel (the 3-D family: the centre depth slice)."""
        return x[..., 0]

    def _eval_pair(self, a, b):
        """G's (N, H, W) f32 fake and the (N, H, W) real, by the eval route:
        the serving route with ``fused_body``, else the training model's."""
        a, b = self._eval_input(a), self._eval_input(b)
        fake = self._eval_model()(a, fused_body=self.config.fused_body)
        return (self._eval_slices(fake).float(),
                self._eval_slices(b).float())

    @torch.no_grad()
    def _val_step(self, a, b):
        fb, rb = self._eval_pair(a, b)
        return masked_psnr(fb, rb), ssim(fb, rb)

    @torch.no_grad()
    def _test_step(self, a, b, wc, ww):
        """G, the (8, N) metric matrix and the fakes as stored int16 values
        (de-normalized on the device; the cast truncates)."""
        fb, rb = self._eval_pair(a, b)
        mat = _metric_suite(fb, rb, wc, ww)
        stored = ((fb + 1.0) * 0.5 * 4095.0).to(torch.int16)
        return stored, mat

    def _eval_blocks(self, n_slices: int):
        """This rank's share of the eval batches of ``eval_batch`` slices,
        after JAX's ``_eval_put``: over N ranks, when ``eval_batch`` divides
        over them, its block of every batch (a ragged last batch padded by
        repeating its last slice, ``pad_batch_to``), else rank 0 every batch
        whole and the other ranks none; one rank every batch whole. A list
        of (the batch's first slice, its slices, the block's first row in
        the batch, its real rows, the block's slice indices)."""
        k = max(1, int(self.config.eval_batch))
        world, rank = dist.world(), dist.rank()
        if k % world:
            if rank > 0:
                return []
            world, rank = 1, 0
        blocks = []
        for start in range(0, n_slices, k):
            n = min(k, n_slices - start)
            padded, _ = pad_batch_to({"i": np.arange(start, start + n)},
                                     -(-n // world) * world)
            rows = shard_batch(padded, rank, world)["i"]
            lo = rank * len(rows)
            blocks.append((start, n, lo, max(0, min(len(rows), n - lo)),
                           rows.tolist()))
        return blocks

    def _eval_feed(self, dataset, blocks):
        """The ``blocks`` (:meth:`_eval_blocks`) with their data: this rank
        decodes its block's slices alone. Yields (the batch's first slice,
        its A paths, the block's first row, its real rows, its slice
        indices, the block)."""
        if not blocks:
            return
        rows = [i for *_, idx in blocks for i in idx]
        loader = PrefetchLoader(torch.utils.data.Subset(dataset, rows),
                                batch_size=len(blocks[0][4]),
                                num_threads=self.config.n_cpu)
        for (start, n, lo, real, idx), block in zip(blocks, loader):
            yield (start, dataset.files_a[start:start + n], lo, real, idx,
                   {key: v for key, v in block.items()
                    if not key.endswith("_path")})

    def _gathered(self, values: torch.Tensor) -> np.ndarray:
        """(K, N) per-slice values, each filled by the rank that evaluated
        the slice and zero elsewhere, summed over the ranks: every slice's
        values on every rank, to be reduced on the host in slice order as
        one process does."""
        return dist.all_reduce_sum_(values).cpu().numpy()

    def validate(self) -> Tuple[float, float]:
        """Mean masked PSNR and SSIM over the val list. Every batch's values
        stay on the device until one pull at the end; the means are summed
        on the host in slice order."""
        vals = torch.zeros(2, len(self.val_dataset), dtype=torch.float64,
                           device=self.device)
        ds = self.val_dataset
        with _whole(self._eval_model()):
            for start, _, lo, real, _, block in self._eval_feed(
                    ds, self._eval_blocks(len(ds))):
                if real:
                    a, b = self._val_pairs(block)
                    p, q = self._val_step(self._eval_put(a),
                                          self._eval_put(b))
                    vals[:, start + lo:start + lo + real] = torch.stack(
                        [p[:real], q[:real]]).double()
        psnr_sum = ssim_sum = 0.0
        num = 0
        for p_i, s_i in self._gathered(vals).T:
            psnr_sum += float(p_i)
            ssim_sum += float(s_i)
            num += 1
        if num == 0:
            return 0.0, 0.0
        return psnr_sum / num, ssim_sum / num

    def test(self, write_dicom: bool = True) -> Dict[str, float]:
        """Score the test list (``generator_ckpt``, else the newest
        checkpoint unless ``resume``) and write the SE2 series. The SE1
        header windows are read ahead by a thread pool; one writer thread
        pulls the stored slices and keeps :class:`DicomWriteback`'s order;
        the metric matrices are pulled once at the end. Over several ranks
        each writes the SE2 slices it evaluated, under the series UIDs rank
        0 draws."""
        cfg = self.config
        if cfg.generator_ckpt:
            self.load_generator(cfg.generator_ckpt)
        elif cfg.resume is False:
            found = find_latest_checkpoint(cfg.save_root, self.ckpt_prefix)
            if found:
                self.load_generator(found[0])
        with _whole(self._eval_model()):
            return self._test_pass(write_dicom)

    def _test_pass(self, write_dicom: bool) -> Dict[str, float]:
        """test()'s pass over the test list with the eval G as it is."""
        cfg = self.config
        lpips_fn = make_lpips_fn(cfg.lpips_weights, self.device)
        keys = METRIC_KEYS + (() if lpips_fn is None else ("LPIPSw", "LPIPS"))
        vals = torch.zeros(len(keys), len(self.test_dataset),
                           dtype=torch.float64, device=self.device)
        writeback = None
        if write_dicom:
            uid = (dist.broadcast_object(generate_uid())
                   if dist.world() > 1 else None)
            writeback = DicomWriteback(cfg.image_save, uid)
        ds = self.test_dataset
        blocks = self._eval_blocks(len(ds))
        with ThreadPoolExecutor(max(1, cfg.n_cpu)) as pool, \
                ThreadPoolExecutor(1) as writer:
            # the SE1 windows of this rank's slices (a padding row repeats
            # one of them)
            windows = {i: pool.submit(_se1_window, ds.files_a[i])
                       for i in dict.fromkeys(i for *_, idx in blocks
                                              for i in idx)}
            written = []
            for start, paths, lo, real, idx, block in self._eval_feed(
                    ds, blocks):
                stored = None
                if real:
                    a, b = self._val_pairs(block)
                    wcww = [windows[i].result() for i in idx]
                    wc, ww = (torch.tensor([w[i] for w in wcww],
                                           dtype=torch.float32,
                                           device=self.device)
                              for i in (0, 1))
                    if lpips_fn is None:
                        stored, mat = self._test_step(
                            self._eval_put(a), self._eval_put(b), wc, ww)
                    else:  # JAX's per-slice evaluator, LPIPS on the views
                        stored, lp_rows = self._lpips_test_step(
                            self._eval_put(a), self._eval_put(b), wcww,
                            lpips_fn)
                        mat = torch.tensor([[r[key] for r in lp_rows]
                                            for key in keys],
                                           dtype=torch.float64)
                    vals[:, start + lo:start + lo + real] = (
                        mat[:, :real].to(vals))
                    stored = stored[:real]
                if writeback is not None:
                    written.append(writer.submit(_write_batch, writeback,
                                                 paths, stored, lo))
            for f in written:
                f.result()  # raise a writeback error here
        full = self._gathered(vals)
        agg = aggregate([{key: float(full[i, j])
                          for i, key in enumerate(keys)}
                         for j in range(full.shape[1])])
        if not self.quiet:
            for key in ("MAEw", "PSNRw", "SSIMw", "UQIw", "LPIPSw"):
                if key in agg:
                    print(f"{key}: {agg[key]}")
            print()
            for key in ("MAE", "PSNR", "SSIM", "UQI", "LPIPS"):
                if key in agg:
                    print(f"{key}: {agg[key]}")
            if "LPIPS" not in agg:
                # the reference prints 10 aggregates; say why two are missing
                print("LPIPSw/LPIPS: not computed — no lpips_weights "
                      "configured (build the weights file with `python -m "
                      "ctagan_tpu_torch.ops.lpips`)", flush=True)
        return agg

    @torch.no_grad()
    def _lpips_test_step(self, a, b, wcww, lpips_fn):
        """test() with LPIPS: each slice through :func:`evaluate_pair` (the
        8 metrics and LPIPSw/LPIPS), and the stored fakes as in
        :meth:`_test_step`."""
        fb, rb = self._eval_pair(a, b)
        rows = [evaluate_pair(fb[j], rb[j], wc, ww, lpips_fn=lpips_fn)
                for j, (wc, ww) in enumerate(wcww)]
        return ((fb + 1.0) * 0.5 * 4095.0).to(torch.int16), rows

    @torch.no_grad()
    def make_figures(self, out_dir: Optional[str] = None, limit: int = 8
                     ) -> str:
        """Qualitative PNG panels over the first ``limit`` test slices (the
        reference's ``testt()``): input (with 2.5-D context its centre
        channel), target and synthetic, then a 2× zoom of each around the
        centre, on the eval route; into ``<image_save>/panels`` unless
        ``out_dir`` is given. Returns the directory."""
        from ctagan_tpu_torch.utils.figures import save_qualitative_panel

        cfg = self.config
        out_dir = out_dir or os.path.join(cfg.image_save, "panels")
        loader = PrefetchLoader(self.test_dataset, batch_size=1,
                                num_threads=cfg.n_cpu)
        model = self._eval_model()
        for i, batch in enumerate(loader):
            if i >= limit:
                break
            a, b = self._val_pairs(batch)
            a_n = self._eval_input(self._eval_put(a))
            b_n = self._eval_input(self._eval_put(b))
            fake = model(a_n, fused_body=cfg.fused_body)[0, :, :, 0]
            save_qualitative_panel(
                out_dir, f"slice{i}",
                [a_n[0, :, :, a.shape[-1] // 2].float().cpu().numpy(),
                 b_n[0, :, :, 0].float().cpu().numpy(),
                 fake.float().cpu().numpy()],
                zoom_center=(cfg.size // 2, cfg.size // 2))
        return out_dir


def generator_weights(path: str) -> Dict[str, torch.Tensor]:
    """The eval generator's state dict in a checkpoint: a reference-format
    ``.pth`` as it is, a port checkpoint's G (``g``, CycleGAN's ``g_a2b``;
    told apart by content), a JAX ``.ckpt``'s state's G (``g_params``,
    CycleGAN's ``g_a2b_params``)."""
    obj = load_checkpoint(path)
    if is_jax_checkpoint(path):
        return jax_generator_state_dict(jax_generator_params(obj["state"]))
    if isinstance(obj, dict) and "state" in obj and "epoch" in obj:
        state = obj["state"]
        return state["g" if "g" in state else "g_a2b"]
    return obj


def _se1_window(a_path: str) -> Tuple[float, float]:
    """The (WC, WW) of a slice's SE1 partner, 50 / 400 where unset."""
    ds1 = read_dicom(a_path.replace("SE0", "SE1"))
    return ds1.window_center or 50.0, ds1.window_width or 400.0


def _write_batch(writeback: DicomWriteback, paths,
                 stored: Optional[torch.Tensor], lo: int = 0) -> None:
    """The stored slices of ``paths[lo:lo + len(stored)]``; the writeback
    passes over the others (another rank's), keeping the patient count."""
    px = stored.cpu().numpy() if stored is not None else ()
    for j, path in enumerate(paths):
        if 0 <= j - lo < len(px):
            writeback.write(path, px[j - lo])
        else:
            writeback.skip(path)


class P2pTrainer(TrainerBase):
    """pix2pix: G and a conditional D on [A (with its 2.5-D context), B]."""

    family = "p2p"
    title = "pix2pix"
    _NETS = (("g", "g_model"), ("d", "d_model"))
    _OPTS = ("g_opt", "d_opt")

    def _build_models(self):
        cfg = self.config
        # D from seed + 1
        self.d_model = Discriminator(
            cfg.input_nc * cfg.context_slices + cfg.output_nc,
            dtype=_dtype(cfg)).reset_parameters(cfg.seed + 1).to(self.device)

    def _init_state(self):
        return steps.init_p2p_state(self.g_model, self.d_model,
                                    self.config.seed, ema=self._ema_on)

    def _step(self, batch, lr, lr_d):
        return steps.p2p_train_step(
            self.state, self._step_cfg("P2P_lamda", "Adv_lamda"), batch, lr)


class CycTrainer(TrainerBase):
    """CycleGAN: G_A2B (``g_model``, the one val and test run) and G_B2A
    under one Adam, two scalar Ds, two 50-slot replay pools."""

    family = "cyc"
    title = "CycleGAN"
    _NETS = (("g_a2b", "g_a2b"), ("g_b2a", "g_b2a"), ("d_a", "d_a"),
             ("d_b", "d_b"))
    _OPTS = ("g_opt", "d_a_opt", "d_b_opt")
    _EMAS = ("g_ema", "g_ema_b2a")

    def _build_models(self):
        cfg = self.config
        # G_A2B from seed, G_B2A from seed + 1, D_A seed + 2, D_B seed + 3
        self.g_b2a = self._generator(cfg.seed + 1)
        self.d_a, self.d_b = (
            Discriminator(cfg.input_nc, dtype=_dtype(cfg)).reset_parameters(
                cfg.seed + k).to(self.device) for k in (2, 3))

    def _init_state(self):
        cfg = self.config
        return steps.init_cyc_state(self.g_model, self.g_b2a, self.d_a,
                                    self.d_b, cfg.size, cfg.input_nc,
                                    seed=cfg.seed, ema=self._ema_on)

    def _step(self, batch, lr, lr_d):
        return steps.cyc_train_step(
            self.state, self._step_cfg("Adv_lamda", "Cyc_lamda"), batch, lr)

    def _checkpoint_state(self) -> Dict[str, object]:
        st = self.state
        out = super()._checkpoint_state()
        for key in ("fake_a_buffer", "fake_b_buffer"):
            buf = getattr(st, key)
            out[key] = {"data": buf.data, "size": buf.size}
        return out

    def _load_state(self, state) -> None:
        super()._load_state(state)
        st = self.state
        for key in ("fake_a_buffer", "fake_b_buffer"):
            buf = getattr(st, key)
            buf.data.copy_(state[key]["data"])
            buf.size = int(state[key]["size"])


class RegTrainer(TrainerBase):
    """RegGAN: G, the registration net R and a scalar D on the full-range
    pair; D trains at G's lr, as the reference's Reg trainer does."""

    family = "reg"
    title = "RegGAN"
    _NETS = (("g", "g_model"), ("r", "r_model"), ("d", "d_model"))
    _OPTS = ("g_opt", "r_opt", "d_opt")
    stage2 = False

    def _build_models(self):
        cfg = self.config
        # R from seed + 1, D from seed + 2
        self.r_model = RegNet(cfg.input_nc, cfg.input_nc, dtype=_dtype(cfg)
                              ).reset_parameters(cfg.seed + 1).to(self.device)
        self.d_model = self._build_d().reset_parameters(cfg.seed + 2
                                                        ).to(self.device)

    def _build_d(self):
        return Discriminator(self.config.input_nc, dtype=_dtype(self.config))

    def _init_state(self):
        return steps.init_reg_state(self.g_model, self.r_model, self.d_model,
                                    self.config.seed, ema=self._ema_on)

    def _step(self, batch, lr, lr_d):
        cfg = self._step_cfg(
            "Adv_lamda", "Corr_lamda", "Adv_lamda1", "Corr_lamda1",
            "Corr_lamda2", "FM_lamda", "Smooth_lamda", "d_refwd", "r1_gamma",
            "warp_max_disp", "reg_downsample")
        return steps.reg_train_step(
            self.state, cfg, batch, lr,
            lr_d=lr_d if self.dual_window else None,
            dual_window_mode=self.dual_window, stage2=self.stage2)


class HdTrainerStage1(RegTrainer):
    """CTA-GAN stage 1: RegGAN losses on dual-window data with a separate,
    frozen D lr."""

    family = "hd1"
    title = "HD stage 1"
    dual_window = True


class HdTrainerStage2(HdTrainerStage1):
    """CTA-GAN stage 2, the fine-tune: a multi-scale D (``num_d`` scales,
    the reference's 1, over a center-crop pyramid), the weighted GAN loss
    and the window-masked SR_loss2, from stage 1's G and R
    (:meth:`bootstrap_from_stage1`)."""

    family = "hd2"
    title = "HD stage 2"
    stage2 = True

    def _build_d(self):
        cfg = self.config
        return MultiScaleDiscriminator(cfg.input_nc, num_d=cfg.num_d,
                                       pyramid=cfg.pyramid,
                                       dtype=_dtype(cfg))

    def bootstrap_from_stage1(self, path: Optional[str] = None
                              ) -> "HdTrainerStage2":
        """G and R from a stage-1 checkpoint, the port's ``.pt`` or JAX's
        ``.ckpt``: ``path``, else ``stage1_ckpt``, else the newest
        ``*_hd1_e*`` in ``save_root`` under any config name. D, the
        optimizers and the augmentation RNG stay as they are (fresh in a new
        run), as in the JAX package."""
        path = path or self.config.stage1_ckpt
        if not path:
            found = find_latest_of_family(self.config.save_root,
                                          HdTrainerStage1.family)
            if found is None:
                raise FileNotFoundError(
                    f"no stage-1 checkpoint (*_hd1_e*.pt or .ckpt) in "
                    f"{self.config.save_root}; set stage1_ckpt")
            path = found[0]
        state = load_checkpoint(path)["state"]
        if is_jax_checkpoint(path):
            g_sd = generator_state_dict(state["g_params"])
            r_sd = regnet_state_dict(state["r_params"])
        else:
            g_sd, r_sd = state["g"], state["r"]
        with _one_process(self.state):
            self.g_model.load_state_dict(g_sd, strict=True)
            self.r_model.load_state_dict(r_sd, strict=True)
        if not self.quiet:
            print(f"stage 2 bootstrapped G and R from {path}", flush=True)
        return self


class P3dTrainer(TrainerBase):
    """The 3-D family: pix2pix on paired depth windows (``patch_depth``
    slices) with ``Generator3D`` and a conditional ``Discriminator3D``;
    validation and test score each window's centre slice. ``test()`` writes
    no DICOM unless asked (series go through ``--mode infer``)."""

    family = "p3d"
    title = "3-D pix2pix"
    _NETS = (("g", "g_model"), ("d", "d_model"))
    _OPTS = ("g_opt", "d_opt")
    # one loader thread: the windows' random starts are drawn in the
    # loader's order, so the seed fixes them
    _loader_threads = 1

    def _generator(self, seed: int) -> Generator3D:
        cfg = self.config
        ds = {1: (1, 1), 2: (1, 2), 4: (2, 2)}[cfg.depth_downsample]
        return Generator3D(cfg.input_nc, cfg.output_nc, depth_strides=ds,
                           dtype=_dtype(cfg)).reset_parameters(seed).to(
                               self.device)

    def _build_models(self):
        cfg = self.config
        # D from seed + 1
        self.d_model = Discriminator3D(cfg.input_nc * 2, dtype=_dtype(cfg)
                                       ).reset_parameters(cfg.seed + 1).to(
                                           self.device)

    def _init_state(self):
        return steps.init_p3d_state(self.g_model, self.d_model,
                                    self.config.seed, ema=self._ema_on)

    def _step(self, batch, lr, lr_d):
        return steps.p3d_train_step(
            self.state, self._step_cfg("P2P_lamda", "Adv_lamda"), batch, lr)

    @staticmethod
    def _eval_slices(x: torch.Tensor) -> torch.Tensor:
        return x[:, x.shape[1] // 2, :, :, 0]  # the centre depth slice

    def _train_dataset(self):
        cfg = self.config
        return VolumePatchDataset(cfg.train_list, depth=cfg.patch_depth,
                                  size=cfg.size, train=True,
                                  rng=self._data_rng)

    def _eval_dataset(self, list_file: str):
        cfg = self.config
        return VolumePatchDataset(list_file, depth=cfg.patch_depth,
                                  size=cfg.size, train=False)

    def test(self, write_dicom: bool = False) -> Dict[str, float]:
        """Patch-window evaluation on the centre slices, as JAX's; series
        go through ``--mode infer`` (depth-blended)."""
        return super().test(write_dicom=write_dicom)


TRAINERS = {"P2p": P2pTrainer, "CycleGan": CycTrainer, "RegGan": RegTrainer,
            "HdGan": HdTrainerStage1, "HdGan2": HdTrainerStage2,
            "P3d": P3dTrainer}


def build_trainer(config: Config, device: torch.device,
                  quiet: bool = False) -> TrainerBase:
    """The trainer of ``config.name``, as the JAX package dispatches."""
    name = config.name
    if name not in TRAINERS:
        raise KeyError(f"unknown trainer '{name}' (have {sorted(TRAINERS)})")
    return TRAINERS[name](config, device, quiet=quiet)
