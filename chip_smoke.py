#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``ctagan_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and no network, and imports nothing of JAX. Phases:

1. build the CUDA kernels from ``ctagan_tpu_torch/csrc`` (``ops/_build.py``,
   one nvcc per source, all at once; ``-Xptxas -v`` shows each kernel's
   registers and shared memory);
2. ``kernels``: each kernel against its plain PyTorch version at the main
   paths' shapes, f32 and bf16, every variant a path uses (K1, K3, K2 at the
   serving generator's 512² shapes with N=2; K3 also at a ragged (1, 72,
   104, 64) (a partial tile on a 36×52 grid), at a halo case whose norm
   means are ±1.5 (a normalized zero staged for the zero pad would be far
   off), and without a norm; K2 also at a ragged (1, 36, 52, 256) → (72,
   104, 128), at an edge case whose norm means are ±1.5 (the output
   padding's zero row and column) and at up1 with a norm; K4
   conv3x3_input_grad and K5
   conv3x3_weight_grad at the training body's (1, 128, 128, 256), both also
   at a ragged (1, 40, 40, 256) (K5 with skip) and at C = Cout = 128; K7
   conv3x3_reflect_s8 at the int8 body's (2, 128, 128, 256) in both input
   modes, f32 and bf16 out, and at the served batch's N=16 in mode (ii), at
   C = Cout = 128, at a ragged (1, 40, 40, 256) and with f32 raw input in
   mode (ii); K6 instance_norm_pallas at the int8 forward's
   norm shapes, f32 and bf16 I/O, at its served N=16 in f32, at the layer
   route's body (1, 128, 128, 256) in bf16 and at ragged (1, 48, 136, 20),
   (1, 48, 136, 36) and (1, 512, 520, 20) in both, each also required to
   give the same bits on a second call); times the kernel, the plain
   version and
   one PyTorch library call (cuDNN, ``F.instance_norm``, or for K7 the int8
   GEMM alone: yardsticks the port never calls) with CUDA events, and
   computes each case's bound from its operations and bytes; K1 also at a
   ragged (1, 40, 40, 256) and at C = Cout = 128; K4's, K3's, K2's, K7's
   and K6's kernels alone (K6 with its plan's route and the clusters the
   card runs at once), and their wrappers' device time by kernel beside
   the host time; K1's, K2's, K3's, K4's and K5's built kernels are held to
   hold ``HGMMA`` (``wgmma``) instructions, and K7's ``IGMMA`` (int8
   ``wgmma``) and no ``IDP4A`` (``cuobjdump -sass``);
3. ``generator``: the full-width generator (9 blocks, base 64, 11,365,633
   parameters, seeded weights) at 512², b=2: the serving kernel route
   against the plain layer route, 18 K1, 2 K3 and 2 K2 launches per forward;
   forward times at b=1 and b=16; then ``configs/HdGan_fast.yaml`` (bf16,
   ``pad_mode: zero``) built by ``serving_generator`` and served a few
   requests through its layer route, no kernel launched, then again with
   the InstanceNorm switch on: 23 K6 launches per forward, each response
   within the same bound of the switch-off forward;
4. ``int8``: the same generator quantized (``ops/quantize.py``) at 512²,
   b=2, with the InstanceNorm switch on: ``generator_int8_forward`` through
   K7 and K6 against the same forward through their plain versions and
   against the f32 plain route (PSNR), 18 K7 and 5 K6 launches per forward;
   forward times at b=1 and b=16 beside the f32 kernel route;
5. ``grad``: the generator's training route (``fused_body_grad``) against
   the plain layer route at 512², b=1, f32: output and every parameter's
   gradient, 18 K1 launches per forward, 18 K4 and 18 K5 per backward;
6. ``serving``, a main path: ``serve_async`` on ``configs/HdGan.yaml``
   with the generator ``--mode serve`` builds (``serving_generator``: the
   config's trainer, a port ``.pt`` in a temporary ``save_root`` that only
   its checkpoint lookup finds), concurrent POST /synthesize of synthetic
   DICOM slices, each response checked, one against the plain route;
7. ``int8_serving``, a main path: the same on a copy of the config with
   ``serve_quantize: int8`` and the InstanceNorm switch on, every response
   against the f32 plain route (JAX's int8 service bound);
8. ``training``, a main path: ``python -m ctagan_tpu_torch --mode train``'s
   ``train()`` on ``configs/HdGan.yaml`` with its list paths pointed at a
   seeded 512² corpus: finite losses, G, R and D all updated, 36 K1, 18 K4
   and 18 K5 launches per step and 18 K1 for the live panel's forward at
   the epoch's last step; the p50 step time of the kernel route and of the
   plain route (``fused_body_grad: off``); the kernel route's 12 steps end
   epoch 1, whose checkpoint goes to a temporary ``save_root``;
9. ``test``, a main path: ``python -m ctagan_tpu_torch --mode test``'s
   ``test()`` and then ``validate()`` on ``configs/HdGan.yaml`` (full
   width, seeded weights, TF32 off) over a seeded 512² corpus of 48 slice
   pairs (val: 8 slices; test: 36 slices of three patients, one of them
   with SE1 headers at WC 300 / WW 1500), at ``eval_batch`` 1 and 16, on
   three routes: ``fused_body: true`` (18 K1, 2 K3 and 2 K2 launches per
   forward), the default config (the training route: 18 K1 per forward)
   and the plain route (``fused_body_grad: off``, none). Each kernel
   route's aggregates within 0.01 dB (PSNR, PSNRw) and 1e-4 (the others)
   of the plain route's; every SE2 file read back (count, layout, one
   fresh SeriesInstanceUID per patient, pixels within 4 stored units of
   the plain route's and of a direct plain forward), SE0/SE1 copies
   byte-equal to their sources; test() and validate() slices/s per route
   and batch (host wall, after one warm-up forward per route and batch);
10. ``stage2``, a main path: HD stage 2 through ``python -m
   ctagan_tpu_torch --mode train``'s ``train()``. (a) One stage-1 epoch on
   ``configs/HdGan.yaml`` (12 slice pairs of a seeded 512² corpus) saves
   ``HdGan_hd1_e1.pt`` in a temporary ``save_root``; (b)
   ``configs/HdGan2.yaml`` on the same corpus and ``save_root`` trains 12
   steps on the kernel route: G and R at step 1 bit-equal to the stage-1
   checkpoint's and D the seeded multi-scale D, 36 K1, 18 K4 and 18 K5
   launches per step and the live panel's 18 K1, finite losses with ``SR_loss2``, G, R and D all
   updated, the epoch's ``HdGan2_hd2_e1.pt`` saved, its p50 step; (c) the
   plain route (``fused_body_grad: off``) from the same bootstrap, no
   launch, its first step's ``toal_loss`` within a relative 1e-3 of the
   kernel route's (the same augmentation draws), its p50 step; (d)
   ``configs/HdGan_fast.yaml`` (bf16, ``pad_mode: zero``, ``warp_max_disp:
   4``, ``reg_downsample: 2``) trains a stage-1 epoch of 6 slices on the
   layer route, then (renamed ``HdGan2``) a stage-2 epoch bootstrapped
   from it: finite losses, no launch, their p50 steps;
11. ``families``, a main path: the other 2-D trainers through ``python -m
   ctagan_tpu_torch --mode train``'s ``train()`` at full width, 512², b=1,
   f32, seeded weights: ``configs/RegGan.yaml`` (G, the ResUNet R, the
   scalar D), ``configs/P2p.yaml`` (G, a 2-channel conditional D) and
   ``configs/CycleGan.yaml`` (two Gs under one Adam, two Ds, two 50-slot
   replay pools), each built by name on a list of 6 seeded slice pairs:
   6 kernel-route steps end epoch 1, which validates 2 slices and saves
   ``<name>_<family>_e1_*.pt``; finite losses under JAX's keys, every net
   updated, exactly 36 K1, 18 K4 and 18 K5 launches a step (RegGAN, P2p:
   G's forward and D's re-forward of the updated G) or 72, 72 and 72
   (CycleGAN: four differentiated G forwards), plus 18 K1 per validated
   slice and per panel (the live batch's at the epoch's end, the first
   val slice's after the validation); the p50 step and the peak device memory; then 2 plain-route
   steps (``fused_body_grad: off``), no launch, first-step total loss
   within a relative 1e-3 of the kernel route's. CycleGAN again with
   ``batchSize: 2``, ``grad_accum: 2`` and ``ema_decay: 0.999`` for 2
   steps: 180 K1, 144 K4 and 144 K5 a step (each microbatch's four
   forwards, and one no-grad forward of each G over the batch for the
   pools); its validation reads the EMA, which differs from the live
   G_A2B. Last, ``--mode test`` of the P2p epoch's checkpoint on the
   serving route (``fused_body: true``): 18 K1, 2 K3 and 2 K2 a slice,
   the 8 metrics finite, the SE2 series written;
12. ``infer``, a main path: ``python -m ctagan_tpu_torch --mode infer``'s
   ``infer()`` on ``configs/HdGan.yaml`` (full width, 512², f32) over a
   seeded 50-slice SE0 series, the generator a port ``.pt`` in a temporary
   ``save_root`` that only the checkpoint lookup finds (seeded otherwise
   than the config), on three routes: the default eval route (18 K1 a
   batch forward), ``fused_body: true`` (18 K1, 2 K3, 2 K2) and the plain
   route (none); 13 batches of 4, the last padded, so exactly 13 times
   those; each route after a warm-up call, with slices/s of the whole call
   and of its load, forward and writeback; every SE2 file named, sized and
   re-UIDed as its SE0 slice, the kernel routes' stored pixels within 1 of
   the plain route's (the share equal printed), the plain route's first
   slice within 1 of a direct forward of the saved G; then
   ``configs/P2p.yaml`` with ``context_slices: 3`` on the default route;
13. ``export``: ``serving/export.py`` on the full-width G at 512² with a
   symbolic batch, loaded by ``load_exported`` and run at b=1 and b=4
   within 2e-5 of the eager plain route, launching no kernel; the
   artifact's bytes, the export's seconds, and the b=4 forward of the
   loaded program, the eager plain route and the ``fused_body`` route;
14. ``figures``, a main path: ``--mode figures``'s panels of 4 test slices
   of ``configs/HdGan.yaml`` on the default eval route (18 K1 a slice),
   each PNG read back with ``read_png_gray`` at (512, 2304);
15. ``loop``, a main path: ``--mode train``'s ``train()`` on
   ``configs/HdGan.yaml`` at full width on the kernel route over 8 seeded
   512² slices, one epoch, ``log_every: 4``, ``stall_timeout: 120``, live
   panels, 2 val slices: ``HdGan_losses.csv`` (JAX's header, the epoch's
   row equal to the 8 steps' running means), ``HdGan_val.csv``,
   ``HdGan_latest_panel.png`` read back at (512, 1536), ``dashboard.html``
   with its SVG charts and inline PNG, the watchdog disarmed after the
   run, exactly 8 steps' launches plus 18 K1 for each of 2 live panels, 2
   val slices and the val panel. The wedge drill: ``python -m
   ctagan_tpu_torch --mode train --supervise 1`` on a two-epoch config
   with a checkpoint every step and ``stall_timeout: 20``, a
   ``sitecustomize.py`` shadow first on the child's ``PYTHONPATH`` holding
   the first attempt's second ``StepTimer.tick`` 600 s: the watchdog's exit
   42, one relaunch with ``--resume`` from ``HdGan_hd1_e1.pt``, epoch 2
   trained, exit 0. ``remat``: the HD stage-1 step on the layer route at
   batchSize 1 and 4 and on the kernel route at 1, off and on: p50 step and
   peak memory of each, the layer route's first-step G-phase losses within
   1e-6 (D's, after G's update, within 1e-4), the kernel route's launches
   and peak memory unchanged;
16. ``p3d``, a main path: ``configs/P3d.yaml`` (512², ``patch_depth`` 8,
   bf16, ``Generator3D`` base 32, 6 blocks, b=1) through ``train()`` over
   a seeded corpus of 4 series of 12 slices: an epoch of 4 steps, finite
   losses under JAX's keys, G and D updated, no kernel launched (3-D convs
   are cuDNN's), validated on the windows' centre slices,
   ``P3d_p3d_e1_*.pt`` saved; its p50 step, peak memory and FLOP bound;
   the first step again in f32 from the same seeds within 2e-2 of the bf16
   one; ``--mode infer`` over a seeded 40-slice series: every SE2 file
   named, sized and re-UIDed as its source, the slices only the first
   window covers within 1 stored unit of a direct forward of the saved G;
17. ``corpus``, a main path: the offline corpus stage. (a)
   ``ops/registration3d.py::demons_register`` (plain PyTorch: JAX computes
   it outside Pallas) on a seeded 16 × 128 × 128 pair, default levels and
   iterations, on the card and on the CPU: φ within 1e-3 voxel, a repeat
   on the card bit-equal; (b) ``data/registration.py::align_patient`` with
   no device and ``method="auto"`` on a seeded 512² × 128-slice patient
   (JAX's e2e fixture at that size: SE1 is SE0 under a sine field of 2 and
   1.5 voxels plus 80 HU): ``"demons"``, its registrar on the card, SE0
   unchanged, SE1's last slice the unwarped one, the interior error cut
   4× or more; the seconds of the load, the phase correlation, each
   pyramid level, the warp and the writeback, the peak device memory, the
   mean end-point error over the anatomy; no kernel launched; (c)
   ``python -m ctagan_tpu_torch.data.corpus`` in a fresh interpreter
   without JAX on that tree plus three seeded 6-slice patients, then
   ``--stats`` and ``--equip-split`` on its lists: every listed path and
   its SE1 partner exist, no patient in two lists, ``--stats``' slices
   the listed count;
18. ``dp``, a main path: the data-parallel plan (``parallel/mesh.py``,
   ``parallel/dist.py``) on ``configs/HdGan.yaml``'s stage 1 at full width,
   512², f32, TF32 off, on the kernel route, through ``__main__``'s
   ``train()`` and ``test()``. (a) 6 steps in a process group of one under
   NCCL: every gradient all-reduce returns its input bit for bit, 36 K1,
   18 K4 and 18 K5 a step, and the weights equal those of the same 6 steps
   without a group (bit for bit where two runs without a group are; else
   as (b) holds them); (b) two ranks on the one card under gloo, started
   by ``torchrun`` as this script with ``--dp-worker``: 4 steps at a
   global batch of 2, G, R and D bit-identical across the ranks after
   every step; step 1's gradient and the weights after 4 steps against
   one process's 4 steps on the same global batch at ``grad_accum: 2``
   (the ranks' forwards and backwards, summed on one card), bit-equal
   where a repeat of that run is, else within the grad phase's form
   (GRAD_RATIO × the repeat's distance + GRAD_TOL); each rank's launches,
   its p50 step, all-reduce ms a step (CUDA events), bytes reduced (the
   G, R and D gradients and 5 losses, checked) and peak memory; (c)
   test() of 48 slices at ``eval_batch`` 2 over the two ranks against one
   process at ``eval_batch`` 1, on two routes: the plain route with
   cuDNN's deterministic algorithms (the 8 metrics within 1e-6, the SE2
   trees file for file and pixel for pixel), and the default training
   route with cuDNN's defaults, the body through K1 (launched 18 times a
   forward on each rank): each metric within GRAD_RATIO × its distance in
   a repeat of the one process + 3e-5 (relative beyond 1), SE2 pixels
   within 1 stored unit. On a machine with several cards (b)
   and (c) run a rank a card under NCCL, and (d) ``python -m
   ctagan_tpu_torch --mode train``, which starts a rank a card itself
   through torchrun: one checkpoint, one row of each CSV;
19. ``fsdp``, a main path: the fsdp plan (``parallel/fsdp.py``) on the dp
   phase's config and corpus under ``mesh: {fsdp: 2}``: two ranks on the
   one card under gloo (several cards: a rank a card under NCCL), 4 steps
   at a global batch of 2 against one process at ``grad_accum: 2`` as dp
   (b) holds them; each rank's resting state (parameters, Adam moments:
   97,118,052 B, half of one process's plus G's and D's padding) and the
   bytes it gathers, reduce-scatters and all-reduces a step, each checked
   against the count from the nets' sizes, with their ms (CUDA events and
   the host clock), p50 step and peak memory; the ``.pt`` rank 0 writes,
   read at world 1, bit-equal to the ranks' gathered weights and first
   moments; test() over the ranks (the eval G gathered) as dp (c) holds
   it. With four cards or more, also ``{fsdp: 4}`` and ``{dp: 2, fsdp:
   2}``, a rank a card;
20. ``tp``, a main path: the tp plan (``parallel/tensor.py``) on the dp
   phase's config and corpus under ``mesh: {tp: 2}``: two ranks on the one
   card under gloo (several cards: a rank a card under NCCL), the residual
   pairs of G and R split over them, 4 steps against one process's 4 on
   the same batch on the layer route (which the split step runs: JAX's
   gate, no kernel launched, checked), held as dp (b); G's, R's and D's
   replicated weights bit-identical across the ranks after every step;
   each rank's resting state (parameters, Adam moments: 122,332,464 B) and
   the bytes it sums a step (the blocks' activations, 631,980,032 B, and
   the means of the replicated gradients and losses), each checked against
   the count from the nets' sizes, with the sums' ms (CUDA events), p50
   step and peak memory; the ``.pt`` rank 0 writes, read at world 1,
   bit-equal to the ranks' gathered state; test() over the ranks as dp (c)
   holds it (the eval G gathered, K1 18 a forward on the kernel route);
   ``infer_tensor_sharded`` of a seeded G at 2 × 512² within GEN_TOL of
   one process's forward. With four cards or more, also ``{tp: 4}`` and
   ``{dp: 2, tp: 2}``, a rank a card;
21. ``sp``, a main path: the sp plan (``parallel/spatial.py``,
   ``parallel/halo.py``): ``infer_spatial_sharded`` at 2048² and P2p, HD
   stage 1, RegGAN, HD stage 2 and CycleGAN under ``{sp: 2}`` on two gloo
   ranks sharing the card (:func:`check_sp`);
22. ``depth``, a main path: the depth plan (``parallel/volume.py``):
   ``infer_volume_depth_sharded`` of the shipped Generator3D on a 40-slice
   512² series over two gloo ranks in f32 and bf16 against one process's
   forward of the symmetric-extended series; P3d (``configs/P3d.yaml`` in
   f32) under ``{depth: 2}`` for 4 steps and ``{sp: 2}`` for 2, held
   against one process's float64 replay with every step's bytes exact,
   and one step at ``patch_depth`` 32 beside one process's peak memory;
   ``--mode infer`` with ``infer_depth_sharded: true`` at world 1; with
   four cards ``{depth: 4}``, ``{dp: 2, depth: 2}`` and the forward over
   four ranks, NCCL (:func:`check_depth`).

The launch counts of the main paths (each counted from zero) are the
``launches`` of the kernels line. ``--phases a,b`` runs a subset and stops
before the result lines; ``--cases K2,K3`` keeps only the kernel phase's
cases and timing lines of those kernels (and stops there too). Any failure
exits nonzero before the last line. The last line is ``{"ok": true,
"device": {...}}``; the line before it is the kernels JSON, and the one
before that the card's name and power limit.
"""
import argparse
import concurrent.futures
import contextlib
import copy
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances, stated once: f32 max |kernel − plain| <= 1e-4 · max(1, |plain|)
# (accumulation order over K = 9·C, or over the 16,384 pixels K5 sums with
# atomics); bf16 <= 2^-7 · max(1, |plain|) (two bf16 ulps: f32 sums that
# differ in the last bits round to neighbouring bf16 values). Stats relative
# to their largest magnitude: f32 1e-4, bf16 1e-2.
OUT_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
STATS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# kernel route vs plain layer route of the whole f32 generator (tanh output)
GEN_TOL = 1e-3
# training route: every parameter's gradient is held against a float64 run
# of the plain route, as is the plain f32 route's. Both f32 routes sum in
# other orders than f64 (K1's stats and K5's partial sums with atomics,
# cuDNN's own algorithms), and ReLU masks that flip where rounding moves a
# pre-activation across 0, through 18 InstanceNorm backwards, leave the f32
# gradient of this net ~1e-3 (Frobenius) to ~2e-2 (largest element) from
# the f64 one on either route (measured on an H100). So the check is
# relative:
# ||g_kernel - g64|| <= GRAD_RATIO * ||g_plain - g64|| + GRAD_TOL * ||g64||,
# Frobenius norms per tensor, ||g64|| floored at GRAD_FLOOR times the
# largest gradient norm of the net (a conv bias before an InstanceNorm has
# a gradient that is zero in exact arithmetic).
GRAD_RATIO = 2.0
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-3
# served pixel (0..4095 stored values) vs the plain route on the same input
PIXEL_TOL = 4.0
# K7: the int32 sums are exact and the dequant is one rounding per operation
# in a fixed order, so out equals the plain version's exactly; its stats are
# summed with atomics in another order: 1e-4 relative
K7_OUT_TOL = {"float32": 0.0, "bfloat16": 0.0}
# K6: f32 1e-5 relative (rsqrtf, sum order of the statistics); bf16 two
# bf16 ulps (the OUT_TOL bound)
K6_OUT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# the int8 forward through K7/K6 vs the same forward through their plain
# versions: a last-bit difference of a statistic (atomics) can move a value
# across an int8 rounding boundary, one step of that tensor's scale, and each
# later InstanceNorm and re-quantization carries it on through 9 blocks, so
# the two int8 routes differ by int8-grade noise, only a little less than
# int8 differs from f32 on this random-weight net. Held to a max of an eighth
# of the [-1, 1] range, a mean below what int8 vs f32 gives, and a PSNR
# between the two int8 routes above int8 vs f32 by INT8_PSNR_MARGIN dB (a
# forward that skipped the quantization sits at the f32 distance). Measured
# on an H100: mean 0.0189-0.0193 kernel vs plain, 0.0234 int8 vs f32; PSNR
# 38.3-38.5 against 36.6 dB.
INT8_MAX_TOL = 0.25
INT8_MEAN_TOL = 0.021
INT8_PSNR_MARGIN = 1.0
# an int8 forward vs the f32 route: JAX's quality contract
# (tests/test_quantize.py), PSNR over the [-1, 1] range
INT8_PSNR_MIN = 30.0
# a served int8 slice vs the f32 route on the same DICOM: the JAX int8
# service's own bound (tests/test_quantize.py::
# test_int8_through_serving_service), mean |error| over the [-1, 1] range
INT8_SERVED_MEAN_TOL = 0.05
N_REQUESTS = 16
# configs/HdGan_fast.yaml (bf16, pad_mode: zero) served through the layer
# route: each response against the same generator's forward on its slice
# alone, mean |error| over [-1, 1] per slice. Batch composition changes
# cuDNN's bf16 algorithms, so the two differ at bf16 grade (the CPU test
# measured 0.0065 between the port's and JAX's bf16 forwards); reflect
# padding in place of zero padding is ~0.24 away
ZERO_PAD_REQUESTS = 4
ZERO_PAD_MEAN_TOL = 2.0 ** -6
# with the InstanceNorm switch on, the layer route runs every one of the
# generator's InstanceNorms through K6: head, 2 downs, 18 in the 9 residual
# blocks, 2 ups
ZERO_PAD_NORMS = 23
TRAIN_STEPS = 12  # kernel route; the p50 skips the first 2 steps
PLAIN_STEPS = 6   # plain route, for its p50 beside the kernel route's
# H100 SXM peaks (NVIDIA's H100 data sheet, 700 W): f32 outside
# the tensor cores, bf16, int8 and TF32 dense tensor cores, HBM3 bytes/s
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_INT8, PEAK_TF32 = 1979e12, 495e12
# the kernels on wgmma, by name: K1, K2, K3 and K4 csrc/conv_wgmma.cuh, K5
# csrc/fused_resblock_grad.cuh
WGMMA_KERNELS = {"K1": "k1_wgmma_kernel", "K2": "k2_wgmma_kernel",
                 "K3": "k3_wgmma_kernel", "K4": "k4_wgmma_kernel",
                 "K5": "wgrad_kernel"}
# K7 (csrc/fused_s8.cu) on int8 wgmma: its input (int8, f32 or bf16 raw)
# by output (f32 or bf16) types, each at one tile width or more; IDP4A
# would be the CUDA-core dot product of its first version
K7_WGMMA_KERNEL = "k7_wgmma_kernel"
K7_KINDS = 6
# the test phase: a 512² corpus of 4 patients of 12 slices; val = 8 of
# patient 0's slices, test = the other three patients' 36 (patient 2's SE1
# headers at WC 300 / WW 1500); its kernel routes' aggregates against the
# plain route's: PSNR and PSNRw in dB, the others absolute (the f32
# generator routes differ far below GEN_TOL, which moves a fake pixel
# across a window level or a 0.3 mask boundary only where it sits on one)
EVAL_SIZE, EVAL_PATIENTS, EVAL_SLICES = 512, 4, 12  # HdGan.yaml's size
VAL_SLICES = 8
TEST_SLICES = (EVAL_PATIENTS - 1) * EVAL_SLICES
EVAL_BATCHES = (1, 16)
TEST_PSNR_TOL = 0.01
TEST_TOL = 1e-4
# the stage2 phase: the kernel route's first-step toal_loss against the
# plain route's from the same bootstrap and the same augmentation draws,
# relative (f32 on two routes; the stage-1 step's routes differ ~1e-6)
STAGE2_ROUTE_TOL = 1e-3
# configs/HdGan_fast.yaml (bf16, layer route) in stage 1 and then stage 2:
# steps of each, on a list of as many slices, so each run ends an epoch
FAST_STEPS = 6
# the families phase: each 2-D family's config trains FAMILY_STEPS steps on
# the kernel route over a list of as many slices (the epoch ends, validates
# FAMILY_VAL slices and saves), then FAMILY_PLAIN_STEPS on the plain route,
# whose first-step total loss lies within FAMILY_ROUTE_TOL (relative) of the
# kernel route's (the same seeds, so the same batch and augmentation draws)
FAMILY_STEPS = 6
FAMILY_PLAIN_STEPS = 2
FAMILY_VAL = 2
FAMILY_ROUTE_TOL = 1e-3
# CycleGAN with batchSize 2, grad_accum 2 and ema_decay 0.999: steps
ACCUM_STEPS = 2
# the infer phase: a 50-slice SE0 series in batches of 4 (the last padded);
# the saved G is seeded INFER_SEED, not the config's seed; each kernel
# route's SE2 stored pixels within INFER_PIXEL_TOL of the plain route's (a
# fake within GEN_TOL moves a pixel across a truncation boundary by one)
INFER_SLICES, INFER_BATCH, INFER_SEED = 50, 4, 7
INFER_BATCHES = -(-INFER_SLICES // INFER_BATCH)
INFER_PIXEL_TOL = 1
# the export phase: the loaded program vs the eager plain route, JAX's own
# tolerance for its round trip (tests/test_export.py)
EXPORT_BATCHES = (1, 4)
EXPORT_TOL = 2e-5
# the figures phase: panels of 4 test slices, each the input, target and
# synthetic 512² slices and a 2x zoom of each one's central 128² crop
FIGURE_SLICES = 4
FIGURE_SHAPE = (EVAL_SIZE, 3 * EVAL_SIZE + 3 * 2 * 128)
# the loop phase: configs/HdGan.yaml's loop over LOOP_STEPS slices with
# log_every LOOP_LOG_EVERY (live panels at steps 4 and 8) and LOOP_VAL val
# slices; the wedge drill on DRILL_SLICES slices, two epochs, its first
# attempt's second step timer tick held DRILL_SLEEP s against a
# DRILL_STALL s watchdog, the whole drill within DRILL_TIMEOUT s
LOOP_STEPS, LOOP_LOG_EVERY, LOOP_VAL = 8, 4, 2
DRILL_SLICES, DRILL_STALL, DRILL_SLEEP, DRILL_TIMEOUT = 4, 20, 600, 300
# remat: the HD stage-1 step's steps per run at each batch size (12 slices:
# b=4 runs two 3-step epochs); the first step's G-phase losses (the forward
# before any update) with and without remat within REMAT_LOSS_TOL
# (relative; the same forward either way), its D loss within REMAT_D_TOL:
# D's loss comes after G's update, whose gradient grid_sample's backward
# sums with atomics, so it moves ~1e-6 from run to run (measured on an
# H100: 3.2e-6 between remat off and on at b=1)
REMAT_SLICES, REMAT_STEPS, REMAT_LOSS_TOL = 12, {1: 6, 4: 6}, 1e-6
REMAT_D_TOL = 1e-4
# the p3d phase: configs/P3d.yaml (512², patch_depth 8, bf16) on a corpus of
# P3D_PATIENTS series of P3D_SLICES slices (an epoch = one window of each);
# the f32 first step's losses within P3D_F32_TOL (relative) of the bf16
# run's; --mode infer over a P3D_SERIES-slice series, the slices only the
# first window covers within INFER_PIXEL_TOL of a direct forward of it
P3D_PATIENTS, P3D_SLICES, P3D_SERIES, P3D_F32_TOL = 4, 12, 40, 2e-2
P3D_LOSS_KEYS = ["loss_G", "loss_L1", "loss_GAN_A2B", "loss_D_B"]
# the corpus phase: (a) demons_register on the card and on the CPU on a
# CORPUS_A_SHAPE pair, default levels and iterations, φ within
# CORPUS_PHI_TOL voxel (the port's f32 φ lies 1.2e-5 voxel from its float64
# run on this pair, on a CPU: tests/demons_fixture_study.py --f64), a repeat
# bit-equal; (b) align_patient on a seeded
# CORPUS_SLICES-slice patient at CORPUS_SIZE², JAX's e2e bar (the interior
# error cut by CORPUS_CUT or more, the last slice within 1 stored unit of
# the unwarped one); (c) the corpus CLI on that tree plus CORPUS_EXTRA
# seeded patients of CORPUS_EXTRA_SLICES slices
CORPUS_A_SHAPE, CORPUS_PHI_TOL = (16, 128, 128), 1e-3
CORPUS_SLICES, CORPUS_SIZE, CORPUS_CUT = 128, 512, 4.0
CORPUS_EXTRA, CORPUS_EXTRA_SLICES = 3, 6
# the dp phase: configs/HdGan.yaml's stage 1 (full width, 512², f32, TF32
# off, kernel route) on a seeded corpus of DP_PATIENTS patients of DP_SLICES
# slices, trained on the first patient's: (a) DP_W1_STEPS steps in a group
# of one under NCCL against the same steps without a group (bit-equal where
# two runs without a group are; the kernels' stats and weight gradients
# and grid_sample's backward sum with float atomics); (b) DP_STEPS steps of
# DP_WORLD gloo ranks sharing the card at a global batch of DP_WORLD
# against one process at batchSize DP_WORLD and grad_accum DP_WORLD,
# bit-equal where a repeat of that run is (two ranks: two gradients sum
# to the same bits in either order), else held as the grad phase holds a
# route (GRAD_RATIO, GRAD_TOL); (c) test() of every slice at eval_batch
# DP_WORLD over the ranks against one process at eval_batch 1 (each rank
# then forwards a slice at a time, as the one process does): on the plain
# route (cuDNN deterministic) the 8 metrics within DP_METRIC_TOL (relative
# beyond 1) and the SE2 trees file for file and pixel for pixel; on the
# kernel route (cuDNN's defaults) each metric within GRAD_RATIO × its
# distance in a repeat of the one process + DP_KERNEL_METRIC_TOL, the SE2
# pixels within DP_KERNEL_PIXELS stored units. There K1 sums its
# statistics with float atomics, so a fake pixel can cross the 0.3
# threshold of the fake's own mask (evaluation.py::_masked_views), which
# moves that slice's window metrics by a step: in the H100 runs the
# aggregate PSNRw of two ranks stood 1.3e-5 from one process's (in two
# calls) while one process's repeats stood 6e-8 apart. DP_KERNEL_METRIC_TOL
# leaves room for about ten such steps; a wrong slice, row or window moves
# a metric by far more, and the pixel bound holds every fake. On a machine
# with several cards (b) and (c) run over every card under NCCL, a rank
# each, in place of DP_WORLD gloo ranks on one card
# (the fsdp phase runs on the same corpus, DP_STEPS steps a mesh)
DP_PATIENTS, DP_SLICES = 4, 12
DP_W1_STEPS, DP_STEPS, DP_WORLD = 6, 4, 2
DP_METRIC_TOL = 1e-6
DP_KERNEL_METRIC_TOL, DP_KERNEL_PIXELS = 3e-5, 1
ALL_PHASES = ("kernels", "generator", "int8", "grad", "serving",
              "int8_serving", "training", "test", "stage2", "families",
              "infer", "export", "figures", "loop", "p3d", "corpus", "dp",
              "fsdp", "tp", "sp", "depth")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e!r}")
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(torch, got, want):
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if hasattr(t, "element_size"))


def as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


CONV_PEAKS = {"float32": (PEAK_F32, "f32 CUDA cores"),
              "bfloat16": (PEAK_BF16, "bf16 tensor cores")}


def kernel_cases(torch):
    """(kernel, case, fn, plain_fn, make_inputs, library_fn, flops[, spec]):
    the main paths' shapes; make_inputs(dtype) returns the keyword
    arguments, library_fn(kw) one PyTorch call of the same function on them
    (a yardstick only) and flops(kw) the case's operations. ``spec``
    overrides the tolerances (``out_tol``, ``stats_tol``) and the peak rate
    of each dtype (``peaks``: dtype -> (ops/s, label)), ``also`` adds
    (ops/s, label) bounds printed beside the case's own, ``dtypes`` keeps
    only those dtypes and ``repeat`` requires a second call on the same
    inputs to give the same bits."""
    import torch.nn.functional as F

    from ctagan_tpu_torch.ops import (
        fused_convt,
        fused_down,
        fused_resblock,
        fused_resblock_grad,
        fused_s8,
        pallas_kernels,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def normed(x):
        xf = x.float()
        mean = xf.mean(dim=(1, 2))
        rstd = torch.rsqrt(xf.var(dim=(1, 2)) + 1e-5)
        return torch.stack([mean, rstd], dim=1)

    def nchw(x):  # a channels-last NCHW view of an NHWC tensor
        return x.permute(0, 3, 1, 2)

    def oihw(w, dt):  # (3, 3, I, O) -> (O, I, 3, 3), channels last
        return w.permute(3, 2, 0, 1).to(dt).contiguous(
            memory_format=torch.channels_last)

    def conv_flops(n, h, w, c, co):
        return 2.0 * n * h * w * 9 * c * co

    def k1(variant, n=2, hw=128, c=256):
        def make(dt):
            x = randn(n, hw, hw, c).to(dt)
            kw = dict(x=x, w=randn(3, 3, c, c, scale=0.02),
                      b=randn(c, scale=0.1))
            if variant != "plain":
                kw["norm"] = normed(x)
            if variant in ("norm_relu", "emit_norm_relu"):
                kw["relu"] = True
            if variant == "norm_skip":
                kw["skip"] = randn(n, hw, hw, c).to(dt)
            if variant == "emit_norm_relu":
                kw["emit_input"] = True
            return kw
        return make

    def k1_lib(kw):
        w = oihw(kw["w"], kw["x"].dtype)
        b = kw["b"].to(kw["x"].dtype)
        return lambda: F.conv2d(nchw(kw["x"]), w, b, padding=1)

    def k3(c, co, n=2, hw=None, norm=True, offset=0.0):
        # offset: channel offsets of alternating sign, so the norm's mean is
        # far from 0 and relu((0 - mean) rstd) is too on half the channels
        def make(dt):
            h, wd = hw or ((512, 512) if c == 64 else (256, 256))
            x = randn(n, h, wd, c)
            if offset:
                x = x + offset * (torch.arange(c, device=dev) % 2 * 2 - 1)
            x = x.to(dt)
            kw = dict(x=x, w=randn(3, 3, c, co, scale=0.04),
                      b=randn(co, scale=0.1))
            if norm:
                kw.update(norm=normed(x), relu=True)
            return kw
        return make

    def k3_lib(kw):
        w = oihw(kw["w"], kw["x"].dtype)
        b = kw["b"].to(kw["x"].dtype)
        return lambda: F.conv2d(nchw(kw["x"]), w, b, stride=2, padding=1)

    def k2(c, co, prenorm, n=2, hw=None, offset=0.0):
        # offset: as k3's, so a normalized zero at the edge is far from 0
        def make(dt):
            h, wd = hw or ((128, 128) if c == 256 else (256, 256))
            x = randn(n, h, wd, c)
            if offset:
                x = x + offset * (torch.arange(c, device=dev) % 2 * 2 - 1)
            x = x.to(dt)
            kw = dict(x=x, kernel_t=randn(c, co, 3, 3, scale=0.03),
                      bias=randn(co, scale=0.1))
            if prenorm:
                kw.update(norm=normed(x), relu=True)
            return kw
        return make

    def k2_lib(kw):
        dt = kw["x"].dtype
        w = kw["kernel_t"].to(dt).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv_transpose2d(
            nchw(kw["x"]), w, kw["bias"].to(dt), stride=2, padding=1,
            output_padding=1)

    def k4(hw=128, c=256):
        def make(dt):
            return dict(g=randn(1, hw, hw, c).to(dt),
                        w=randn(3, 3, c, c, scale=0.02))
        return make

    def k4_lib(kw):
        g = kw["g"]
        w = oihw(kw["w"], g.dtype)
        return lambda: torch.nn.grad.conv2d_input(
            (g.shape[0], w.shape[1], g.shape[1], g.shape[2]), w, nchw(g),
            padding=1)

    def k4_flops(kw):
        n, h, wd, co = kw["g"].shape
        c = kw["w"].shape[2]
        # interior correlation + the 4 border lines (3 taps) and 4 corners
        return conv_flops(n, h, wd, co, c) + 2.0 * n * co * c * (
            3 * (2 * h + 2 * wd) + 4)

    def k5(variant, hw=128, c=256):
        def make(dt):
            x = randn(1, hw, hw, c).to(dt)
            kw = dict(x=x, g=randn(1, hw, hw, c).to(dt))
            if variant != "plain":
                kw.update(norm=normed(x), relu=True)
            if variant == "norm_relu_skip":
                kw["skip"] = randn(1, hw, hw, c).to(dt)
            return kw
        return make

    def k5_lib(kw):
        x, g = kw["x"], kw["g"]
        return lambda: torch.nn.grad.conv2d_weight(
            nchw(x), (g.shape[3], x.shape[3], 3, 3), nchw(g), padding=1)

    def x_flops(co_of):
        def flops(kw):
            n, h, w, c = kw["x"].shape
            return conv_flops(n, h, w, c, co_of(kw))
        return flops

    def down_flops(kw):
        n, h, w, c = kw["x"].shape
        return conv_flops(n, h // 2, w // 2, c, kw["w"].shape[3])

    def k7(mode, n=2, hw=(128, 128), c=256, cout=256, raw=torch.bfloat16):
        # dt is the output dtype; mode (i) takes the int8 trunk, mode (ii)
        # the chain's bf16 raw h1 (or f32 raw input) with its norm
        def make(dt):
            kw = dict(w_q=torch.randint(-127, 128, (3, 3, c, cout),
                                        generator=gen, device=dev,
                                        dtype=torch.int8),
                      w_scale=torch.rand(cout, generator=gen, device=dev)
                      * 1e-3 + 1e-4,
                      b=randn(cout, scale=0.1), out_dtype=dt)
            x = randn(n, *hw, c)
            if mode == "i":
                kw["x_scale"] = x.abs().amax() / 127.0
                kw["x"] = torch.round(x / kw["x_scale"]).to(torch.int8)
            else:
                kw["x"] = (x * 3.0 + 0.5).to(raw)
                kw["norm"] = normed(kw["x"])
            return kw
        return make

    def k7_lib(kw):  # the int8 GEMM alone, on a pre-unfolded matrix
        n, h, wd, c = kw["x"].shape
        cols = torch.randint(-127, 128, (n * h * wd, 9 * c), generator=gen,
                             device=dev, dtype=torch.int8)
        wmat = kw["w_q"].reshape(9 * c, -1).t().contiguous().t()  # faster
        return lambda: torch._int_mm(cols, wmat)

    def k6(shape, activation):
        def make(dt):
            return dict(x=(randn(*shape) * 2.0 + 0.5).to(dt),
                        activation=activation)
        return make

    def k6_lib(kw):
        return lambda: F.instance_norm(nchw(kw["x"]))

    def k6_flops(kw):  # sum, square-sum, subtract, multiply, activation
        return 5.0 * kw["x"].numel()

    r, d, t = fused_resblock, fused_down, fused_convt
    gr = fused_resblock_grad
    s8, pk = fused_s8, pallas_kernels
    k7_spec = {"out_tol": K7_OUT_TOL, "stats_tol": {"float32": 1e-4,
                                                    "bfloat16": 1e-4},
               "peaks": {dt: (PEAK_INT8, "int8 tensor cores")
                         for dt in CONV_PEAKS}}
    # K6 sums its statistics in a fixed order: a second call on the same
    # input must give the same bits
    k6_spec = {"out_tol": K6_OUT_TOL, "repeat": True,
               "peaks": {dt: (PEAK_F32, "f32 CUDA cores")
                         for dt in CONV_PEAKS}}
    # K1's, K2's, K3's, K4's and K5's f32 routes are three TF32 products on
    # the tensor cores (3xTF32)
    k1_spec = k2_spec = k3_spec = k4_spec = k5_spec = {
        "peaks": {"float32": (PEAK_TF32 / 3, "3 TF32 products, tensor cores"),
                  "bfloat16": CONV_PEAKS["bfloat16"]},
        "also": (CONV_PEAKS["float32"],)}
    k1_flops = x_flops(lambda kw: kw["w"].shape[3])
    k5_flops = x_flops(lambda kw: kw["g"].shape[3])
    return [
        ("conv3x3_reflect_stats", f"K1 {v} N=2 128^2x256->256",
         r.conv3x3_reflect_stats, r.conv3x3_reflect_stats_plain, k1(v),
         k1_lib, k1_flops, k1_spec)
        for v in ("norm_relu", "emit_norm_relu", "norm_skip", "plain")
    ] + [
        ("conv3x3_reflect_stats", "K1 norm_skip ragged N=1 40^2x256->256",
         r.conv3x3_reflect_stats, r.conv3x3_reflect_stats_plain,
         k1("norm_skip", n=1, hw=40), k1_lib, k1_flops, k1_spec),
        ("conv3x3_reflect_stats", "K1 norm_relu N=2 128^2x128->128",
         r.conv3x3_reflect_stats, r.conv3x3_reflect_stats_plain,
         k1("norm_relu", c=128), k1_lib, k1_flops, k1_spec),
    ] + [
        ("conv3x3_s2_zero_stats", case, d.conv3x3_s2_zero_stats,
         d.conv3x3_s2_zero_stats_plain, make, k3_lib, down_flops, k3_spec)
        for case, make in (
            ("K3 down1 N=2 64->128 512^2", k3(64, 128)),
            ("K3 down2 N=2 128->256 256^2", k3(128, 256)),
            ("K3 ragged N=1 72x104x64->128 (36x52 out)",
             k3(64, 128, n=1, hw=(72, 104))),
            ("K3 halo N=2 128^2x128->256 means +-1.5",
             k3(128, 256, hw=(128, 128), offset=1.5)),
            ("K3 no-norm N=1 256^2x64->128",
             k3(64, 128, n=1, hw=(256, 256), norm=False)))
    ] + [
        ("convt2x_stats", case, t.convt2x_stats, t.convt2x_stats_plain, make,
         k2_lib, x_flops(lambda kw: kw["kernel_t"].shape[1]), k2_spec)
        for case, make in (
            ("K2 up1 N=2 256->128 128^2", k2(256, 128, False)),
            ("K2 up2 N=2 128->64 256^2 norm", k2(128, 64, True)),
            ("K2 ragged N=1 36x52x256->128 (72x104 out)",
             k2(256, 128, False, n=1, hw=(36, 52))),
            ("K2 edge N=2 64^2x256->128 norm means +-1.5",
             k2(256, 128, True, hw=(64, 64), offset=1.5)),
            ("K2 up1 norm N=2 256->128 128^2", k2(256, 128, True)))
    ] + [
        ("conv3x3_input_grad", f"K4 N=1 {hw}^2x{c}->{c}",
         gr.conv3x3_input_grad, gr.conv3x3_input_grad_plain, k4(hw, c),
         k4_lib, k4_flops, k4_spec)
        for hw, c in ((128, 256), (40, 256), (128, 128))
    ] + [
        ("conv3x3_weight_grad", f"K5 {v} N=1 128^2x256->256",
         gr.conv3x3_weight_grad, gr.conv3x3_weight_grad_plain, k5(v), k5_lib,
         k5_flops, k5_spec)
        for v in ("norm_relu", "plain", "norm_relu_skip")
    ] + [
        ("conv3x3_weight_grad", "K5 norm_relu_skip ragged N=1 40^2x256->256",
         gr.conv3x3_weight_grad, gr.conv3x3_weight_grad_plain,
         k5("norm_relu_skip", hw=40), k5_lib, k5_flops, k5_spec),
        ("conv3x3_weight_grad", "K5 norm_relu N=1 128^2x128->128",
         gr.conv3x3_weight_grad, gr.conv3x3_weight_grad_plain,
         k5("norm_relu", c=128), k5_lib, k5_flops, k5_spec),
    ] + [
        ("conv3x3_reflect_s8", f"K7 mode ({m}) {shape} (dtype: out)",
         s8.conv3x3_reflect_s8, s8.conv3x3_reflect_s8_plain, make, k7_lib,
         x_flops(lambda kw: kw["w_q"].shape[3]), k7_spec)
        for m, shape, make in (
            ("i", "N=2 128^2x256->256", k7("i")),
            ("ii", "N=2 128^2x256->256", k7("ii")),
            ("ii", "N=16 128^2x256->256", k7("ii", n=16)),
            ("i", "N=2 128^2x128->128", k7("i", c=128, cout=128)),
            ("i", "ragged N=1 40^2x256->256", k7("i", n=1, hw=(40, 40))),
            ("ii", "ragged N=1 40^2x256->256", k7("ii", n=1, hw=(40, 40))),
            ("ii", "f32 raw N=2 128^2x256->256",
             k7("ii", raw=torch.float32)))
    ] + [
        ("instance_norm_pallas", f"K6 N=2 {h}^2x{c} {act}",
         pk.instance_norm_pallas, pk.instance_norm_pallas_plain,
         k6((2, h, h, c), act), k6_lib, k6_flops, k6_spec)
        for h, c, act in ((512, 64, "relu"), (128, 256, None),
                          (256, 128, "leaky_relu"))
    ] + [
        ("instance_norm_pallas", f"K6 {case}", pk.instance_norm_pallas,
         pk.instance_norm_pallas_plain, k6(shape, act), k6_lib, k6_flops,
         dict(k6_spec, dtypes=dts))
        for case, shape, act, dts in (
            ("int8 served N=16 512^2x64 relu", (16, 512, 512, 64), "relu",
             ("float32",)),
            ("int8 served N=16 128^2x256 relu", (16, 128, 128, 256), "relu",
             ("float32",)),
            ("layer route body N=1 128^2x256", (1, 128, 128, 256), None,
             ("bfloat16",)),
            ("ragged N=1 48x136x20 relu", (1, 48, 136, 20), "relu",
             ("float32", "bfloat16")),
            ("ragged N=1 48x136x36 leaky_relu", (1, 48, 136, 36),
             "leaky_relu", ("float32", "bfloat16")),
            ("ragged two-read N=1 512x520x20 relu", (1, 512, 520, 20),
             "relu", ("float32", "bfloat16")))
    ]


def bound_of(flops, moved, peak):
    """(bound ms, 'operations' or 'bytes'): the larger of the two times."""
    ops_ms, bytes_ms = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def check_kernels(torch, cases=None):
    """Phase 2: every kernel case vs its plain version, f32 and bf16.
    Returns {kernel: {...}}; the times and bound are those of the first
    case listed for the kernel, in f32. ``cases``: the kernels (K1..K7)
    whose cases run (all if None)."""
    results = {}
    for name, case, fn, plain, make, library, flops_of, *spec in (
            kernel_cases(torch)):
        if cases is not None and case.split()[0] not in cases:
            continue
        spec = spec[0] if spec else {}
        out_tol = spec.get("out_tol", OUT_TOL)
        stats_tol = spec.get("stats_tol", STATS_TOL)
        peaks = spec.get("peaks", CONV_PEAKS)
        labelled = sorted(set(peaks.values()) | set(spec.get("also", ())))
        for dt_name in spec.get("dtypes", ("float32", "bfloat16")):
            dt = getattr(torch, dt_name)
            kw = make(dt)
            got = as_tuple(fn(**kw))
            torch.cuda.synchronize()
            same = (torch.equal(as_tuple(fn(**kw))[0], got[0])
                    if spec.get("repeat") else True)
            want = as_tuple(plain(**kw))
            out_err = float((got[0].float() - want[0].float()).abs().max())
            out_rel = rel_err(torch, got[0], want[0])
            st_rel = (float((got[1] - want[1]).abs().max()
                            / want[1].abs().max().clamp_min(1.0))
                      if len(got) > 1 else 0.0)
            xn_rel = rel_err(torch, got[2], want[2]) if len(got) == 3 else 0.0
            ms = cuda_ms(torch, lambda: fn(**kw))
            plain_ms = cuda_ms(torch, lambda: plain(**kw))
            library_ms = cuda_ms(torch, library(kw))
            flops = flops_of(kw)
            moved = nbytes(*kw.values()) + nbytes(*got)
            bound_ms, bound_by = bound_of(flops, moved, peaks[dt_name][0])
            others = "; ".join(
                f"{label} {bound_of(flops, moved, pk)[0]:.3f} ms"
                for pk, label in labelled if label != peaks[dt_name][1])
            rep = f"; repeat bit-equal {same}" if spec.get("repeat") else ""
            ok = (same and out_rel <= out_tol[dt_name]
                  and xn_rel <= out_tol[dt_name]
                  and st_rel <= stats_tol[dt_name]
                  and got[0].dtype == want[0].dtype and bool(torch.isfinite(
                      got[0].float()).all()))
            print(f"kernel {case} {dt_name}: out max_abs_err {out_err:.3e} "
                  f"(scaled {out_rel:.3e}, tol {out_tol[dt_name]:.3e}), "
                  f"x_new scaled err {xn_rel:.3e}, stats rel err "
                  f"{st_rel:.3e} (tol {stats_tol[dt_name]:.0e}){rep}; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
                  f"{library_ms:.3f} ms; {flops / 1e9:.2f} G ops, "
                  f"{moved / 1e6:.1f} MB: bound {bound_ms:.3f} ms by "
                  f"{bound_by} ({peaks[dt_name][1]}"
                  f"{'; ' + others if others else ''}), kernel at "
                  f"{flops / ms / 1e9:.1f} T ops/s -> "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"{case} {dt_name} disagrees with its plain version")
            entry = results.setdefault(name, {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms})
            entry["max_abs_err"] = max(entry["max_abs_err"], out_err)
            del kw, got, want
    return results


def check_k5_operands(torch):
    """K5's B operand written by its one-pass kernel (``k5_operands`` on a
    CUDA tensor) against the plain version on the same g: the same
    roundings, so bit-equal; at the body's shape and a ragged two-sample
    one whose pixel pad is zeros."""
    from ctagan_tpu_torch.ops.fused_resblock_grad import (
        k5_operands,
        k5_operands_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in ((1, 128, 128, 256), (2, 40, 40, 128)):
        g = torch.randn(*shape, generator=gen, device="cuda") * 3.0
        for dt in (torch.float32, torch.bfloat16):
            got, want = k5_operands(g, dt), k5_operands_plain(g, dt)
            same = all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, want))
            print(f"K5 operands {shape} {dt}: kernel == plain {same}",
                  flush=True)
            if not same:
                fail(f"K5's operands kernel {shape} {dt} differs from plain")


def time_wrapper_parts(torch, cases=None):
    """K4 at the training body's (1, 128, 128, 256) -> 256, K3 at the
    serving path's down1 (2, 512, 512, 64) -> 128 and K2 at its up1 (2,
    128, 128, 256) -> 128 and up2 (2, 256, 256, 128) -> 64 with a norm, f32
    and bf16; K7 at the int8 body's (2, 128, 128, 256) -> 256 in both input
    modes, f32 and bf16 out: the kernel alone on a built B operand (CUDA
    events, beside its bound and its grid), and one wrapper call's device
    time by kernel (``torch.profiler``, 5 calls: B's build, the kernel, and
    for K4 the f32 cast, reflect folds and rounding, for K7 the combined
    scale) beside the host's time to enqueue it. ``cases``: the kernels to
    time (all if None)."""
    from ctagan_tpu_torch.ops import fused_convt as t
    from ctagan_tpu_torch.ops import fused_down as d
    from ctagan_tpu_torch.ops import fused_resblock_grad as gr
    from ctagan_tpu_torch.ops import fused_s8 as s8
    from ctagan_tpu_torch.ops.fused_resblock import k1_weight

    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def normed(x):
        return torch.stack([x.mean(dim=(1, 2)),
                            torch.rsqrt(x.var(dim=(1, 2)) + 1e-5)], dim=1)

    w4 = randn(3, 3, 256, 256, scale=0.02)
    g4 = randn(1, 128, 128, 256)
    x3, w3 = randn(2, 512, 512, 64), randn(3, 3, 64, 128, scale=0.04)
    b3 = randn(128, scale=0.1)
    norm3 = normed(x3)
    ups = {}
    for stage, (h, c, co) in (("up1", (128, 256, 128)),
                              ("up2", (256, 128, 64))):
        x2 = randn(2, h, h, c)
        ups[stage] = (x2, randn(c, co, 3, 3, scale=0.03),
                      randn(co, scale=0.1), normed(x2) if co == 64 else None)

    def grid(dt, n, pixels, cout, chunks, phases=1):
        """(blocks, tile, K chunks per block): the body's 128-pixel tiles;
        bf16 256 wide where Cout allows, else 128, else 64 (K2: its two
        column phases paired in one 128-wide tile, two row phases)."""
        widths = ((256,) if dt == torch.bfloat16 else ()) + (128, 64)
        bn = next(b for b in widths if cout % b == 0)
        tile = f"128 x {bn}"
        if bn == 64 and phases == 4:
            tile, phases, chunks = "128 x 2x64", 2, (chunks[1], 2 * chunks[1])
        blocks = n * -(-pixels // 128) * (cout // bn) * phases
        per = 128 // dt.itemsize  # channels per 128-byte K chunk
        return blocks, tile, "/".join(str(k // per) for k in chunks)

    def k4(dt):
        g = g4.to(dt)
        b = gr.k4_weight(w4, dt)
        n, h, wd, cout = g.shape
        c = w4.shape[2]
        return dict(shape=f"N=1 {h}^2x{cout}->{c}", n=n, pixels=h * wd,
                    cout=c, k=9 * cout,
                    grid=grid(dt, n, h * wd, c, (9 * cout,)),
                    kernel=lambda: gr._corr3x3_zero_kernel(g, *b),
                    call=lambda: gr.conv3x3_input_grad(g, w4),
                    moved=nbytes(g, *b) + n * h * wd * c * g.element_size())

    def k3(dt):
        x = x3.to(dt)
        b = k1_weight(w3, dt)
        n, h, wd, c = x.shape
        cout = w3.shape[3]
        pixels = (h // 2) * (wd // 2)
        return dict(shape=f"down1 N={n} {h}^2x{c}->{cout}", n=n,
                    pixels=pixels, cout=cout, k=9 * c,
                    grid=grid(dt, n, pixels, cout, (9 * c,)),
                    kernel=lambda: d._k3_kernel(x, *b, b3, norm3, True),
                    call=lambda: d.conv3x3_s2_zero_stats(x, w3, b3, norm3,
                                                         True),
                    moved=nbytes(x, *b) + n * pixels * cout
                    * x.element_size())

    def k2(stage):
        def parts(dt):
            x2, kt, b2, norm2 = ups[stage]
            x = x2.to(dt)
            b = t.k2_weight(kt, dt)
            n, h, wd, c = x.shape
            cout = kt.shape[1]
            relu = norm2 is not None
            # the input grid per phase; the phases' 1, 2, 2, 4 taps sum to 9
            return dict(shape=f"{stage} N={n} {h}^2x{c}->{cout}"
                        f"{' norm' if relu else ''}", n=n, pixels=h * wd,
                        cout=cout, k=9 * c,
                        grid=grid(dt, n, h * wd, cout,
                                  [taps * c for taps in (1, 2, 2, 4)],
                                  phases=4),
                        kernel=lambda: t._k2_kernel(x, *b, b2, norm2, relu),
                        call=lambda: t.convt2x_stats(x, kt, b2, norm2, relu),
                        moved=nbytes(x, *b) + n * 4 * h * wd * cout
                        * x.element_size())
        return parts

    def k7(mode):
        # N=2, the int8 body's (2, 128, 128, 256) -> 256; dt is the output
        # dtype, the input the int8 trunk (i) or the chain's bf16 h1 (ii)
        def parts(dt):
            x = x7[mode]
            wk = s8.k7_weight(w7)
            n, h, wd, c = x.shape
            cout = w7.shape[3]
            norm = norm7 if mode == "ii" else None
            x_scale = xs7 if mode == "i" else None
            scale = s8._combined_scale(ws7, x_scale, 8.0)
            blocks = n * -(-h // 8) * -(-wd // 16) * (cout // 256)
            return dict(shape=f"mode ({mode}) N={n} {h}^2x{c}->{cout} "
                        "(dtype: out)", n=n, pixels=h * wd,
                        cout=cout, k=9 * c,
                        grid=(blocks, "(8 x 16 pixels) x 256",
                              str(9 * c // 128)),
                        kernel=lambda: s8._k7_kernel(x, wk, scale, b7, norm,
                                                     8.0, dt),
                        call=lambda: s8.conv3x3_reflect_s8(
                            x, w7, ws7, b7, x_scale=x_scale, norm=norm,
                            out_dtype=dt),
                        moved=nbytes(x, wk) + n * h * wd * cout
                        * dt.itemsize)
        return parts

    w7 = torch.randint(-127, 128, (3, 3, 256, 256), generator=gen,
                       device="cuda", dtype=torch.int8)
    ws7 = torch.rand(256, generator=gen, device="cuda") * 1e-3 + 1e-4
    b7 = randn(256, scale=0.1)
    x7f = randn(2, 128, 128, 256)
    xs7 = x7f.abs().amax() / 127.0
    x7 = {"i": torch.round(x7f / xs7).to(torch.int8),
          "ii": (x7f * 3.0 + 0.5).to(torch.bfloat16)}
    norm7 = normed(x7["ii"].float())

    conv_dts = (("float32", (PEAK_TF32 / 3, "3 TF32 products")),
                ("bfloat16", CONV_PEAKS["bfloat16"]))
    int8_dts = tuple((d, (PEAK_INT8, "int8 tensor cores"))
                     for d in ("float32", "bfloat16"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, parts, dts in (
            ("K4", k4, conv_dts), ("K3", k3, conv_dts),
            ("K2", k2("up1"), conv_dts), ("K2", k2("up2"), conv_dts),
            ("K7", k7("i"), int8_dts), ("K7", k7("ii"), int8_dts)):
        if cases is not None and name not in cases:
            continue
        for dt_name, (peak, label) in dts:
            dt = getattr(torch, dt_name)
            q = parts(dt)
            flops = 2.0 * q["n"] * q["pixels"] * q["cout"] * q["k"]
            bound_ms, bound_by = bound_of(flops, q["moved"], peak)
            kernel_ms = cuda_ms(torch, q["kernel"])
            blocks, tile, chunks = q["grid"]
            print(f"{name} {dt_name} {q['shape']}: kernel alone "
                  f"{kernel_ms:.3f} ms (bound {bound_ms:.3f} ms by "
                  f"{bound_by}, {label}; {flops / kernel_ms / 1e9:.1f} T "
                  f"ops/s; {blocks} blocks of {tile}, {blocks / sms:.2f} "
                  f"waves on {sms} SMs, {chunks} K chunks each); "
                  + one_call(torch, q["call"]), flush=True)


def one_call(torch, call, reps=5):
    """One call's device time by kernel (``torch.profiler`` over ``reps``
    calls) beside the host's time to enqueue it (10 calls), as text."""
    cuda = torch.autograd.DeviceType.CUDA
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            k, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (k + 1, us + e.time_range.elapsed_us())
    device_ms = sum(us for _, us in by_name.values()) / reps / 1e3
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return (f"one wrapper call: device {device_ms:.3f} ms in "
            f"{sum(k for k, _ in by_name.values()) // reps} kernels, host "
            f"enqueue {host_ms:.3f} ms; largest: "
            + "; ".join(f"{kn[:60]} x{k // reps} {us / reps / 1e3:.4f} ms"
                        for kn, (k, us) in top))


def time_k6(torch):
    """K6 at the int8 forward's norm shapes (N=2 in f32 and bf16, the
    served N=16 in f32) and the layer route's body (N=1 bf16): its route
    (``k6_plan_for``: group, cluster or chunks, band, active clusters), the
    kernel alone on a built plan and output (CUDA events), one wrapper
    call's device time by kernel beside the host's enqueue time, and the
    bounds of one read and of two reads."""
    from ctagan_tpu_torch.ops import pallas_kernels as pk

    gen = torch.Generator(device="cuda").manual_seed(6)
    for shape, act, dts in (((2, 512, 512, 64), "relu", ("float32",
                                                          "bfloat16")),
                            ((2, 128, 128, 256), None, ("float32",
                                                        "bfloat16")),
                            ((2, 256, 256, 128), "leaky_relu",
                             ("float32", "bfloat16")),
                            ((16, 512, 512, 64), "relu", ("float32",)),
                            ((16, 128, 128, 256), "relu", ("float32",)),
                            ((1, 128, 128, 256), None, ("bfloat16",))):
        for dt_name in dts:
            x = (torch.randn(*shape, generator=gen, device="cuda") * 2.0
                 + 0.5).to(getattr(torch, dt_name))
            out = torch.empty_like(x)
            plan = pk.k6_plan_for(x)
            active = (pk.k6_active_clusters(x, plan)
                      if plan.route == "cluster" else "-")
            kernel_ms = cuda_ms(torch, lambda: pk._k6_launch(
                x, out, plan, 1e-5, act))
            one = nbytes(x) / PEAK_BYTES * 1e3
            blocks = shape[0] * plan.groups(shape[3]) * plan.chunks
            print(f"K6 {dt_name} N={shape[0]} {shape[1]}x{shape[2]}x"
                  f"{shape[3]} {act}: route {plan.route} (vec {plan.vec}, "
                  f"group {plan.group}, cluster {plan.cluster}, band "
                  f"{plan.band} px, {blocks} blocks of {plan.threads}, smem "
                  f"{plan.smem} B, active clusters {active}); kernel alone "
                  f"{kernel_ms:.4f} ms (bound one read {2 * one:.4f} ms, "
                  f"two reads {3 * one:.4f} ms: {2 * one / kernel_ms:.0%} "
                  f"of the first); "
                  + one_call(torch, lambda: pk.instance_norm_pallas(
                      x, activation=act)), flush=True)
            del x, out


def _counted():
    from ctagan_tpu_torch.ops import (
        fused_convt,
        fused_down,
        fused_resblock,
        fused_resblock_grad,
        fused_s8,
        pallas_kernels,
    )

    return {
        "conv3x3_reflect_stats": fused_resblock.conv3x3_reflect_stats,
        "conv3x3_s2_zero_stats": fused_down.conv3x3_s2_zero_stats,
        "convt2x_stats": fused_convt.convt2x_stats,
        "conv3x3_input_grad": fused_resblock_grad.conv3x3_input_grad,
        "conv3x3_weight_grad": fused_resblock_grad.conv3x3_weight_grad,
        "instance_norm_pallas": pallas_kernels.instance_norm_pallas,
        "conv3x3_reflect_s8": fused_s8.conv3x3_reflect_s8,
    }


def launch_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def counts_of(**nonzero):
    """Expected counts: the named kernels, every other one 0."""
    return {name: nonzero.get(name, 0) for name in _counted()}


PER_FORWARD = counts_of(conv3x3_reflect_stats=18, conv3x3_s2_zero_stats=2,
                        convt2x_stats=2)
PER_TRAIN_STEP = counts_of(conv3x3_reflect_stats=36, conv3x3_input_grad=18,
                           conv3x3_weight_grad=18)
# CycleGAN: four differentiated generator forwards (G_A2B(a), G_B2A(b) and
# the two cycles) and no re-forward: the Ds train on the pools' fakes
PER_CYC_STEP = counts_of(conv3x3_reflect_stats=72, conv3x3_input_grad=72,
                         conv3x3_weight_grad=72)
# grad_accum 2 (batchSize 2): those per microbatch, plus one no-grad forward
# of each generator over the whole batch for the pools
PER_CYC_ACCUM2_STEP = counts_of(conv3x3_reflect_stats=2 * 72 + 2 * 18,
                                conv3x3_input_grad=2 * 72,
                                conv3x3_weight_grad=2 * 72)
# the training route's generator forward without grad (validation, the live
# panel): the body's 18 K1
PER_EVAL_FORWARD = counts_of(conv3x3_reflect_stats=18)
# int8 forward with the InstanceNorm switch on: 2 K7 per residual block; K6
# after the head, the two downs and the two ups
PER_INT8_FORWARD = counts_of(conv3x3_reflect_s8=18, instance_norm_pallas=5)


def psnr(a, b):
    """PSNR over the [-1, 1] range (peak 2)."""
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))


@contextlib.contextmanager
def plain_versions():
    """K7 and K6 swapped for their plain versions inside the block: the
    module attributes through which the int8 forward reaches them."""
    from ctagan_tpu_torch.ops import fused_s8, pallas_kernels

    saved = fused_s8.conv3x3_reflect_s8, pallas_kernels.instance_norm_pallas
    fused_s8.conv3x3_reflect_s8 = fused_s8.conv3x3_reflect_s8_plain
    pallas_kernels.instance_norm_pallas = (
        pallas_kernels.instance_norm_pallas_plain)
    try:
        yield
    finally:
        fused_s8.conv3x3_reflect_s8, pallas_kernels.instance_norm_pallas = saved


@contextlib.contextmanager
def pallas_norm_switch(on=True):
    """``models.layers.USE_PALLAS_INSTANCE_NORM`` set inside the block, as a
    deployment that sets JAX's switch would run the int8 forward."""
    from ctagan_tpu_torch.models import layers

    layers.USE_PALLAS_INSTANCE_NORM = on
    try:
        yield
    finally:
        layers.USE_PALLAS_INSTANCE_NORM = False


def check_generator(torch, card):
    """Phase 3: full-width generator, serving kernel route vs plain route."""
    from ctagan_tpu_torch.models import Generator

    dev = torch.device("cuda")
    g = Generator(1, 1, n_residual_blocks=9, base_features=64)
    g = g.reset_parameters(0).to(dev).eval()
    n_params = sum(p.numel() for p in g.parameters())
    if n_params != 11_365_633:
        fail(f"generator has {n_params} parameters, expected 11,365,633")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(2, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        reset_counts()
        y = g(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != PER_FORWARD:
            fail(f"launches per forward {counts}, expected {PER_FORWARD}")
        g.fused_body = False
        y_plain = g(x)
        g.fused_body = True
    err = float((y.float() - y_plain.float()).abs().max())
    finite = bool(torch.isfinite(y).all())
    print(f"generator 9 blocks base 64 ({n_params} params) 512^2 b=2 f32: "
          f"kernel route vs plain route max_abs_err {err:.3e} (tol "
          f"{GEN_TOL:.0e}); launches per forward {counts}; finite {finite}",
          flush=True)
    if y.shape != (2, 512, 512, 1) or not finite or err > GEN_TOL:
        fail("generator kernel route disagrees with the plain route")
    for dt_name in ("float32", "bfloat16"):
        gd = Generator(1, 1, dtype=getattr(torch, dt_name))
        gd.load_state_dict(g.state_dict())
        gd = gd.to(dev).eval()
        for b in (1, 16):
            xb = torch.rand(b, 512, 512, 1, generator=gen, device=dev) * 2 - 1
            times = {}
            with torch.inference_mode():
                for route in ("plain", "kernels", "kernels", "plain"):
                    gd.fused_body = route == "kernels"
                    ms = cuda_ms(torch, lambda: gd(xb), iters=3, warmup=1)
                    times.setdefault(route, []).append(ms)
            print(f"generator forward {dt_name} 512^2 b={b}: kernel route "
                  f"{min(times['kernels']):.2f} ms, plain route "
                  f"{min(times['plain']):.2f} ms (best of 2 turns x 3 "
                  f"iters) [{card}]", flush=True)


def check_int8_generator(torch, card):
    """Phase 4: the full-width generator quantized, int8 forward through
    K7/K6 vs the same forward through their plain versions and vs the f32
    plain route, at 512² b=2; forward times at b=1 and b=16."""
    import numpy as np

    from ctagan_tpu_torch.models import Generator
    from ctagan_tpu_torch.ops.quantize import (
        generator_int8_forward,
        quantize_generator,
        quantized_size_bytes,
    )

    dev = torch.device("cuda")
    g = Generator(1, 1).reset_parameters(0).to(dev).eval()
    qp = quantize_generator(g)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(2, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        with pallas_norm_switch():
            reset_counts()
            y = generator_int8_forward(qp, x)
            torch.cuda.synchronize()
            counts = launch_counts()
            with plain_versions():
                y_plain = generator_int8_forward(qp, x)
                torch.cuda.synchronize()
            plain_counts = launch_counts()
        g.fused_body = False
        y_f32 = g(x)
        g.fused_body = True
    y, y_plain, y_f32 = (t.float().cpu().numpy() for t in (y, y_plain, y_f32))
    err = np.abs(y - y_plain)
    p_k, p_p = psnr(y, y_f32), psnr(y_plain, y_f32)
    finite = bool(np.isfinite(y).all())
    p_kp = psnr(y, y_plain)
    f32_mean = float(np.abs(y_plain - y_f32).mean())
    print(f"int8 generator ({quantized_size_bytes(qp) / 1e6:.2f} MB of "
          f"weights) 512^2 b=2: K7/K6 route vs plain versions max_abs_err "
          f"{err.max():.3e} (tol {INT8_MAX_TOL}), mean {err.mean():.3e} (tol "
          f"{INT8_MEAN_TOL}), PSNR {p_kp:.2f} dB (min {p_p:.2f} + "
          f"{INT8_PSNR_MARGIN} dB); plain versions vs the f32 plain route "
          f"mean {f32_mean:.3e}, PSNR {p_p:.2f} dB (K7/K6 route {p_k:.2f} "
          f"dB); min {INT8_PSNR_MIN} dB; launches per forward {counts}; "
          f"finite {finite}", flush=True)
    if y.shape != (2, 512, 512, 1) or not finite:
        fail("int8 generator: bad output")
    if counts != PER_INT8_FORWARD or plain_counts != counts:
        fail(f"int8 launches per forward {counts} (then {plain_counts} after "
             f"the plain versions), expected {PER_INT8_FORWARD}")
    if (err.max() > INT8_MAX_TOL or err.mean() > INT8_MEAN_TOL
            or p_kp < p_p + INT8_PSNR_MARGIN
            or min(p_k, p_p) < INT8_PSNR_MIN):
        fail("int8 generator disagrees with its plain versions or the f32 "
             "route")
    for b in (1, 16):
        xb = torch.rand(b, 512, 512, 1, generator=gen, device=dev) * 2 - 1
        times = {}
        with torch.inference_mode(), pallas_norm_switch():
            for route in ("int8", "f32 kernels", "f32 kernels", "int8"):
                fwd = ((lambda: generator_int8_forward(qp, xb))
                       if route == "int8" else (lambda: g(xb)))
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(torch, fwd, iters=3, warmup=1)
                times.setdefault(route, []).append(
                    (ms, torch.cuda.max_memory_allocated() / 1e9))
        best = {k: min(v) for k, v in times.items()}
        print(f"generator forward 512^2 b={b}: int8 route (K7 + K6) "
              f"{best['int8'][0]:.2f} ms (peak {best['int8'][1]:.2f} GB), "
              f"f32 kernel route (K1-K3) {best['f32 kernels'][0]:.2f} ms "
              f"(peak {best['f32 kernels'][1]:.2f} GB) (best of 2 turns x 3 "
              f"iters) [{card}]", flush=True)
    del g, qp
    torch.cuda.empty_cache()


def check_generator_grad(torch, card):
    """Phase 5: the generator's training route (FusedChainFunction) vs the
    plain layer route, output and every gradient, at 512² b=1 f32."""
    from ctagan_tpu_torch.models import Generator

    dev = torch.device("cuda")
    g = Generator(1, 1, fused_body=False, fused_body_grad=True)
    g = g.reset_parameters(0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand(1, 512, 512, 1, generator=gen, device=dev) * 2 - 1
    cot = torch.randn(1, 512, 512, 1, generator=gen, device=dev)
    reset_counts()
    y = g(x)
    torch.cuda.synchronize()
    fwd = launch_counts()
    (y * cot).sum().backward()
    torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in launch_counts().items()}
    grads = [p.grad.detach().clone() for p in g.parameters()]
    g.zero_grad(set_to_none=True)
    g.fused_body_grad = False
    y_plain = g(x)
    (y_plain * cot).sum().backward()
    out_err = float((y - y_plain).abs().detach().max())
    grads_p = [p.grad.detach().clone() for p in g.parameters()]
    g64 = g.double()  # the plain route in float64: both routes' yardstick
    g64.zero_grad(set_to_none=True)
    (g64(x.double()) * cot.double()).sum().backward()
    floor = GRAD_FLOOR * max(float(p.grad.norm()) for p in g64.parameters())
    errs = {}  # name -> (kernel route, plain route) error vs float64
    for (name, p), gk, gp in zip(g64.named_parameters(), grads, grads_p):
        den = max(float(p.grad.norm()), floor)
        errs[name] = (float((gk.double() - p.grad).norm()) / den,
                      float((gp.double() - p.grad).norm()) / den)
    over = [n for n, (e_k, e_p) in errs.items()
            if e_k > GRAD_RATIO * e_p + GRAD_TOL]
    top = max(errs, key=lambda n: errs[n][0])
    finite = all(bool(torch.isfinite(t).all()) for t in grads)
    print(f"generator training route 512^2 b=1 f32: output max_abs_err "
          f"{out_err:.3e} (tol {GEN_TOL:.0e}); gradient errors vs a float64 "
          f"plain run (Frobenius, relative): largest {top} kernel route "
          f"{errs[top][0]:.3e}, plain route {errs[top][1]:.3e}; over the "
          f"limit ({GRAD_RATIO:g} x plain + {GRAD_TOL:.0e}): {over or 'none'}"
          f"; launches forward {fwd}, backward {bwd}; finite {finite}",
          flush=True)
    if out_err > GEN_TOL or over or not finite:
        fail("generator training route disagrees with the plain route")
    if fwd != counts_of(conv3x3_reflect_stats=18) or bwd != counts_of(
            conv3x3_input_grad=18, conv3x3_weight_grad=18):
        fail("training route: expected 18 K1 per forward, 18 K4 and 18 K5 "
             "per backward")
    del g, g64, grads, grads_p, y, y_plain
    torch.cuda.empty_cache()


def _stand_in_checkpoint(save_root, seed=INFER_SEED):
    """A trained G's stand-in, seeded ``seed`` (by default not the config's
    seed) and saved as a port checkpoint of HD stage 1 in ``save_root``,
    where only the entry point's checkpoint lookup finds it; returns (G,
    path)."""
    from ctagan_tpu_torch.models import Generator
    from ctagan_tpu_torch.utils.checkpoint import save_checkpoint

    g = Generator(1, 1).reset_parameters(seed)
    return g, save_checkpoint(save_root, "HdGan_hd1", 3, {
        "state": {"g": g.state_dict()}, "epoch": 3, "lr": 1e-4, "lr_d": 1e-4})


def _served_generator(torch, config, stand_in_seed):
    """``__main__.serving_generator``, the builder of ``--mode serve``, on
    the card with ``save_root`` a temporary directory: holding
    :func:`_stand_in_checkpoint`'s file seeded ``stand_in_seed``, which the
    lookup must load, or empty (None), which leaves the seeded G."""
    from ctagan_tpu_torch.__main__ import serving_generator

    with tempfile.TemporaryDirectory() as tmp:
        config.save_root = f"{tmp}/model/"
        want, ckpt = ((None, None) if stand_in_seed is None else
                      _stand_in_checkpoint(config.save_root, stand_in_seed))
        g, found = serving_generator(config, torch.device("cuda"))
    if found != ckpt:
        fail(f"serve's lookup loaded {found}, expected {ckpt}")
    if want is not None and not _equal_state(_snapshot(g),
                                             _snapshot(want)):
        fail(f"the served G is not {os.path.basename(ckpt)}'s")
    if not g.fused_body:
        fail("serving_generator left fused_body off")
    return g


def _post(port, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesize", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def check_serving(torch, card, quantize=""):
    """Phase 6, a main path: the port's HTTP server on HdGan.yaml. With
    ``quantize="int8"`` (phase 7, a main path of its own) the config copy
    sets ``serve_quantize: int8``, the service runs the int8 forward with
    the InstanceNorm switch on, and every response is held to the f32 plain
    route by the JAX int8 service's bound. The generator is the one the
    serve entry point builds: :func:`_served_generator` on a stand-in
    checkpoint that only the lookup finds, seeded ``INFER_SEED`` for f32;
    int8 keeps the config's seed, the weights its bound was set on."""
    import numpy as np

    from ctagan_tpu_torch.data.dicom import (
        dicom_bytes,
        make_ct_slice,
        read_dicom,
    )
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
    from ctagan_tpu_torch.data.native import dual_window_native
    from ctagan_tpu_torch.serving.server import serve_async
    from ctagan_tpu_torch.utils.config import load_config

    path = os.path.join(REPO, "configs", "HdGan.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        if quantize:  # the config a deployment writes: serve_quantize: int8
            with open(path) as f:
                text = f.read() + f"\nserve_quantize: {quantize}\n"
            path = os.path.join(tmp, "HdGan_int8.yaml")
            with open(path, "w") as f:
                f.write(text)
        config = load_config(path)
    if config.serve_quantize != quantize:
        fail(f"serve_quantize read as {config.serve_quantize!r}")
    dev = torch.device("cuda")
    g = _served_generator(torch, config,
                          config.seed if quantize else INFER_SEED)
    rng = np.random.default_rng(config.seed)
    slices = [make_ct_slice(synthetic_ct_pixels(rng, config.size))
              for _ in range(N_REQUESTS)]
    bodies = [dicom_bytes(ds) for ds in slices]
    with pallas_norm_switch(bool(quantize)):
        reset_counts()
        server, service, port = serve_async(
            g, size=config.size, max_batch=config.max_batch,
            quantize=config.serve_quantize,
            channels=config.input_nc * config.context_slices)
        try:
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as ex:
                replies = list(ex.map(lambda b: _post(port, b), bodies))
            wall = time.perf_counter() - t0
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            service.stop()
            torch.cuda.synchronize()
    counts = launch_counts()
    served = [read_dicom(body) for status, body in replies if status == 200]
    if len(served) != N_REQUESTS:
        fail(f"{N_REQUESTS - len(served)} requests were not answered 200")
    for ds_in, ds in zip(slices, served):
        px = ds.pixel_array().astype(np.float64)
        if px.shape != (config.size, config.size):
            fail(f"response shape {px.shape}")
        if ds.series_instance_uid == ds_in.series_instance_uid:
            fail("response kept the request's SeriesInstanceUID")
        if not (np.isfinite(px).all() and px.min() >= 0 and px.max() <= 4095):
            fail("response pixels outside [0, 4095]")
    # the responses against the plain layer route on the same inputs: the
    # first one (f32) or all of them (int8, whose per-tensor scales depend
    # on which slices share a batch)
    refs = slices[:N_REQUESTS if quantize else 1]
    full = np.stack([dual_window_native(ds.pixel_array())[1] for ds in refs])
    with torch.inference_mode():
        g.fused_body = False
        ref = g(torch.from_numpy(full[..., None]).to(dev))
        g.fused_body = True
    ref_px = (ref[..., 0].float().cpu().numpy() + 1.0) * 0.5 * 4095.0
    px = np.stack([ds.pixel_array() for ds in served[:len(refs)]]).astype(
        np.float64)
    px_err = float(np.abs(px - ref_px).max())
    got11, ref11 = px / 4095.0 * 2.0 - 1.0, ref_px / 4095.0 * 2.0 - 1.0
    per_slice = np.abs(got11 - ref11).mean(axis=(1, 2))
    px_mean, px_psnr = float(per_slice.max()), psnr(got11, ref11)
    if health.get("status") != "ok" or health.get("quantize") != (
            quantize or None):
        fail(f"/healthz: {health}")
    forwards = health["batches_served"] + 1  # + the warm-up forward
    per_forward = PER_INT8_FORWARD if quantize else PER_FORWARD
    expect = {k: v * forwards for k, v in per_forward.items()}
    check = (f"mean |error| per slice over [-1, 1] largest {px_mean:.4f} "
             f"(tol {INT8_SERVED_MEAN_TOL}), average {per_slice.mean():.4f}; "
             f"PSNR over the {len(refs)} slices {px_psnr:.2f} dB"
             if quantize else f"max_abs_err {px_err:.2f} (tol {PIXEL_TOL})")
    print(f"serving {config.name} size {config.size}"
          f"{' int8' if quantize else ''}: {N_REQUESTS} concurrent "
          f"requests answered 200 with valid DICOM in {wall:.3f} s "
          f"({N_REQUESTS / wall:.2f} slices/s over this liveness window, not "
          f"a throughput; {health['batches_served']} batches, p50 batch "
          f"{health['p50_batch_ms']:.1f} ms); pixels vs the f32 plain route "
          f"{check}; launches {counts} [{card}]", flush=True)
    if ((px_mean > INT8_SERVED_MEAN_TOL) if quantize
            else (px_err > PIXEL_TOL)):
        fail("served pixels disagree with the plain route")
    if counts != expect:
        fail(f"main-path launches {counts}, expected {expect}")
    return counts


def check_zero_pad_serving(torch, card, norm_switch=False):
    """``configs/HdGan_fast.yaml`` (bf16, ``pad_mode: zero``) built by the
    serve entry point's ``serving_generator`` (``fused_body`` on; an empty
    ``save_root``, so seeded) and served:
    the generator's layer route, as JAX's ``chain_ok`` leaves zero pad out of
    its fused body; no kernel launches. With ``norm_switch`` JAX's
    ``USE_PALLAS_INSTANCE_NORM`` is on while it serves: all 23 of the
    generator's InstanceNorms run K6 (23 launches per forward), and each
    response is held to the switch-off forward by the same bound."""
    import numpy as np

    from ctagan_tpu_torch.data.dicom import (
        dicom_bytes,
        make_ct_slice,
        read_dicom,
    )
    from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
    from ctagan_tpu_torch.data.native import dual_window_native
    from ctagan_tpu_torch.serving.server import serve_async
    from ctagan_tpu_torch.utils.config import load_config

    config = load_config(os.path.join(REPO, "configs", "HdGan_fast.yaml"))
    if config.pad_mode != "zero":
        fail(f"HdGan_fast.yaml pad_mode read as {config.pad_mode!r}")
    dev = torch.device("cuda")
    g = _served_generator(torch, config, None)
    rng = np.random.default_rng(config.seed)
    slices = [make_ct_slice(synthetic_ct_pixels(rng, config.size))
              for _ in range(ZERO_PAD_REQUESTS)]
    with pallas_norm_switch(norm_switch):
        reset_counts()
        server, service, port = serve_async(
            g, size=config.size, max_batch=config.max_batch,
            quantize=config.serve_quantize,
            channels=config.input_nc * config.context_slices)
        try:
            with concurrent.futures.ThreadPoolExecutor(len(slices)) as ex:
                replies = list(ex.map(
                    lambda ds: _post(port, dicom_bytes(ds)), slices))
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            service.stop()
            torch.cuda.synchronize()
    counts = launch_counts()
    # + the warm-up forward
    expect = counts_of(instance_norm_pallas=ZERO_PAD_NORMS * (
        health["batches_served"] + 1) if norm_switch else 0)
    served = [read_dicom(body) for status, body in replies if status == 200]
    if len(served) != len(slices):
        fail(f"zero pad: {len(slices) - len(served)} requests not answered")
    errs = []
    with torch.inference_mode():
        for ds_in, ds in zip(slices, served):
            full = dual_window_native(ds_in.pixel_array())[1]
            ref = g(torch.from_numpy(full[None, ..., None]).to(dev))
            ref11 = ref[0, ..., 0].float().cpu().numpy()
            px = ds.pixel_array().astype(np.float64)
            if px.shape != (config.size, config.size) or not (
                    np.isfinite(px).all() and px.min() >= 0
                    and px.max() <= 4095):
                fail(f"zero pad: bad response {px.shape}")
            errs.append(float(np.abs(px / 4095.0 * 2.0 - 1.0 - ref11).mean()))
    print(f"serving {config.name} (HdGan_fast.yaml: {config.compute_dtype}, "
          f"pad_mode {config.pad_mode}) size {config.size}"
          f"{', InstanceNorm switch on' if norm_switch else ''}: "
          f"{len(served)} requests answered 200 with valid DICOM through the "
          f"layer route in {health['batches_served']} batches; mean |error| "
          f"per slice over [-1, 1] vs the same forward alone"
          f"{' (switch off)' if norm_switch else ''} largest {max(errs):.4f} "
          f"(tol {ZERO_PAD_MEAN_TOL:.4f}); launches {counts} (expected "
          f"{expect}) [{card}]", flush=True)
    if counts != expect:
        fail(f"zero pad launched kernels {counts}, expected {expect}")
    if max(errs) > ZERO_PAD_MEAN_TOL:
        fail("zero pad: served pixels disagree with the layer route")
    del g
    torch.cuda.empty_cache()


def _smoke_config(tmp, lists, extra="", base="HdGan.yaml"):
    """configs/``base`` with its list paths pointed at ``lists`` (one path
    for all three lists, or a dict by list name) and its checkpoints under
    ``tmp``, then ``extra``."""
    if isinstance(lists, str):
        lists = dict.fromkeys(("train", "val", "test"), lists)
    with open(os.path.join(REPO, "configs", base)) as f:
        text = f.read()
    text += "".join(f"\n{k}_list: '{lists[k]}'"
                    for k in ("train", "val", "test"))
    text += f"\nsave_root: '{tmp}/model/'\n" + extra
    fd, path = tempfile.mkstemp(suffix=".yaml", prefix="HdGan_smoke",
                                dir=tmp)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    return path


def check_training(torch, card):
    """Phase 8, a main path: HD stage 1 through the train entry point."""
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.models import Discriminator, Generator, RegNet
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lists = make_corpus(tmp, n_patients=2, slices_per_patient=6,
                            size=512, seed=0, lists=("train",))
        config = load_config(_smoke_config(tmp, lists["train"]))
        reset_counts()
        trainer = train(config, dev, max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        counts = launch_counts()
        losses = trainer.loss_history
        init = {
            "G": Generator(1, 1).reset_parameters(config.seed),
            "R": RegNet().reset_parameters(config.seed + 1),
            "D": Discriminator().reset_parameters(config.seed + 2),
        }
        trained = {"G": trainer.g_model, "R": trainer.r_model,
                   "D": trainer.d_model}
        moved = {k: max(float((p.detach().cpu() - q.detach()).abs().max())
                        for p, q in zip(trained[k].parameters(),
                                        init[k].parameters()))
                 for k in init}
        p50 = trainer.timer.summary(skip=1)["p50_ms"]
        del trainer, trained
        torch.cuda.empty_cache()
        plain_cfg = load_config(_smoke_config(tmp, lists["train"],
                                              "fused_body_grad: off\n"))
        reset_counts()
        plain = train(plain_cfg, dev, max_steps=PLAIN_STEPS)
        plain_counts = launch_counts()
        plain_p50 = plain.timer.summary(skip=1)["p50_ms"]
        del plain
        torch.cuda.empty_cache()
    import math

    finite = all(math.isfinite(v) for lo in losses for v in lo.values())
    # and the live panel's forward at the epoch's last step (log_every 50)
    expect = {k: v * TRAIN_STEPS + PER_EVAL_FORWARD[k]
              for k, v in PER_TRAIN_STEP.items()}
    print(f"training {config.name} HD stage 1 512^2 b=1 f32 (cuDNN TF32 "
          f"off): {len(losses)} steps, last losses {losses[-1]}, all finite "
          f"{finite}; largest parameter change G {moved['G']:.3e}, R "
          f"{moved['R']:.3e}, D {moved['D']:.3e}; launches {counts} "
          f"(expected {expect}); p50 step after 2 warm-up steps: kernel "
          f"route {p50:.1f} ms, plain route (fused_body_grad off) "
          f"{plain_p50:.1f} ms [{card}]", flush=True)
    if len(losses) != TRAIN_STEPS or not finite:
        fail("training: missing or non-finite losses")
    if min(moved.values()) <= 0.0:
        fail(f"training: a net was not updated {moved}")
    if counts != expect:
        fail(f"training launches {counts}, expected {expect}")
    if plain_counts != counts_of():
        fail(f"plain route launched kernels {plain_counts}")
    return counts


def _snapshot(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _equal_state(got, want):
    return set(got) == set(want) and all(got[k].equal(want[k]) for k in want)


def _train_stage2(torch, config, steps):
    """``__main__.train`` on a stage-2 config, with every kernel count set
    to 0 just before and read just after; G, R and D as the first step
    found them (after the bootstrap)."""
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.train import trainers

    first = {}
    step = trainers.HdTrainerStage2._step

    def spy(self, batch, lr, lr_d):
        if not first:
            first.update(G=_snapshot(self.g_model), R=_snapshot(self.r_model),
                         D=_snapshot(self.d_model))
        return step(self, batch, lr, lr_d)

    trainers.HdTrainerStage2._step = spy
    try:
        reset_counts()
        trainer = train(config, torch.device("cuda"), max_steps=steps)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        trainers.HdTrainerStage2._step = step
    if type(trainer) is not trainers.HdTrainerStage2:
        fail(f"stage2: {config.name} built {type(trainer).__name__}")
    return trainer, first, counts


def _moved(trainer, first):
    nets = {"G": trainer.g_model, "R": trainer.r_model, "D": trainer.d_model}
    return {k: max(float((v.cpu() - first[k][n]).abs().max())
                   for n, v in nets[k].state_dict().items()) for k in nets}


def _finite(losses):
    import math

    return bool(losses) and all(math.isfinite(v) for lo in losses
                                for v in lo.values())


def check_stage2(torch, card):
    """Phase 10, a main path: HD stage 2 through the train entry point,
    bootstrapped from a stage-1 epoch, on the kernel and plain routes; then
    configs/HdGan_fast.yaml (bf16) in stage 1 and stage 2."""
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.models import MultiScaleDiscriminator
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lists = make_corpus(tmp, n_patients=2, slices_per_patient=6,
                            size=512, seed=0, lists=("train",))
        # (a) one stage-1 epoch (12 slices): HdGan_hd1_e1.pt in save_root
        s1 = train(load_config(_smoke_config(tmp, lists["train"])), dev,
                   max_steps=TRAIN_STEPS)
        del s1
        torch.cuda.empty_cache()
        ckpt = os.path.join(tmp, "model", "HdGan_hd1_e1.pt")
        if not os.path.exists(ckpt):
            fail(f"stage2: the stage-1 epoch saved no {ckpt}")
        stage1 = torch.load(ckpt, map_location="cpu",
                            weights_only=True)["state"]

        def stage2_config(extra=""):
            return load_config(_smoke_config(tmp, lists["train"], extra,
                                             base="HdGan2.yaml"))

        # (b) configs/HdGan2.yaml on the kernel route
        config = stage2_config()
        trainer, first, counts = _train_stage2(torch, config, TRAIN_STEPS)
        losses = trainer.loss_history
        moved = _moved(trainer, first)
        p50 = trainer.timer.summary(skip=1)["p50_ms"]
        saved = os.path.exists(os.path.join(tmp, "model",
                                            "HdGan2_hd2_e1.pt"))
        del trainer
        torch.cuda.empty_cache()
        seeded_d = _snapshot(MultiScaleDiscriminator().reset_parameters(
            config.seed + 2))
        boot = {"G": _equal_state(first["G"], stage1["g"]),
                "R": _equal_state(first["R"], stage1["r"]),
                "D seeded": _equal_state(first["D"], seeded_d)}
        # (c) the plain route from the same bootstrap
        plain, plain_first, plain_counts = _train_stage2(
            torch, stage2_config("fused_body_grad: off\n"), PLAIN_STEPS)
        plain_losses = plain.loss_history
        plain_p50 = plain.timer.summary(skip=1)["p50_ms"]
        plain_boot = all(_equal_state(plain_first[k], first[k])
                         for k in first)
        del plain
        torch.cuda.empty_cache()
        # (d) HdGan_fast.yaml: bf16, pad_mode zero, warp_max_disp 4,
        # reg_downsample 2; the layer route, stage 1 then stage 2
        fast_root = os.path.join(tmp, "fast")
        os.makedirs(fast_root)
        with open(lists["train"]) as f:
            paths = [ln.strip() for ln in f if ln.strip()][:FAST_STEPS]
        fast_list = os.path.join(fast_root, "train.txt")
        with open(fast_list, "w") as f:
            f.write("\n".join(paths) + "\n")
        reset_counts()
        fast1 = train(load_config(_smoke_config(
            fast_root, fast_list, base="HdGan_fast.yaml")), dev,
            max_steps=FAST_STEPS)
        fast1_counts = launch_counts()
        fast1_losses = fast1.loss_history
        fast1_p50 = fast1.timer.summary(skip=1)["p50_ms"]
        del fast1
        torch.cuda.empty_cache()
        fast2, fast2_first, fast2_counts = _train_stage2(
            torch, load_config(_smoke_config(fast_root, fast_list,
                                             "name: HdGan2\n",
                                             base="HdGan_fast.yaml")),
            FAST_STEPS)
        fast2_losses = fast2.loss_history
        fast2_p50 = fast2.timer.summary(skip=1)["p50_ms"]
        fast_stage1 = torch.load(
            os.path.join(fast_root, "model", "HdGan_hd1_e1.pt"),
            map_location="cpu", weights_only=True)["state"]
        fast_boot = _equal_state(fast2_first["G"], fast_stage1["g"])
        fast_saved = os.path.exists(os.path.join(fast_root, "model",
                                                 "HdGan2_hd2_e1.pt"))
        del fast2
        torch.cuda.empty_cache()
    # and the live panel's forward at the epoch's last step
    expect = {k: v * TRAIN_STEPS + PER_EVAL_FORWARD[k]
              for k, v in PER_TRAIN_STEP.items()}
    k_loss = losses[0]["toal_loss"]
    p_loss = plain_losses[0]["toal_loss"]
    gap = abs(k_loss - p_loss) / max(abs(p_loss), 1e-12)
    print(f"stage2 {config.name} HD stage 2 {config.size}^2 b=1 f32 (cuDNN "
          f"TF32 off), "
          f"num_d {config.num_d}, bootstrapped from {os.path.basename(ckpt)}:"
          f" bit-equal at step 1 {boot}; {len(losses)} steps, last losses "
          f"{losses[-1]}, all finite {_finite(losses)}; largest parameter "
          f"change G {moved['G']:.3e}, R {moved['R']:.3e}, D "
          f"{moved['D']:.3e}; launches {counts} (expected {expect}); saved "
          f"HdGan2_hd2_e1.pt {saved}; first-step toal_loss kernel route "
          f"{k_loss!r}, plain route {p_loss!r}, relative gap {gap:.3e} (tol "
          f"{STAGE2_ROUTE_TOL:.0e}); p50 step after 2 warm-up steps: kernel "
          f"route {p50:.1f} ms, plain route (fused_body_grad off) "
          f"{plain_p50:.1f} ms [{card}]", flush=True)
    print(f"stage2 HdGan_fast.yaml (bf16, pad_mode zero, warp_max_disp 4, "
          f"reg_downsample 2, layer route) {config.size}^2 b=1: stage 1 "
          f"{len(fast1_losses)} steps, last losses {fast1_losses[-1]}, p50 "
          f"{fast1_p50:.1f} ms; stage 2 {len(fast2_losses)} steps, last "
          f"losses {fast2_losses[-1]}, p50 {fast2_p50:.1f} ms; all finite "
          f"{_finite(fast1_losses) and _finite(fast2_losses)}; bootstrapped "
          f"G bit-equal {fast_boot}; saved HdGan2_hd2_e1.pt {fast_saved}; "
          f"launches {fast1_counts} / {fast2_counts} [{card}]", flush=True)
    if not all(boot.values()) or not plain_boot or not fast_boot:
        fail("stage2: the bootstrap did not start from the stage-1 "
             "checkpoint's G and R and a seeded D")
    if (len(losses) != TRAIN_STEPS or not _finite(losses)
            or "SR_loss2" not in losses[0] or not _finite(plain_losses)):
        fail("stage2: missing or non-finite losses")
    if min(moved.values()) <= 0.0:
        fail(f"stage2: a net was not updated {moved}")
    if not saved or not fast_saved:
        fail("stage2: an epoch ended without its HdGan2_hd2_e1.pt")
    if counts != expect:
        fail(f"stage2 launches {counts}, expected {expect}")
    if plain_counts != counts_of():
        fail(f"stage2: the plain route launched kernels {plain_counts}")
    if gap > STAGE2_ROUTE_TOL:
        fail(f"stage2: the routes' first-step toal_loss differ by {gap:.3e}")
    if (len(fast1_losses) != FAST_STEPS or len(fast2_losses) != FAST_STEPS
            or not _finite(fast1_losses) or not _finite(fast2_losses)):
        fail("stage2: HdGan_fast.yaml missing or non-finite losses")
    if fast1_counts != counts_of() or fast2_counts != counts_of():
        fail(f"stage2: HdGan_fast.yaml's layer route launched kernels "
             f"{fast1_counts} / {fast2_counts}")
    return counts


def _train_family(torch, config, steps):
    """``__main__.train`` on a 2-D family's config, every kernel count set
    to 0 just before and read just after; the first step's nets (by
    checkpoint key) and the peak device memory of the run."""
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.train import trainers

    cls = trainers.TRAINERS[config.name]
    first = {}
    step = cls._step

    def spy(self, batch, lr, lr_d):
        if not first:
            first.update((key, _snapshot(getattr(self.state, net)))
                         for key, net in self._NETS)
        return step(self, batch, lr, lr_d)

    cls._step = spy
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        trainer = train(config, torch.device("cuda"), max_steps=steps)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        cls._step = step
    if type(trainer) is not cls:
        fail(f"families: {config.name} built {type(trainer).__name__}")
    moved = {key: max(float((v.cpu() - first[key][n]).abs().max())
                      for n, v in getattr(trainer.state, net)
                      .state_dict().items())
             for key, net in trainer._NETS}
    return trainer, counts, moved, peak


def check_families(torch, card):
    """Phase 11, a main path: the pix2pix, CycleGAN and RegGAN trainers
    through the train entry point at full width, 512², b=1, f32: each
    config's kernel-route epoch and two plain-route steps; CycleGAN at
    batchSize 2 with grad_accum 2 and ema_decay 0.999; then --mode test of
    the P2p checkpoint on the serving route."""
    import math

    from ctagan_tpu_torch.__main__ import test as run_test
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.utils.config import load_config

    families = {"RegGan": ("RegGan.yaml", "toal_loss", PER_TRAIN_STEP),
                "P2p": ("P2p.yaml", "loss_G", PER_TRAIN_STEP),
                "CycleGan": ("CycleGan.yaml", "loss_G", PER_CYC_STEP)}
    per_val = PER_EVAL_FORWARD  # the training route, without grad
    total = counts_of()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        train_list = make_corpus(tmp, n_patients=1,
                                 slices_per_patient=FAMILY_STEPS, size=512,
                                 seed=0, lists=("train",))["train"]
        with open(train_list) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        short = os.path.join(tmp, "short.txt")
        with open(short, "w") as f:
            f.write("\n".join(paths[:FAMILY_VAL]) + "\n")
        lists = {"train": train_list, "val": short, "test": short}
        accum_list = os.path.join(tmp, "accum.txt")
        with open(accum_list, "w") as f:
            f.write("\n".join(paths[:2 * ACCUM_STEPS]) + "\n")

        def family_config(name, root, extra="", **kw):
            os.makedirs(root, exist_ok=True)
            return load_config(_smoke_config(
                root, dict(lists, **kw), "val_every: 1\n" + extra,
                base=families[name][0]))

        for name, (base, key, per_step) in families.items():
            root = os.path.join(tmp, name)
            config = family_config(name, root)
            trainer, counts, moved, peak = _train_family(
                torch, config, FAMILY_STEPS)
            losses = trainer.loss_history
            p50 = trainer.timer.summary(skip=1)["p50_ms"]
            saved = [fn for fn in os.listdir(os.path.join(root, "model"))
                     if fn.startswith(f"{trainer.ckpt_prefix}_e1_")]
            del trainer
            torch.cuda.empty_cache()
            plain, plain_counts, _, plain_peak = _train_family(
                torch, family_config(name, os.path.join(root, "plain"),
                                     "fused_body_grad: off\n"),
                FAMILY_PLAIN_STEPS)
            plain_losses = plain.loss_history
            plain_p50 = plain.timer.summary()["p50_ms"]
            del plain
            torch.cuda.empty_cache()
            # and two panel forwards: the live batch's at the epoch's last
            # step, the first val slice's after the validation
            expect = {k: v * FAMILY_STEPS + per_val[k] * (FAMILY_VAL + 2)
                      for k, v in per_step.items()}
            k_loss, p_loss = losses[0][key], plain_losses[0][key]
            gap = abs(k_loss - p_loss) / max(abs(p_loss), 1e-12)
            print(f"families {name} ({base}) 512^2 b=1 f32 (cuDNN TF32 "
                  f"off): {len(losses)} steps, loss keys {list(losses[0])}, "
                  f"last losses {losses[-1]}, all finite {_finite(losses)}; "
                  f"largest parameter change "
                  + ", ".join(f"{k} {v:.3e}" for k, v in moved.items())
                  + f"; launches {counts} (expected {expect}: "
                  f"{FAMILY_STEPS} steps, {FAMILY_VAL} val slices and 2 "
                  f"panels); "
                  f"saved {saved}; first-step {key} kernel route {k_loss!r}"
                  f", plain route {p_loss!r}, relative gap {gap:.3e} (tol "
                  f"{FAMILY_ROUTE_TOL:.0e}); p50 step: kernel route "
                  f"{p50:.1f} ms (steps 3-{FAMILY_STEPS}), plain route "
                  f"{plain_p50:.1f} ms (step 2); peak memory kernel route "
                  f"{peak / 2 ** 30:.2f} GiB, plain route "
                  f"{plain_peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
            if len(losses) != FAMILY_STEPS or not _finite(losses) \
                    or not _finite(plain_losses):
                fail(f"families: {name} missing or non-finite losses")
            if min(moved.values()) <= 0.0:
                fail(f"families: {name} left a net unchanged {moved}")
            if len(saved) != 1:
                fail(f"families: {name}'s epoch saved {saved}")
            if counts != expect:
                fail(f"families: {name} launches {counts}, expected {expect}")
            if plain_counts != counts_of():
                fail(f"families: {name}'s plain route launched kernels "
                     f"{plain_counts}")
            if gap > FAMILY_ROUTE_TOL:
                fail(f"families: {name}'s routes' first-step {key} differ "
                     f"by {gap:.3e}")
            for k, v in counts.items():
                total[k] += v

        # CycleGAN, batchSize 2, grad_accum 2, ema_decay 0.999: the epoch
        # (two steps) validates on the EMA
        root = os.path.join(tmp, "accum")
        config = family_config("CycleGan", root, "batchSize: 2\n"
                               "grad_accum: 2\nema_decay: 0.999\n",
                               train=accum_list)
        trainer, counts, moved, peak = _train_family(torch, config,
                                                     ACCUM_STEPS)
        losses = trainer.loss_history
        ema, live = trainer.state.g_ema, trainer.g_model
        reads_ema = trainer._eval_model() is ema
        ema_gap = max(float((e - p.detach()).abs().max()) for e, p in
                      zip(ema.parameters(), live.parameters()))
        reset_counts()
        val_ema = trainer.validate()
        trainer.config.ema_decay = 0.0  # the live G_A2B, for comparison
        val_live = trainer.validate()
        trainer.config.ema_decay = 0.999
        total_val = launch_counts()
        del trainer, ema, live
        torch.cuda.empty_cache()
        expect = {k: v * ACCUM_STEPS + per_val[k] * (FAMILY_VAL + 2)
                  for k, v in PER_CYC_ACCUM2_STEP.items()}
        print(f"families CycleGan batchSize 2, grad_accum 2, ema_decay "
              f"0.999, 512^2 f32: {len(losses)} steps, last losses "
              f"{losses[-1]}, all finite {_finite(losses)}; launches "
              f"{counts} (expected {expect}); validation reads the EMA "
              f"{reads_ema}, EMA vs live G_A2B max |diff| {ema_gap:.3e}, val "
              f"PSNR/SSIM on the EMA {val_ema}, on the live G {val_live}; "
              f"peak memory {peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
        if len(losses) != ACCUM_STEPS or not _finite(losses):
            fail("families: CycleGan grad_accum missing or non-finite losses")
        if counts != expect:
            fail(f"families: CycleGan grad_accum launches {counts}, expected "
                 f"{expect}")
        if not reads_ema or not ema_gap > 0.0 or val_ema == val_live:
            fail("families: CycleGan's validation does not read its EMA")
        for k, v in counts.items():
            total[k] += v + total_val[k]

        # --mode test of the P2p epoch's checkpoint on the serving route
        img = os.path.join(tmp, "P2p", "img")
        config = family_config("P2p", os.path.join(tmp, "P2p"),
                               f"fused_body: true\nimage_save: '{img}/'\n")
        reset_counts()
        trainer, agg, secs = run_test(config, dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        del trainer
        torch.cuda.empty_cache()
        se2 = [fn for d, _, fs in os.walk(img) for fn in fs
               if os.path.basename(d) == "SE2"]
        expect = {k: v * FAMILY_VAL for k, v in PER_FORWARD.items()}
        print(f"families P2p --mode test, serving route (fused_body): "
              f"{FAMILY_VAL} slices in {secs:.3f} s; "
              + ", ".join(f"{k} {v:.4f}" for k, v in agg.items())
              + f"; {len(se2)} SE2 files; launches {counts} (expected "
              f"{expect}) [{card}]", flush=True)
        if sorted(agg) != sorted(("MAEw", "PSNRw", "SSIMw", "UQIw", "MAE",
                                  "PSNR", "SSIM", "UQI")) or not all(
                                      math.isfinite(v) for v in agg.values()):
            fail(f"families: P2p test() metrics {agg}")
        if len(se2) != FAMILY_VAL:
            fail(f"families: P2p test() wrote {len(se2)} SE2 files")
        if counts != expect:
            fail(f"families: P2p test() launches {counts}, expected {expect}")
        for k, v in counts.items():
            total[k] += v
    return total


def _eval_corpus(tmp):
    """The test phase's corpus: val and test list paths, the test slices."""
    from ctagan_tpu_torch.data import dicom
    from ctagan_tpu_torch.data.fixtures import make_corpus

    lists = make_corpus(tmp, n_patients=EVAL_PATIENTS,
                        slices_per_patient=EVAL_SLICES, size=EVAL_SIZE, seed=0,
                        lists=("train",))
    with open(lists["train"]) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    for p in paths:
        if f"patient2{os.sep}" in p:  # per-slice windows in test()
            se1 = p.replace("SE0", "SE1")
            ds = dicom.read_dicom(se1)
            ds.set_str(dicom.TAG_WINDOW_CENTER, "300", b"DS")
            ds.set_str(dicom.TAG_WINDOW_WIDTH, "1500", b"DS")
            dicom.write_dicom(ds, se1)
    test = [p for p in paths if f"patient0{os.sep}" not in p]
    for name, chunk in (("val", paths[:VAL_SLICES]), ("test", test)):
        lists[name] = os.path.join(tmp, f"{name}.txt")
        with open(lists[name], "w") as f:
            f.write("\n".join(chunk) + "\n")
    return lists, test


def _read_se2_tree(root, test_paths):
    """Every file of one test() writeback: checks the layout and the copies,
    returns {slice name within its patient: SE2 stored pixels}."""
    import numpy as np

    from ctagan_tpu_torch.data import dicom

    patients = sorted({p.split("SE0")[0] for p in test_paths})
    se2, uids = {}, set()
    for idx, src_dir in enumerate(patients, 1):
        names = sorted(os.path.basename(p) for p in test_paths
                       if p.startswith(src_dir))
        src_uid = dicom.read_dicom(
            os.path.join(src_dir, "SE1", names[0])).series_instance_uid
        for se, st in (("SE0", "ST0"), ("SE1", "ST0"), ("SE2", "ST1")):
            d = os.path.join(root, st, str(idx), se)
            if sorted(os.listdir(d)) != names:
                fail(f"test: {d} holds {sorted(os.listdir(d))}, expected "
                     f"{names}")
        for name in names:
            for se in ("SE0", "SE1"):
                with open(os.path.join(root, "ST0", str(idx), se, name),
                          "rb") as f, open(os.path.join(src_dir, se, name),
                                           "rb") as g:
                    if f.read() != g.read():
                        fail(f"test: the {se} copy of {src_dir}{name} "
                             "differs from its source")
            ds = dicom.read_dicom(os.path.join(root, "ST1", str(idx), "SE2",
                                               name))
            px = ds.pixel_array().astype(np.int32)
            uid = ds.series_instance_uid
            if px.shape != (EVAL_SIZE,) * 2 or uid == src_uid:
                fail(f"test: SE2 {idx}/{name}: shape {px.shape}, series "
                     f"UID {uid} (source {src_uid})")
            se2[(idx, name)] = px
            uids.add((idx, uid))
    if len(se2) != len(test_paths) or len(uids) != len(patients) or len(
            {u for _, u in uids}) != len(patients):
        fail(f"test: {len(se2)} SE2 files of {len(test_paths)}, series "
             f"UIDs {sorted(uids)}")
    return se2


def _direct_plain_pixels(torch, g_model, src):
    """One SE0 slice through ``g_model``'s plain layer route outside the
    entry points, de-normalized as the writeback stores it."""
    import numpy as np

    from ctagan_tpu_torch.data import dicom
    from ctagan_tpu_torch.ops.windowing import dual_window

    raw = dicom.read_dicom(src).pixel_array()
    x = dual_window(raw)[1][None, :, :, None].to(
        next(g_model.parameters()).device)
    with torch.no_grad():
        y = g_model(x, fused_body=False)[0, :, :, 0].float()
    return ((y + 1.0) * 0.5 * 4095.0).to(torch.int16).cpu().numpy().astype(
        np.int32)


def _warm_up_routes(torch, dev):
    """Each eval route's first forwards at each batch size, outside the
    timed runs (kernel module loads, cuDNN's per-shape set-up)."""
    from ctagan_tpu_torch.models import Generator

    g = Generator(1, 1, fused_body=False, fused_body_grad="auto")
    g = g.reset_parameters(0).to(dev)
    with torch.no_grad():
        for k in EVAL_BATCHES:
            x = torch.zeros(k, EVAL_SIZE, EVAL_SIZE, 1, device=dev)
            for grad_route in ("auto", False):
                g.fused_body_grad = grad_route
                g(x)
            g(x, fused_body=True)
    torch.cuda.synchronize()
    del g
    torch.cuda.empty_cache()


def check_test(torch, card):
    """Phase 9, a main path: test() and validate() through the test entry
    point on three routes at eval_batch 1 and 16."""
    import math

    import numpy as np

    from ctagan_tpu_torch.__main__ import test as run_test
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    routes = {
        "fused_body": ("fused_body: true\n", PER_FORWARD),
        "default": ("", counts_of(conv3x3_reflect_stats=18)),
        "plain": ("fused_body: false\nfused_body_grad: off\n", counts_of()),
    }
    total = counts_of()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        lists, test_paths = _eval_corpus(tmp)
        _warm_up_routes(torch, dev)
        for route, (extra, per_forward) in routes.items():
            for k in EVAL_BATCHES:
                img = os.path.join(tmp, f"img_{route}_{k}")
                config = load_config(_smoke_config(
                    tmp, lists, extra + f"eval_batch: {k}\n"
                    f"image_save: '{img}/'\n"))
                reset_counts()
                trainer, agg, secs = run_test(config, dev)
                torch.cuda.synchronize()
                t_counts = launch_counts()
                reset_counts()
                t0 = time.perf_counter()
                val = trainer.validate()
                torch.cuda.synchronize()
                v_secs = time.perf_counter() - t0
                v_counts = launch_counts()
                for what, counts, n in (("test()", t_counts, TEST_SLICES),
                                        ("validate()", v_counts, VAL_SLICES)):
                    want = {name: c * math.ceil(n / k)
                            for name, c in per_forward.items()}
                    if counts != want:
                        fail(f"test: {route} eval_batch {k} {what} launches "
                             f"{counts}, expected {want}")
                    for name, c in counts.items():
                        total[name] += c
                se2 = _read_se2_tree(img, test_paths)
                if route == "plain" and k == 1:
                    src = test_paths[0]
                    direct = _direct_plain_pixels(torch, trainer.g_model,
                                                  src)
                    got = se2[(1, os.path.basename(src))]
                    d = int(np.abs(got - direct).max())
                    if d > PIXEL_TOL:
                        fail(f"test: SE2 of {src} is {d} stored units from "
                             "a direct plain forward")
                runs[(route, k)] = (agg, val, se2)
                line = (f"test {route} route, eval_batch {k}, {EVAL_SIZE}^2 "
                        f"f32 (cuDNN TF32 off): test() {TEST_SLICES} slices "
                        f"in {secs:.3f} s = {TEST_SLICES / secs:.2f} slices/s, "
                        f"validate() {VAL_SLICES} slices in {v_secs:.3f} s = "
                        f"{VAL_SLICES / v_secs:.2f} slices/s; PSNRw "
                        f"{agg['PSNRw']:.4f} PSNR {agg['PSNR']:.4f} SSIM "
                        f"{agg['SSIM']:.6f}, val PSNR {val[0]:.4f} SSIM "
                        f"{val[1]:.6f} [{card}]")
                print(line, flush=True)
                del trainer
                torch.cuda.empty_cache()
    for k in EVAL_BATCHES:
        p_agg, p_val, p_se2 = runs[("plain", k)]
        for route in ("fused_body", "default"):
            agg, val, se2 = runs[(route, k)]
            errs = {key: abs(agg[key] - p_agg[key]) for key in p_agg}
            errs["val PSNR"] = abs(val[0] - p_val[0])
            errs["val SSIM"] = abs(val[1] - p_val[1])
            px = max(int(np.abs(se2[n] - p_se2[n]).max()) for n in p_se2)
            print(f"test {route} vs plain route, eval_batch {k}: "
                  + ", ".join(f"{key} {v:.3e}" for key, v in errs.items())
                  + f" (tol {TEST_PSNR_TOL} dB PSNR, {TEST_TOL:.0e} the "
                  f"others); SE2 max |diff| {px} stored units (tol "
                  f"{PIXEL_TOL:.0f})", flush=True)
            bad = [key for key, v in errs.items()
                   if v > (TEST_PSNR_TOL if "PSNR" in key else TEST_TOL)]
            if bad or px > PIXEL_TOL:
                fail(f"test: {route} route at eval_batch {k} disagrees with "
                     f"the plain route on {bad or 'SE2 pixels'}")
    return total


def _se2_series(torch, out_dir, series):
    """One infer_series writeback read back: checks every file's name, rows
    and cols against its SE0 slice and one new SeriesInstanceUID; returns
    {name: stored pixels}."""
    import numpy as np

    from ctagan_tpu_torch.data import dicom

    names = sorted(f for f in os.listdir(series) if f.startswith("IM"))
    if sorted(os.listdir(out_dir)) != names:
        fail(f"infer: {out_dir} holds {len(os.listdir(out_dir))} files, "
             f"expected the series' {len(names)}")
    src_uid = dicom.read_dicom(os.path.join(series, names[0])
                               ).series_instance_uid
    px, uids = {}, set()
    for n in names:
        src = dicom.read_dicom(os.path.join(series, n))
        ds = dicom.read_dicom(os.path.join(out_dir, n))
        if (ds.rows, ds.cols) != (src.rows, src.cols):
            fail(f"infer: SE2 {n} is {ds.rows}x{ds.cols}, its SE0 slice "
                 f"{src.rows}x{src.cols}")
        px[n] = ds.pixel_array().astype(np.int32)
        uids.add(ds.series_instance_uid)
    if len(uids) != 1 or src_uid in uids:
        fail(f"infer: SE2 series UIDs {sorted(uids)} (source {src_uid})")
    return px


def _infer_run(torch, config, series, per_forward, what):
    """``__main__.infer`` twice: a warm-up, whose SE2 series is removed, then
    the timed run with every kernel count set to 0 just before and read just
    after; returns the counts, the seconds of the call and of its parts, and
    the SE2 pixels the timed run wrote."""
    from ctagan_tpu_torch.__main__ import infer

    dev = torch.device("cuda")
    # kernel module loads, cuDNN's set-up
    shutil.rmtree(infer(config, dev, series))
    torch.cuda.synchronize()
    times = {}
    reset_counts()
    t0 = time.perf_counter()
    out_dir = infer(config, dev, series, times)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    want = {name: c * INFER_BATCHES for name, c in per_forward.items()}
    if counts != want:
        fail(f"infer: {what} launches {counts}, expected {want} "
             f"({INFER_BATCHES} batches of {INFER_BATCH})")
    return counts, secs, times, _se2_series(torch, out_dir, series)


def _infer_line(what, secs, times, n, card):
    parts = ", ".join(f"{k} {v:.3f} s = {n / v:.2f} slices/s"
                      for k, v in times.items())
    return (f"infer {what}: {n} slices in {secs:.3f} s = {n / secs:.2f} "
            f"slices/s (host wall, after a warm-up call); {parts} [{card}]")


def check_infer(torch, card):
    """Phase 12, a main path: ``--mode infer``'s series inference on
    ``configs/HdGan.yaml`` (full width, 512²) over a 50-slice SE0 series,
    the generator found in ``save_root`` by the lookup, on three routes;
    then a 2.5-D ``configs/P2p.yaml`` run."""
    import numpy as np

    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.utils.config import load_config

    routes = {
        "default": ("", counts_of(conv3x3_reflect_stats=18)),
        "fused_body": ("fused_body: true\n", PER_FORWARD),
        "plain": ("fused_body: false\nfused_body_grad: off\n", counts_of()),
    }
    total = counts_of()
    with tempfile.TemporaryDirectory() as tmp:
        lists = make_corpus(tmp, n_patients=1,
                            slices_per_patient=INFER_SLICES, size=EVAL_SIZE,
                            seed=0, lists=("train",))
        series = os.path.join(tmp, "patient0", "ST0", "SE0")
        g, ckpt = _stand_in_checkpoint(f"{tmp}/model/")
        px = {}
        for route, (extra, per_forward) in routes.items():
            config = load_config(_smoke_config(
                tmp, lists["train"], extra + f"image_save: '{tmp}/{route}/'\n"))
            counts, secs, times, px[route] = _infer_run(
                torch, config, series, per_forward, route)
            for name, c in counts.items():
                total[name] += c
            print(_infer_line(f"HdGan.yaml {route} route, {EVAL_SIZE}^2 f32 "
                              f"(cuDNN TF32 off), batches of {INFER_BATCH}, "
                              f"launches {counts}", secs, times,
                              INFER_SLICES, card), flush=True)
        # the lookup: the plain route's first slice is the saved G's
        first = sorted(px["plain"])[0]
        direct = _direct_plain_pixels(torch, g.to("cuda").eval(),
                                      os.path.join(series, first))
        d = int(np.abs(px["plain"][first] - direct).max())
        if d > INFER_PIXEL_TOL:
            fail(f"infer: the plain route's {first} is {d} stored units "
                 f"from {os.path.basename(ckpt)}'s G: the lookup missed it")
        for route in ("default", "fused_body"):
            diff = np.stack([np.abs(px[route][n] - px["plain"][n])
                             for n in px["plain"]])
            print(f"infer {route} vs plain route: SE2 max |diff| "
                  f"{int(diff.max())} stored units (tol {INFER_PIXEL_TOL}), "
                  f"{float((diff == 0).mean()):.6f} of pixels equal",
                  flush=True)
            if diff.max() > INFER_PIXEL_TOL:
                fail(f"infer: the {route} route's SE2 disagrees with the "
                     "plain route's")
        # 2.5-D: configs/P2p.yaml with context_slices 3 (seeded weights)
        config = load_config(_smoke_config(
            tmp, lists["train"], f"context_slices: 3\nimage_save: "
            f"'{tmp}/ctx3/'\n", base="P2p.yaml"))
        counts, secs, times, ctx_px = _infer_run(
            torch, config, series, counts_of(conv3x3_reflect_stats=18),
            "P2p.yaml context_slices 3")
        for name, c in counts.items():
            total[name] += c
        if all(int(v.max()) == int(v.min()) for v in ctx_px.values()):
            fail("infer: every slice of the 2.5-D series is constant")
        print(_infer_line(f"P2p.yaml context_slices 3, default route, "
                          f"{EVAL_SIZE}^2, launches {counts}", secs, times,
                          INFER_SLICES, card), flush=True)
    return total


def check_export(torch, card):
    """Phase 13: ``serving/export.py`` on the full-width G at 512² with a
    symbolic batch, loaded by ``load_exported`` and run at b=1 and b=4
    against the eager plain route; its forward time beside the eager plain
    and the ``fused_body`` routes."""
    from ctagan_tpu_torch.models import Generator
    from ctagan_tpu_torch.serving.export import (
        export_generator,
        load_exported,
    )

    dev = torch.device("cuda")
    g = Generator(1, 1).reset_parameters(INFER_SEED).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "generator.ctpt")
        t0 = time.perf_counter()
        export_generator(g, path, size=EVAL_SIZE)
        secs = time.perf_counter() - t0
        size = os.path.getsize(path)
        fn, header = load_exported(path)
    if header["batch"] is not None or header["platforms"] != ["cuda"]:
        fail(f"export: header {header}")
    errs = {}
    for b in EXPORT_BATCHES:
        x = torch.rand(b, EVAL_SIZE, EVAL_SIZE, 1, generator=gen,
                       device=dev) * 2 - 1
        reset_counts()
        got = fn(x)
        torch.cuda.synchronize()
        if launch_counts() != counts_of():
            fail(f"export: the artifact launched {launch_counts()}")
        with torch.no_grad():
            want = g(x, fused_body=False)
        errs[b] = float((got - want).abs().max())
    with torch.no_grad():
        x = torch.rand(4, EVAL_SIZE, EVAL_SIZE, 1, generator=gen, device=dev)
        ms = {"exported": cuda_ms(torch, lambda: fn(x), iters=5),
              "eager plain": cuda_ms(torch, lambda: g(x, fused_body=False),
                                     iters=5),
              "fused_body": cuda_ms(torch, lambda: g(x, fused_body=True),
                                    iters=5)}
    print(f"export: full-width G at {EVAL_SIZE}^2, symbolic batch, {size} "
          f"bytes, exported in {secs:.2f} s; loaded program vs eager plain "
          "route max |diff| "
          + ", ".join(f"b={b} {e:.3e}" for b, e in errs.items())
          + f" (tol {EXPORT_TOL:.0e}); b=4 forward "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f" (CUDA events, mean of 5, cuDNN TF32 off) [{card}]", flush=True)
    if max(errs.values()) > EXPORT_TOL:
        fail("export: the loaded program disagrees with the eager plain "
             "route")


def check_figures(torch, card):
    """Phase 14, a main path: ``--mode figures``'s panels of 4 test slices
    on ``configs/HdGan.yaml``'s default eval route, read back."""
    import numpy as np

    from ctagan_tpu_torch.__main__ import figures
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.utils.config import load_config
    from ctagan_tpu_torch.utils.figures import read_png_gray

    with tempfile.TemporaryDirectory() as tmp:
        lists = make_corpus(tmp, n_patients=1,
                            slices_per_patient=FIGURE_SLICES,
                            size=EVAL_SIZE, seed=1, lists=("train",))
        config = load_config(_smoke_config(
            tmp, lists["train"], f"image_save: '{tmp}/img/'\n"))
        reset_counts()
        t0 = time.perf_counter()
        out = figures(config, torch.device("cuda"))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        want = counts_of(conv3x3_reflect_stats=18 * FIGURE_SLICES)
        if counts != want:
            fail(f"figures: launches {counts}, expected {want}")
        names = sorted(os.listdir(out))
        if names != [f"slice{i}.png" for i in range(FIGURE_SLICES)]:
            fail(f"figures: {out} holds {names}")
        for n in names:
            img = read_png_gray(os.path.join(out, n))
            if img.shape != FIGURE_SHAPE or int(img.max()) == int(img.min()):
                fail(f"figures: {n} is {img.shape}, range {img.min()}.."
                     f"{img.max()}; expected {FIGURE_SHAPE}")
    print(f"figures: {FIGURE_SLICES} panels {FIGURE_SHAPE} in {secs:.2f} s, "
          f"launches {counts} [{card}]", flush=True)
    return counts


def _write_list(path, paths):
    with open(path, "w") as f:
        f.write("\n".join(paths) + "\n")
    return path


def _read_list(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


# a sitecustomize shadow, first on the drill child's PYTHONPATH (every
# python process imports it, so it survives the supervisor's relaunch; no
# hook goes into the port): the WEDGE_TICK-th StepTimer.tick of the first
# attempt (no marker file yet) sleeps WEDGE_SLEEP s, a wedged device call
# that the watchdog must end with exit 42
WEDGE_SHADOW = """\
import os, time
if os.environ.get("WEDGE_MARKER"):
    from ctagan_tpu_torch.train import trainers as _t
    _orig, _n = _t.StepTimer.tick, [0]
    def tick(self):
        _n[0] += 1
        m = os.environ["WEDGE_MARKER"]
        if _n[0] == int(os.environ["WEDGE_TICK"]) and not os.path.exists(m):
            open(m, "w").write("x")
            time.sleep(float(os.environ["WEDGE_SLEEP"]))
        _orig(self)
    _t.StepTimer.tick = tick
"""


def _wedge_drill(tmp, train_list):
    """``python -m ctagan_tpu_torch --mode train --supervise 1`` on
    configs/HdGan.yaml (two epochs, a checkpoint every step, stall_timeout
    DRILL_STALL) whose first attempt wedges at its second step timer tick:
    returns the exit code, stdout, stderr, seconds and the saved files."""
    import signal

    root = os.path.join(tmp, "drill")
    os.makedirs(root)
    drill_list = _write_list(os.path.join(root, "train.txt"),
                             _read_list(train_list)[:DRILL_SLICES])
    cfg = _smoke_config(root, drill_list,
                        "n_epochs: 2\ndecay_epoch: 0\nval_every: 100\n"
                        f"stall_timeout: {DRILL_STALL}\n"
                        "checkpoint_every_iters: 1\n")
    hook = os.path.join(root, "hook")
    os.makedirs(hook)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(WEDGE_SHADOW)
    marker = os.path.join(root, "wedged_once")
    env = dict(os.environ, WEDGE_MARKER=marker, WEDGE_TICK="2",
               WEDGE_SLEEP=str(DRILL_SLEEP),
               PYTHONPATH=os.pathsep.join(
                   p for p in (hook, REPO, os.environ.get("PYTHONPATH"))
                   if p))
    t0 = time.perf_counter()
    # its own session, so that a timeout ends the supervisor and its child
    proc = subprocess.Popen(
        [sys.executable, "-m", "ctagan_tpu_torch", "--config", cfg, "--mode",
         "train", "--supervise", "1"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DRILL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"loop: the wedge drill ran past {DRILL_TIMEOUT} s; stderr "
             f"{err[-2000:]}")
    secs = time.perf_counter() - t0
    saved = sorted(os.listdir(os.path.join(root, "model")))
    return proc.returncode, out, err, secs, saved, os.path.exists(marker)


def _remat_runs(torch, tmp, train_list, card):
    """The HD stage-1 step with remat off and on: the layer route
    (fused_body_grad off) at batchSize 1 and 4, the kernel route at 1; each
    run's first-step losses, p50 step, peak memory and launches."""
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.utils.config import load_config

    root = os.path.join(tmp, "remat")
    os.makedirs(root)
    lst = _write_list(os.path.join(root, "train.txt"),
                      _read_list(train_list)[:REMAT_SLICES])
    runs = {}
    for route, batches in (("layer", (1, 4)), ("kernel", (1,))):
        for b in batches:
            for remat in (False, True):
                # the step's memory and time alone: no panel forwards
                extra = (f"batchSize: {b}\nremat: {str(remat).lower()}\n"
                         "live_panels: false\n"
                         + ("fused_body_grad: off\n" if route == "layer"
                            else ""))
                config = load_config(_smoke_config(root, lst, extra))
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t = train(config, torch.device("cuda"),
                          max_steps=REMAT_STEPS[b])
                torch.cuda.synchronize()
                runs[route, b, remat] = {
                    "losses": t.loss_history[0],
                    "p50_ms": t.timer.summary(skip=1)["p50_ms"],
                    "peak": torch.cuda.max_memory_allocated(),
                    "counts": launch_counts()}
                del t
    torch.cuda.empty_cache()
    for (route, b, remat), r in runs.items():
        print(f"loop remat {str(remat).lower():5s} HD stage 1 {route} route "
              f"512^2 b={b} f32: p50 step {r['p50_ms']:.1f} ms (steps "
              f"3-{REMAT_STEPS[b]}), peak memory {r['peak'] / 2 ** 30:.3f} "
              f"GiB ({r['peak']} B), first-step toal_loss "
              f"{r['losses']['toal_loss']!r} [{card}]", flush=True)
    for b in (1, 4):
        off, on = runs["layer", b, False], runs["layer", b, True]
        gaps = {k: abs(on["losses"][k] - v) / max(abs(v), 1e-12)
                for k, v in off["losses"].items()}
        print(f"loop remat layer route b={b}: first-step losses' relative "
              f"gaps, remat on vs off: "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f" (tol {REMAT_LOSS_TOL:.0e}; loss_D_B {REMAT_D_TOL:.0e}, "
              "after G's update)", flush=True)
        if any(v > (REMAT_D_TOL if k == "loss_D_B" else REMAT_LOSS_TOL)
               for k, v in gaps.items()):
            fail(f"loop: remat changed the layer route's first-step losses "
                 f"at b={b}: {gaps}")
        if on["counts"] != counts_of() or off["counts"] != counts_of():
            fail("loop: the layer route launched kernels")
    off, on = runs["kernel", 1, False], runs["kernel", 1, True]
    if on["counts"] != off["counts"] or on["peak"] != off["peak"]:
        fail(f"loop: remat moved the kernel route: launches {off['counts']}"
             f" / {on['counts']}, peak {off['peak']} / {on['peak']} B")
    return runs


def check_loop(torch, card):
    """Phase 15, a main path: the trainer loop of ``python -m
    ctagan_tpu_torch --mode train``'s ``train()`` on configs/HdGan.yaml at
    full width on the kernel route, with the watchdog armed and live panels
    (the loss, val and panel files, the dashboard, the launch counts with
    the panel forwards); the wedge drill under ``--supervise 1``; remat."""
    import csv
    import math

    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.utils.config import load_config
    from ctagan_tpu_torch.utils.figures import read_png_gray

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        train_list = make_corpus(tmp, n_patients=2,
                                 slices_per_patient=REMAT_SLICES // 2,
                                 size=512, seed=0, lists=("train",))["train"]
        paths = _read_list(train_list)
        loop_root = os.path.join(tmp, "loop")
        os.makedirs(loop_root)
        lists = {"train": _write_list(os.path.join(loop_root, "train.txt"),
                                      paths[:LOOP_STEPS]),
                 "val": _write_list(os.path.join(loop_root, "val.txt"),
                                    paths[:LOOP_VAL])}
        lists["test"] = lists["val"]
        config = load_config(_smoke_config(
            loop_root, lists, "n_epochs: 1\ndecay_epoch: 0\nval_every: 1\n"
            f"log_every: {LOOP_LOG_EVERY}\nstall_timeout: 120\n"
            "live_panels: true\n"))
        reset_counts()
        trainer = train(config, dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        losses = trainer.loss_history
        armed_after = trainer._watchdog is not None
        del trainer
        torch.cuda.empty_cache()
        model = os.path.join(loop_root, "model")
        with open(os.path.join(model, "HdGan_losses.csv")) as f:
            loss_rows = list(csv.reader(f))
        with open(os.path.join(model, "HdGan_val.csv")) as f:
            val_rows = list(csv.reader(f))
        panel = read_png_gray(os.path.join(model, "HdGan_latest_panel.png"))
        with open(os.path.join(model, "dashboard.html")) as f:
            dash = f.read()
        keys = sorted(losses[0])
        means = []
        for k in keys:  # the logger's running mean: summed in order, / n
            acc = 0.0
            for lo in losses:
                acc += lo[k]
            means.append(repr(acc / len(losses)))
        # live panels every LOOP_LOG_EVERY steps (the last one ends the
        # epoch), the val slices and the val panel: eval-route forwards
        n_panels = LOOP_STEPS // LOOP_LOG_EVERY
        n_eval = n_panels + LOOP_VAL + 1
        expect = {k: v * LOOP_STEPS + PER_EVAL_FORWARD[k] * n_eval
                  for k, v in PER_TRAIN_STEP.items()}
        print(f"loop HdGan.yaml 512^2 b=1 f32 kernel route, log_every "
              f"{LOOP_LOG_EVERY}, stall_timeout 120, live panels: "
              f"{len(losses)} steps, last losses {losses[-1]}; "
              f"HdGan_losses.csv {loss_rows}; HdGan_val.csv {val_rows}; "
              f"panel {panel.shape}; dashboard {len(dash)} chars; watchdog "
              f"armed after the run {armed_after}; launches {counts} "
              f"(expected {expect}: {LOOP_STEPS} steps, {n_panels} live "
              f"panels, {LOOP_VAL} val slices, 1 val panel) [{card}]",
              flush=True)
        if len(losses) != LOOP_STEPS or not _finite(losses):
            fail("loop: missing or non-finite losses")
        if loss_rows != [["epoch", *keys], ["1", *means]]:
            fail(f"loop: HdGan_losses.csv {loss_rows}, expected the header "
                 f"{['epoch', *keys]} and epoch 1's means {means}")
        if len(val_rows) != 2 or val_rows[0] != ["epoch", "PSNR", "SSIM"] \
                or not all(math.isfinite(float(v)) for v in val_rows[1]):
            fail(f"loop: HdGan_val.csv {val_rows}")
        if panel.shape != (512, 3 * 512) \
                or int(panel.max()) == int(panel.min()):
            fail(f"loop: HdGan_latest_panel.png is {panel.shape}")
        if "<svg" not in dash or "data:image/png;base64," not in dash:
            fail("loop: dashboard.html lacks its charts or its panel")
        if armed_after:
            fail("loop: the watchdog is still armed after train()")
        if counts != expect:
            fail(f"loop launches {counts}, expected {expect}")
        code, out, err, drill_s, drill_saved, wedged = _wedge_drill(
            tmp, train_list)
        relaunches = err.count("[supervise] attempt")
        print(f"loop wedge drill (--supervise 1, stall_timeout "
              f"{DRILL_STALL}, {DRILL_SLICES}-step epochs, the first "
              f"attempt's second step timer tick held {DRILL_SLEEP} s): exit "
              f"{code} in {drill_s:.1f} s, relaunches {relaunches}, saved "
              f"{drill_saved}; stderr "
              + " | ".join(ln for ln in err.splitlines()
                           if ln.startswith(("[watchdog]", "[supervise]")))
              + " | stdout "
              + " | ".join(ln for ln in out.splitlines()
                           if ln.startswith("resumed from")), flush=True)
        if code != 0 or not wedged or "[watchdog] no heartbeat" not in err \
                or "[supervise] attempt 1 exited 42 (stall-kill)" not in err \
                or relaunches != 1 or out.count("resumed from") != 1 \
                or "HdGan_hd1_e1.pt (epoch 1)" not in out \
                or "HdGan_hd1_e2.pt" not in drill_saved:
            fail(f"loop: the wedge drill did not end in one resumed "
                 f"relaunch: exit {code}; stdout {out[-2000:]}; stderr "
                 f"{err[-3000:]}")
        _remat_runs(torch, tmp, train_list, card)
    return counts


def _conv3d_flops(torch, model, x):
    """Multiply-adds × 2 of every 3-D conv in one forward of ``model`` on
    ``x``: a conv's per output voxel and a transposed conv's per input
    voxel, each over its kernel and both channel counts."""
    from ctagan_tpu_torch.models.volumetric import (
        Conv3dTorch,
        ConvTranspose3dTorch,
    )

    total = [0]

    def hook(mod, inp, out):
        k = mod.weight[0, 0].numel() * mod.weight.shape[0] * \
            mod.weight.shape[1]
        vox = (inp[0] if isinstance(mod, ConvTranspose3dTorch) else out)
        total[0] += 2 * k * vox[:, 0].numel()

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (Conv3dTorch, ConvTranspose3dTorch))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hs:
            h.remove()
    return total[0]


def check_p3d(torch, card):
    """Phase 16, a main path: configs/P3d.yaml (the 3-D family, 512²,
    patch_depth 8, bf16, base 32, 6 blocks, b=1) through ``python -m
    ctagan_tpu_torch --mode train``'s ``train()``: one epoch on a seeded
    corpus, validated on the centre slices; the f32 first step beside the
    bf16 one; then ``--mode infer`` over a seeded series."""
    import math

    import numpy as np

    from ctagan_tpu_torch.__main__ import infer
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.models.volumetric import Generator3D
    from ctagan_tpu_torch.parallel.serve import load_series_fullrange
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        train_list = make_corpus(tmp, n_patients=P3D_PATIENTS,
                                 slices_per_patient=P3D_SLICES, size=512,
                                 seed=0, lists=("train",))["train"]
        val = _write_list(os.path.join(tmp, "val.txt"),
                          _read_list(train_list)[:P3D_SLICES])
        lists = {"train": train_list, "val": val, "test": val}
        extra = ("n_epochs: 1\ndecay_epoch: 0\nval_every: 1\n"
                 f"image_save: '{tmp}/img/'\n")
        config = load_config(_smoke_config(tmp, lists, extra,
                                           base="P3d.yaml"))
        trainer, counts, moved, peak = _train_family(torch, config,
                                                     P3D_PATIENTS)
        losses = trainer.loss_history
        p50 = trainer.timer.summary()["p50_ms"]
        g, d = trainer.g_model, trainer.d_model
        n_body = len(g.body)
        x = torch.zeros((1, config.patch_depth, config.size, config.size, 1),
                        device=dev)
        flops_g = _conv3d_flops(torch, g, x)
        flops_d = _conv3d_flops(torch, d, torch.cat([x, x], dim=-1))
        del trainer, g, d
        torch.cuda.empty_cache()
        saved = [f for f in os.listdir(os.path.join(tmp, "model"))
                 if f.startswith("P3d_p3d_e1_")]
        with open(os.path.join(tmp, "model", "P3d_val.csv")) as f:
            val_rows = f.read().split()
        # the first step again in f32, from the same seeds
        os.makedirs(os.path.join(tmp, "f32"))
        f32, _, _, f32_peak = _train_family(torch, load_config(_smoke_config(
            os.path.join(tmp, "f32"), lists,
            extra + "compute_dtype: float32\n", base="P3d.yaml")), 1)
        f32_losses = f32.loss_history
        del f32
        torch.cuda.empty_cache()
        # --mode infer over a seeded series, the generator found in
        # save_root by the lookup (the epoch's checkpoint)
        series_root = os.path.join(tmp, "series")
        make_corpus(series_root, n_patients=1, slices_per_patient=P3D_SERIES,
                    size=512, seed=9, lists=("train",))
        series = os.path.join(series_root, "patient0", "ST0", "SE0")
        reset_counts()
        times = {}
        t0 = time.perf_counter()
        out_dir = infer(config, dev, series, times)
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        infer_counts = launch_counts()
        px = _se2_series(torch, out_dir, series)
        state = torch.load(os.path.join(tmp, "model", saved[0]),
                           map_location="cpu", weights_only=True)["state"]
        g = Generator3D(1, 1, dtype=torch.bfloat16)
        g.load_state_dict(state["g"], strict=True)
        volume, paths = load_series_fullrange(series, size=config.size)
        with torch.no_grad():
            win = torch.from_numpy(volume[:config.patch_depth][None, ..., None]
                                   ).to(dev)
            direct = g.to(dev)(win)[0, :, :, :, 0].float().cpu().numpy()
        del g
        torch.cuda.empty_cache()
    stride = config.patch_depth // 2  # infer_volume_3d's half overlap
    worst = 0
    for i in range(stride):  # the slices only the first window covers
        want = ((direct[i].astype(np.float64) + 1.0) * 0.5 * 4095.0)
        got = px[os.path.basename(paths[i])]
        worst = max(worst, float(np.abs(got - want).max()))
    step_flops = 4 * flops_g + 8 * flops_d
    bound_ms = step_flops / PEAK_BF16 * 1e3
    gap = max(abs(f32_losses[0][k] - v) / max(abs(v), 1e-12)
              for k, v in losses[0].items())
    print(f"p3d P3d.yaml 512^2 x {config.patch_depth} bf16 b=1, Generator3D "
          f"base 32 x {n_body} blocks: {len(losses)} steps (one epoch), loss "
          f"keys {list(losses[0])}, last losses {losses[-1]}, all finite "
          f"{_finite(losses)}; largest parameter change "
          + ", ".join(f"{k} {v:.3e}" for k, v in moved.items())
          + f"; launches {counts}; val {val_rows}; saved {saved}; p50 step "
          f"{p50:.1f} ms (steps 2-{len(losses)}); peak memory "
          f"{peak / 2 ** 30:.3f} GiB; f32 first step {f32_losses[0]}, "
          f"largest relative gap to bf16 {gap:.3e} (tol {P3D_F32_TOL:.0e}), "
          f"f32 peak memory {f32_peak / 2 ** 30:.3f} GiB; forward FLOP G "
          f"{flops_g / 1e12:.3f} T, D {flops_d / 1e12:.4f} T, step (4 G + "
          f"8 D) {step_flops / 1e12:.3f} T = {bound_ms:.2f} ms at the bf16 "
          f"peak [{card}]", flush=True)
    print(f"p3d --mode infer over a {P3D_SERIES}-slice 512^2 series "
          f"(windows of {config.patch_depth}, Hann-blended): {infer_s:.3f} s "
          f"= {P3D_SERIES / infer_s:.2f} slices/s; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; launches {infer_counts}; first window's slices 0-"
          f"{stride - 1} vs a direct forward of the saved G: max "
          f"{worst:.1f} stored units (tol {INFER_PIXEL_TOL}) [{card}]",
          flush=True)
    if list(losses[0]) != P3D_LOSS_KEYS or not _finite(losses) \
            or len(losses) != P3D_PATIENTS:
        fail(f"p3d: losses {losses}")
    if min(moved.values()) <= 0.0:
        fail(f"p3d: a net was not updated {moved}")
    if counts != counts_of() or infer_counts != counts_of():
        fail(f"p3d: kernels launched {counts} / {infer_counts}")
    if len(saved) != 1 or len(val_rows) != 2 or not all(
            math.isfinite(float(v)) for v in val_rows[1].split(",")):
        fail(f"p3d: the epoch saved {saved}, validated {val_rows}")
    if gap > P3D_F32_TOL or not _finite(f32_losses):
        fail(f"p3d: the f32 first step is {gap:.3e} from the bf16 one")
    if worst > INFER_PIXEL_TOL:
        fail(f"p3d: the SE2 series is {worst} stored units from a direct "
             "forward of the saved G")
    return counts


def _demons_pair(torch, D, size, seed, dev="cuda", design="vessels"):
    """JAX's e2e registration fixture (``tests/test_registration3d.py``:
    smooth blobs, radii 3-8 voxels, z extents 2-4 slices, 20 per 64² × 8,
    stored values 1500·A + 200) grown to (D, size, size), made on ``dev``.
    With k = size/64, the organs are JAX's blobs with radii × k, so they
    fill the field of view, and (``design`` "scaled" and "vessels") their z
    extents × k too, 20 per 8k slices: z-thin blobs make every window
    z-dominated, the aperture case JAX's fixture avoids ("radii": z extents
    as JAX's, 20 per 8 slices). "vessels" adds fine structures, JAX's blobs
    at JAX's size, 20 per 8 slices per 64 columns. The moving volume is
    that anatomy under JAX's sine field (2 and 1.5 voxels in y and x, one
    wavelength over the width) plus an 80 HU contrast offset. Returns the
    two (D, size, size) f32 tensors of stored values, the anatomy A and the
    field's (dy, dx) as a function of the sample point."""
    import math

    import numpy as np

    dev = torch.device(dev)
    k = size / 64
    rng = np.random.default_rng(seed)

    def draw(n, scale, zscale):
        return [(rng.uniform(0, D), rng.uniform(size * 0.15, size * 0.85),
                 rng.uniform(size * 0.15, size * 0.85),
                 rng.uniform(3, 8) * scale, rng.uniform(0.3, 1.0),
                 rng.uniform(2.0, 4.0) * zscale) for _ in range(n)]

    if design == "radii":
        organs = draw(20 * D // 8, k, 1.0)
    else:
        organs = draw(round(20 * D / (8 * k)), k, k)
    vessels = draw(round(20 * D / 8 * k), 1.0, 1.0) \
        if design == "vessels" else []
    z = torch.arange(D, dtype=torch.float32, device=dev).view(D, 1, 1)
    y = torch.arange(size, dtype=torch.float32, device=dev).view(1, size, 1)
    x = torch.arange(size, dtype=torch.float32, device=dev).view(1, 1, size)

    def field(yy, xx):
        w = 2 * math.pi / size
        return (2.0 * torch.sin(w * yy) * torch.cos(w * xx),
                1.5 * torch.cos(w * yy) * torch.sin(w * xx))

    def blob(zz, yy, xx, cz, cy, cx, r, a, rz):
        return a * torch.exp(-(((zz - cz) / rz) ** 2 + ((yy - cy) / r) ** 2
                               + ((xx - cx) / r) ** 2) / 2)

    def anatomy(yy, xx):
        yy, xx = yy.expand(1, size, size), xx.expand(1, size, size)
        out = torch.zeros((D, size, size), device=dev)
        for b in organs:
            out += blob(z, yy, xx, *b)
        for b in vessels:  # within 4σ (+3 voxels of the field's reach)
            cz, cy, cx, r, _, rz = b
            z0, z1 = max(0, int(cz - 4 * rz)), min(D, int(cz + 4 * rz) + 1)
            y0 = max(0, int(cy - 4 * r - 3))
            y1 = min(size, int(cy + 4 * r) + 4)
            x0 = max(0, int(cx - 4 * r - 3))
            x1 = min(size, int(cx + 4 * r) + 4)
            out[z0:z1, y0:y1, x0:x1] += blob(
                z[z0:z1], yy[:, y0:y1, x0:x1], xx[:, y0:y1, x0:x1], *b)
        return out

    dy, dx = field(y, x)
    a0 = anatomy(y, x)
    fixed = a0 * 1500 + 200
    moving = anatomy(y + dy, x + dx) * 1500 + 200 + 80
    return fixed, moving, a0, field


def _write_series(dicom, root, pat, se, stored, pid):
    d = os.path.join(root, pat, "ST0", se)
    os.makedirs(d, exist_ok=True)
    for s in range(stored.shape[0]):
        dicom.write_dicom(dicom.make_ct_slice(
            stored[s], series_description="C-" if se == "SE0" else "C+",
            patient_id=pid, accession="A" + pid, slice_location=float(s),
            series_uid=f"1.2.{pid}.{se[-1]}"), os.path.join(d, f"IM{s}"))


def _corpus_cli(args, cwd):
    """``python -m ctagan_tpu_torch.data.corpus`` in a fresh interpreter
    that cannot import JAX or the JAX package; its standard output."""
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import runpy\n"
            "sys.argv = ['corpus'] + sys.argv[1:]\n"
            "runpy.run_module('ctagan_tpu_torch.data.corpus', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    res = subprocess.run([sys.executable, "-c", code] + args, cwd=cwd,
                         env=env, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"corpus CLI {args}: {res.stderr[-2000:]}")
    return res.stdout


def check_corpus(torch, card):
    """Phase 17, a main path: the offline corpus stage. (a)
    ``demons_register`` on the card against the CPU; (b) ``align_patient``
    on a 512² × 128-slice patient, its registrar reaching the card by
    itself; (c) the corpus CLI on the registered tree and three more
    patients, then ``--stats`` and ``--equip-split`` on its lists."""
    import numpy as np

    from ctagan_tpu_torch.data import dicom, registration
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.data.registration import _load_series
    from ctagan_tpu_torch.ops import registration3d as reg3d

    # (a) the card against the CPU
    fixed, moving, _, _ = _demons_pair(torch, *CORPUS_A_SHAPE[:2], seed=1)
    fixed, moving = fixed.cpu().numpy(), moving.cpu().numpy()
    t0 = time.perf_counter()
    phi_cpu = reg3d.demons_register(fixed, moving, device="cpu")
    cpu_s = time.perf_counter() - t0
    card_s = []
    phis = []
    for _ in range(2):
        t0 = time.perf_counter()
        phis.append(reg3d.demons_register(fixed, moving))
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
    err = float((phis[0].cpu() - phi_cpu).abs().max())
    same = torch.equal(phis[0], phis[1])
    print(f"corpus (a) demons_register {'x'.join(map(str, CORPUS_A_SHAPE))}, "
          f"levels 3, iterations 30/40/60: card {card_s[0]:.3f} s (repeat "
          f"{card_s[1]:.3f} s), CPU {cpu_s:.3f} s; max |φ card − φ CPU| "
          f"{err:.3e} voxel (tol {CORPUS_PHI_TOL:.0e}), |φ| max "
          f"{float(phi_cpu.abs().max()):.3f}; repeat bit-equal {same} "
          f"[{card}]", flush=True)
    if phis[0].device.type != "cuda" or err > CORPUS_PHI_TOL or not same:
        fail(f"corpus (a): φ on {phis[0].device} {err:.3e} voxel from the "
             f"CPU's, repeat bit-equal {same}")
    del phis, phi_cpu

    with tempfile.TemporaryDirectory() as tmp:
        # (b) align_patient at full size
        root, pid = os.path.join(tmp, "tree"), "REG0"
        t0 = time.perf_counter()
        fixed, moving, anatomy, field = _demons_pair(
            torch, CORPUS_SLICES, CORPUS_SIZE, seed=0)
        stored = {se: v.clamp(0, 4095).to(torch.int32).cpu().numpy()
                  .astype(np.uint16) for se, v in (("SE0", fixed),
                                                   ("SE1", moving))}
        for se, v in stored.items():
            _write_series(dicom, root, "pat0", se, v, pid)
        make_s = time.perf_counter() - t0
        # spies keep the rigid pre-shift and the field align_patient's
        # registrar found
        seen = {}
        demons = reg3d.demons_register
        shift_of = registration.phase_correlation_shift

        def demons_spy(f, m, **kw):
            seen["phi"] = demons(f, m, **kw)
            return seen["phi"]

        def shift_spy(f, m):
            seen["shift"] = shift_of(f, m)
            return seen["shift"]

        times = {}
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the fixture's tensors
        reg3d.demons_register = demons_spy
        registration.phase_correlation_shift = shift_spy
        try:
            t0 = time.perf_counter()
            used = registration.align_patient(root, "pat0", times=times)
            align_s = time.perf_counter() - t0
        finally:
            reg3d.demons_register = demons
            registration.phase_correlation_shift = shift_of
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        base = os.path.join(root, "pat0", "ST0")
        se0, _ = _load_series(os.path.join(base, "SE0"))
        se1, _ = _load_series(os.path.join(base, "SE1"))
        target = (fixed.cpu().numpy() + 80.0 - 1024.0)[:-1, 4:-4, 4:-4]
        before = float(np.abs(stored["SE1"][:-1, 4:-4, 4:-4] - 1024.0
                              - target).mean())
        after = float(np.abs(se1[:-1, 4:-4, 4:-4] - target).mean())
        last = float(np.abs(se1[-1] - (stored["SE1"][-1] - 1024.0)).max())
        se0_same = np.array_equal(se0, stored["SE0"].astype(np.float32)
                                  - 1024.0)
        # the residual r = φ(x) − s + u(x + φ(x) − s) over the anatomy: the
        # registrar aligned the moving volume rolled by the pre-shift s, and
        # u is the sine field that made the moving volume (no z component)
        phi, shift = seen["phi"], [float(v) for v in seen["shift"]]
        d, h, w = phi.shape[:3]
        ry = phi[..., 1] - shift[1]
        rx = phi[..., 2] - shift[2]
        uy, ux = field(torch.arange(h, device=phi.device).view(1, h, 1) + ry,
                       torch.arange(w, device=phi.device).view(1, 1, w) + rx)
        epe = torch.sqrt((phi[..., 0] - shift[0]) ** 2 + (ry + uy) ** 2
                         + (rx + ux) ** 2)[anatomy > 0.1]
        epe_mean = float(epe.mean())
        phi_dev = phi.device.type
        del fixed, moving, anatomy, phi, ry, rx, uy, ux, epe, seen
        torch.cuda.empty_cache()
        print(f"corpus (b) align_patient on a {CORPUS_SLICES}-slice "
              f"{CORPUS_SIZE}^2 patient (made and written in {make_s:.3f} "
              f"s): {used!r} in {align_s:.3f} s, the registrar's φ on "
              f"{phi_dev}; "
              + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
              + f"; the call's peak device memory {peak / 2 ** 30:.3f} GiB; "
              f"interior |error| {before:.3f} -> {after:.3f} HU = "
              f"{before / after:.2f}x "
              f"(bar {CORPUS_CUT:.0f}x); mean EPE over the anatomy "
              f"{epe_mean:.3f} voxel (rigid pre-shift {shift}); SE0 "
              f"unchanged {se0_same}; last slice {last:.1f} stored units "
              f"from the unwarped one; launches {counts} [{card}]",
              flush=True)
        if used != "demons" or phi_dev != "cuda":
            fail(f"corpus (b): align_patient used {used!r}, φ on {phi_dev}")
        if not se0_same or last > 1.0 or before < CORPUS_CUT * after:
            fail(f"corpus (b): SE0 unchanged {se0_same}, last slice {last}, "
                 f"error {before:.3f} -> {after:.3f}")
        if counts != counts_of():
            fail(f"corpus: kernels launched {counts}")

        # (c) the corpus CLI, in a fresh interpreter
        make_corpus(root, n_patients=CORPUS_EXTRA,
                    slices_per_patient=CORPUS_EXTRA_SLICES,
                    size=CORPUS_SIZE, seed=5, lists=("extra",))
        out = os.path.join(tmp, "lists")
        t0 = time.perf_counter()
        built = _corpus_cli([root, "--out", out], tmp)
        lists = {n: _read_list(os.path.join(out, f"{n}.txt"))
                 for n in ("train", "val", "test")}
        stats = {n: _corpus_cli([os.path.join(out, f"{n}.txt"), "--stats"],
                                tmp) for n, ps in lists.items() if ps}
        equip = _corpus_cli([os.path.join(out, "test.txt"),
                             "--equip-split", "--out", out], tmp)
        cli_s = time.perf_counter() - t0
        patients = {n: {p.split(os.sep)[-4] for p in ps}
                    for n, ps in lists.items()}
        listed = sum(len(ps) for ps in lists.values())
        stat_slices = sum(int(re.search(r"slices (\d+)", v).group(1))
                          for v in stats.values())
        want = CORPUS_SLICES + CORPUS_EXTRA * CORPUS_EXTRA_SLICES
        print(f"corpus (c) python -m ctagan_tpu_torch.data.corpus on "
              f"{CORPUS_EXTRA + 1} patients, then --stats and --equip-split "
              f"({cli_s:.3f} s, {2 + len(stats)} interpreters): "
              f"{built.strip()}; "
              + "; ".join(f"{n} {v.strip()}" for n, v in stats.items())
              + f"; equip split {equip.strip()} [{card}]", flush=True)
        paired = all(os.path.exists(p) and os.path.exists(
            p.replace(os.sep + "SE0" + os.sep, os.sep + "SE1" + os.sep))
            for ps in lists.values() for p in ps)
        disjoint = sum(len(v) for v in patients.values()) == len(
            set().union(*patients.values()))
        if not (paired and disjoint) or listed != want \
                or stat_slices != listed:
            fail(f"corpus (c): paired {paired}, disjoint {disjoint}, "
                 f"{listed} listed, {stat_slices} by --stats, {want} made")
    return counts


# -- the dp phase --------------------------------------------------------------

def _hd_weights(trainer):
    """G's, R's and D's weights on the host, by net."""
    return {net: {k: v.detach().cpu().clone()
                  for k, v in getattr(trainer, attr).state_dict().items()}
            for net, attr in (("G", "g_model"), ("R", "r_model"),
                              ("D", "d_model"))}


def _hd_digest(trainer):
    """G's, R's and D's weights that every rank holds whole (under tp the
    split slices are left out) as one number, reduced on the device (no
    copy to the host inside the timed step): each tensor's bit patterns as
    int64, weighted by their position and summed, one pull for all. A
    changed bit anywhere changes it, barring a coincidence."""
    import torch

    from ctagan_tpu_torch.parallel import tensor

    sums = []
    for attr in ("g_model", "r_model", "d_model"):
        net = getattr(trainer, attr)
        split = set(tensor.split_params(net))
        for v in net.state_dict(keep_vars=True).values():
            if v in split:
                continue
            bits = v.detach().reshape(-1).view(torch.int32).long()
            pos = torch.arange(1, bits.numel() + 1, device=bits.device)
            sums.append((bits * pos).sum())
    total = 0
    for x in torch.stack(sums).tolist():
        total = total * 1000003 + x
    return total % (1 << 64)


def _hd_first_moments(trainer):
    """Adam's first moment of each parameter, by net (after the run)."""
    st = trainer.state
    return {net: {k: opt.state[p]["exp_avg"].detach().cpu().clone()
                  for k, p in getattr(trainer, attr).named_parameters()}
            for net, attr, opt in (("G", "g_model", st.g_opt),
                                   ("R", "r_model", st.r_opt),
                                   ("D", "d_model", st.d_opt))}


def _dp_held(got, want, ref):
    """``got`` against ``want`` (weights or first moments, by net), as the
    grad phase holds a route: by net, ||got − want|| <= GRAD_RATIO ·
    ||ref − want|| + GRAD_TOL · ||want|| (Frobenius over the net), ``ref``
    a repeat of ``want``'s run: the card's float atomics, which f32
    training amplifies (the one-pass InstanceNorm variance, Adam's steps
    of ±lr on the conv biases before an InstanceNorm, whose gradient is
    rounding alone), set that distance. Returns ({net: (||got − want||,
    ||ref − want||, ||want||)}, held)."""
    out, held = {}, True
    for net, ws in want.items():
        d_got = d_ref = norm = 0.0
        for k, w in ws.items():
            w = w.double()
            d_got += float((got[net][k].double() - w).norm()) ** 2
            d_ref += float((ref[net][k].double() - w).norm()) ** 2
            norm += float(w.norm()) ** 2
        d_got, d_ref, norm = d_got ** 0.5, d_ref ** 0.5, norm ** 0.5
        out[net] = (d_got, d_ref, norm)
        held = held and d_got <= GRAD_RATIO * d_ref + GRAD_TOL * norm
    return out, held


def _dp_line(dists):
    return "; ".join(f"{net} {g:.3e} (repeat {r:.3e}, norm {n:.3e})"
                     for net, (g, r, n) in dists.items())


def _dp_run(torch, config, dev, steps, group=False):
    """``__main__.train`` for ``steps`` steps, the counts from 0; with
    ``group``, in a process group of one under NCCL (torchrun's env set in
    this process for the call), every gradient all-reduce checked to return
    its input bit for bit. Returns a dict: the weights and first moments
    after the run (``w``, ``mu``) and after step 1 (``w1``, ``mu1``), the
    counts, the p50 step, the losses, the all-reduce checks."""
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.parallel import dist, fsdp
    from ctagan_tpu_torch.train import trainers

    with socket.socket() as s:  # a free port for the group's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    reduce, step = dist.all_reduce_mean_, trainers.HdTrainerStage1._step
    out = {"checks": []}

    def checked(tensors, group=None):
        before = [t.clone() for t in tensors]
        reduce(tensors, group)
        if dist.initialized():
            out["checks"].append(all(torch.equal(a, b)
                                      for a, b in zip(before, tensors)))

    def spy(self, batch, lr, lr_d):
        res = step(self, batch, lr, lr_d)
        if "w1" not in out:
            out.update(w1=_hd_weights(self), mu1=_hd_first_moments(self))
        return res

    if group:
        os.environ.update(env)
        dev = dist.init(dev)
        if dist.world() != 1 or dist.rank() != 0:
            fail(f"dp: a group of one came up as {dist.world()} ranks")
    dist.all_reduce_mean_, trainers.HdTrainerStage1._step = checked, spy
    try:
        reset_counts()
        trainer = train(config, dev, max_steps=steps)
        torch.cuda.synchronize()
        out["counts"] = launch_counts()
    finally:
        dist.all_reduce_mean_, trainers.HdTrainerStage1._step = reduce, step
        if group:
            dist.shutdown()
            for k in env:
                os.environ.pop(k, None)
    out.update(w=_hd_weights(trainer), mu=_hd_first_moments(trainer),
               p50=trainer.timer.summary(skip=1)["p50_ms"],
               losses=trainer.loss_history,
               state_bytes=fsdp.state_bytes_per_rank(trainer.state))
    del trainer
    torch.cuda.empty_cache()
    return out


def dp_worker(torch, tmp, name="dp"):
    """One rank of the dp phase's world, or with ``name`` of an fsdp or tp
    phase's (two gloo ranks on one card; on a machine with several cards a
    rank a card under NCCL): DP_STEPS steps of ``tmp``/<name>_train.yaml
    after the file ``tmp``/<name>_go appears, each collective inside a step
    timed by CUDA events and the host clock, with its bytes; under dp and
    tp a digest of G, R and D (under tp their replicated weights) after
    every step; under fsdp and tp the resting state's bytes and a
    checkpoint (rank 0 writes it); then test() of ``tmp``/<name>_test.yaml
    (the plain route) and of ``tmp``/<name>_test_k.yaml (the kernel route);
    under tp last ``infer_tensor_sharded`` of a seeded G, timed (each rank
    saves its output in <name>_fwd<r>.pt). Results in ``tmp``/<name>_rank<r>.json, rank
    0's weights (the gathered ones under fsdp and tp) in <name>_rank0.pt."""
    import torch.distributed as tdist

    from ctagan_tpu_torch.__main__ import test as run_test
    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.parallel import dist, fsdp
    from ctagan_tpu_torch.train import trainers
    from ctagan_tpu_torch.utils.config import load_config

    marks = [time.time()]  # entry, the group, the go, the steps, test()
    dev = (dist.init(torch.device("cuda")) if torch.cuda.device_count() > 1
           else dist.init(torch.device("cuda", 0), backend="gloo"))
    marks.append(time.time())
    while not os.path.exists(os.path.join(tmp, f"{name}_go")):  # (a) runs
        time.sleep(0.05)
    marks.append(time.time())
    rank = dist.rank()
    digests, colls, done, in_step = [], [], [0], [False]
    # each collective's tensor whose bytes count: the reduced buffer, the
    # gathered one, the one scattered
    moved = {"all_reduce": 0, "all_gather_into_tensor": 0,
             "reduce_scatter_tensor": 1}
    originals = {kind: getattr(tdist, kind) for kind in moved}

    def timed(kind):
        def call(*args, **kw):
            if not in_step[0]:
                return originals[kind](*args, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            h0 = time.perf_counter()
            ev[0].record()
            res = originals[kind](*args, **kw)
            ev[1].record()
            t = args[moved[kind]]
            colls.append((kind, done[0], ev, t.numel() * t.element_size(),
                          time.perf_counter() - h0))
            return res
        return call

    step = trainers.HdTrainerStage1._step

    first = {}

    def spy(self, batch, lr, lr_d):
        in_step[0] = True
        try:
            out = step(self, batch, lr, lr_d)
        finally:
            in_step[0] = False
        done[0] += 1
        if not fsdp.is_sharded(self.state):
            digests.append(_hd_digest(self))
        if not first:
            with trainers._one_process(self.state):
                first.update(w1=_hd_weights(self),
                             mu1=_hd_first_moments(self))
        return out

    for kind in moved:
        setattr(tdist, kind, timed(kind))
    trainers.HdTrainerStage1._step = spy
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        reset_counts()
        trainer = train(load_config(os.path.join(tmp, f"{name}_train.yaml")),
                        dev, max_steps=DP_STEPS)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        for kind, fn in originals.items():
            setattr(tdist, kind, fn)
        trainers.HdTrainerStage1._step = step
    marks.append(time.time())
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {kind: [{"ms": 0.0, "host_ms": 0.0, "bytes": 0, "calls": 0}
                       for _ in range(DP_STEPS)] for kind in moved}
    for kind, i, ev, nbytes, host_s in colls:
        s = per_step[kind][i]
        s["ms"] += ev[0].elapsed_time(ev[1])
        s["host_ms"] += host_s * 1e3
        s["bytes"] += nbytes
        s["calls"] += 1
    res = {"digests": digests, "losses": trainer.loss_history,
           "counts": counts, "reduce": per_step["all_reduce"],
           "gather": per_step["all_gather_into_tensor"],
           "scatter": per_step["reduce_scatter_tensor"], "peak": peak,
           "p50_ms": trainer.timer.summary(skip=1)["p50_ms"],
           "state_bytes": fsdp.state_bytes_per_rank(trainer.state)}
    if trainers._sharded(trainer.state):
        res["pt"] = trainer._save(trainer._current_epoch)
    with trainers._one_process(trainer.state):
        weights = dict(first, w=_hd_weights(trainer),
                       mu=_hd_first_moments(trainer))
    if rank == 0:
        torch.save(weights, os.path.join(tmp, f"{name}_rank0.pt"))
    plan = trainer.plan
    del trainer, weights
    torch.cuda.empty_cache()
    reset_counts()
    torch.backends.cudnn.deterministic = True  # as the one process's test()
    _, agg, secs = run_test(load_config(os.path.join(
        tmp, f"{name}_test.yaml")), dev)
    torch.cuda.synchronize()
    res.update(test_counts=launch_counts(), agg=agg, test_s=secs)
    reset_counts()
    torch.backends.cudnn.deterministic = False
    _, agg, secs = run_test(load_config(os.path.join(
        tmp, f"{name}_test_k.yaml")), dev)
    torch.cuda.synchronize()
    marks.append(time.time())
    res.update(test_k_counts=launch_counts(), agg_k=agg, test_k_s=secs,
               marks=marks)
    if plan.kind == "tp":
        from ctagan_tpu_torch.parallel import tensor

        mesh = tensor.make_tp_mesh(plan.dp, plan.tp)
        g, x = _tp_forward_g(torch, dev), _tp_forward_input(torch, dev)
        calls = []
        for _ in range(TP_FORWARD_CALLS):
            t0 = time.perf_counter()
            out = tensor.infer_tensor_sharded(g, x, mesh,
                                              data_parallel=plan.dp > 1)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
        # its parts: G copied and split, then the split forward alone, its
        # sums timed by CUDA events
        t0 = time.perf_counter()
        split = tensor.shard_module_tp(copy.deepcopy(g), mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sums = []

        def timed_sum(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out_ = originals["all_reduce"](*args, **kw)
            ev[1].record()
            sums.append(ev)
            return out_

        tdist.all_reduce = timed_sum
        try:
            with torch.no_grad():
                split(x if plan.dp == 1 else x[:len(x) // plan.dp])
            torch.cuda.synchronize()
        finally:
            tdist.all_reduce = originals["all_reduce"]
        res["fwd_s"] = calls + [t1 - t0, time.perf_counter() - t1]
        res["fwd_sums_ms"] = [e[0].elapsed_time(e[1]) for e in sums]
        torch.save(out.cpu(), os.path.join(tmp, f"{name}_fwd{rank}.pt"))
    with open(os.path.join(tmp, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    return 0


def check_dp_group_of_one(torch, config, dev, t_corpus, card):
    """(a): DP_W1_STEPS steps in a process group of one under NCCL against
    the same steps without a group, twice. Returns the group's counts and
    the p50 step of the first run without a group."""
    t0 = time.perf_counter()
    a, b, c = (_dp_run(torch, config, dev, DP_W1_STEPS, group=g)
               for g in (False, True, False))
    t_a = time.perf_counter() - t0
    repeat = all(torch.equal(c["w"][n][k], v)
                 for n in a["w"] for k, v in a["w"][n].items())
    equal = all(torch.equal(b["w"][n][k], v)
                for n in a["w"] for k, v in a["w"][n].items())
    dist_b, ok_b = _dp_held(b["w"], a["w"], c["w"])
    counts, checks = b["counts"], b["checks"]
    expect = {k: v * DP_W1_STEPS for k, v in PER_TRAIN_STEP.items()}
    print(f"dp (a) HdGan.yaml 512^2 b=1 f32 kernel route (cuDNN TF32 "
          f"off), {DP_W1_STEPS} steps in a group of one under NCCL: "
          f"{len(checks)} gradient all-reduces, each returning its input "
          f"bit for bit {all(checks)}; weights bit-equal to the run "
          f"without a group {equal} (two runs without a group bit-equal "
          f"{repeat}); group vs none by net: {_dp_line(dist_b)}; losses "
          f"step 1 {b['losses'][0]} vs {a['losses'][0]}; launches "
          f"{counts} (expected {expect}); the corpus {t_corpus:.1f} s, "
          f"the three runs {t_a:.1f} s [{card}]", flush=True)
    if len(checks) != 2 * DP_W1_STEPS or not all(checks):
        fail(f"dp (a): the all-reduces of a group of one {checks}")
    if counts != expect:
        fail(f"dp (a) launches {counts}, expected {expect}")
    if (repeat and not equal) or not ok_b:
        fail("dp (a): a group of one moved the weights off the run "
             "without a group")
    return counts, a["p50"]


def _dp_corpus(tmp):
    """The dp and fsdp phases' seeded corpus of DP_PATIENTS patients of
    DP_SLICES 512² slices, trained on the first patient's, validated and
    tested on all: (the lists, every path, ``yaml(name, extra)``, which
    writes ``tmp``/<name>.yaml, configs/HdGan.yaml with its checkpoints in
    ``tmp``/<name>/ and its SE2 tree in ``tmp``/<name>_img/, then
    ``extra``, and returns its path)."""
    from ctagan_tpu_torch.data.fixtures import make_corpus

    lists = make_corpus(tmp, n_patients=DP_PATIENTS,
                        slices_per_patient=DP_SLICES, size=512, seed=0,
                        lists=("train",))
    paths = _read_list(lists["train"])
    lists = {"train": _write_list(os.path.join(tmp, "patient0.txt"),
                                  paths[:DP_SLICES]),
             "val": lists["train"], "test": lists["train"]}

    def yaml(name, extra=""):
        path = _smoke_config(tmp, lists, f"save_root: '{tmp}/{name}/'\n"
                             f"image_save: '{tmp}/{name}_img/'\n" + extra)
        shutil.move(path, os.path.join(tmp, f"{name}.yaml"))
        return os.path.join(tmp, f"{name}.yaml")

    return lists, paths, yaml


def _hd_param_counts(torch):
    """The parameters of HD stage 1's G, R and D at full width."""
    from ctagan_tpu_torch.models import Discriminator, Generator, RegNet

    return [sum(p.numel() for p in m.parameters())
            for m in (Generator(1, 1), RegNet(), Discriminator())]


def check_dp(torch, card):
    """Phase 18, a main path: the data-parallel plan on HD stage 1 through
    the entry points' ``train()`` and ``test()``: (a) a group of one under
    NCCL against no group; (b) two gloo ranks on the one card against one
    process on the same global batch; (c) test() over the two ranks against
    one process."""
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lists, paths, yaml = _dp_corpus(tmp)
        # (b) two gloo ranks on the one card (several cards: a rank a card
        # under NCCL), and (c) their test(); the ranks start (their imports
        # and group) while (a) runs, and wait for dp_go before their steps
        nccl = torch.cuda.device_count() > 1
        world = torch.cuda.device_count() if nccl else DP_WORLD
        how = "a card each (NCCL)" if nccl else "on one card (gloo)"
        yaml("dp_train")
        # test() on the plain route with cuDNN's deterministic algorithms
        # (dp_worker sets them too): the same bits run to run; and on the
        # default kernel route, held as DP_KERNEL_METRIC_TOL says
        plain = "fused_body_grad: off\n"
        yaml("dp_test", plain + f"eval_batch: {world}\n")
        yaml("dp_test_k", f"eval_batch: {world}\n")
        t_corpus, t_wall = time.perf_counter() - t0, time.time()
        ranks_proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", os.path.abspath(__file__),
             "--dp-worker", tmp])
        try:
            # (a) a group of one under NCCL against no group, twice
            counts, p50_w1 = check_dp_group_of_one(
                torch, load_config(yaml("dp_a")), dev, t_corpus, card)
            open(os.path.join(tmp, "dp_go"), "w").close()
            t0 = time.perf_counter()
            rc = ranks_proc.wait()
        finally:
            if ranks_proc.poll() is None:
                ranks_proc.terminate()
                ranks_proc.wait()
        w2_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"dp: a rank exited {rc}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
                ranks.append(json.load(f))
        r0 = torch.load(os.path.join(tmp, "dp_rank0.pt"))
        # one process on the same global batch, a slice at a time: the same
        # forwards and backwards as the ranks', the two gradients summed on
        # one card (f32 training amplifies any other order past GRAD_TOL:
        # the one-pass InstanceNorm variance), twice, for the card's
        # run-to-run distance
        cfg_one = load_config(yaml(
            "dp_one", f"batchSize: {world}\ngrad_accum: {world}\n"))
        one, one2 = (_dp_run(torch, cfg_one, dev, DP_STEPS) for _ in "12")
        # step 1's global-batch gradient (Adam's first moment, a half of
        # it), then the weights after DP_STEPS steps
        grad_2, ok_g = _dp_held(r0["mu1"], one["mu1"], one2["mu1"])
        dist_2, ok_2 = _dp_held(r0["w"], one["w"], one2["w"])
        exact, repeat = (all(torch.equal(w[n][k], v) for n in one["w"]
                             for k, v in one["w"][n].items())
                         for w in (r0["w"], one2["w"]))
        n_params = sum(_hd_param_counts(torch))
        # every gradient in f32, and the step's 4 G-phase and 1 D-phase
        # loss values
        want_bytes = 4 * n_params + 4 * 5
        expect = {k: v * DP_STEPS for k, v in PER_TRAIN_STEP.items()}
        for r, res in enumerate(ranks):
            steps_ = res["reduce"]
            print(f"dp (b) rank {r} of {world} {how}: "
                  f"{DP_STEPS} steps at batchSize 1 (global batch "
                  f"{world}), p50 step {res['p50_ms']:.1f} ms (world 1 "
                  f"{p50_w1:.1f} ms); all-reduce per step "
                  + ", ".join(f"{s['ms']:.2f} ms (host {s['host_ms']:.2f})"
                              for s in steps_)
                  + f" of {steps_[0]['bytes']} bytes (G + R + D gradients "
                  f"and 5 losses: {want_bytes}); peak memory "
                  f"{res['peak'] / 2**30:.3f} GiB; launches "
                  f"{res['counts']} (expected {expect}); losses "
                  f"{res['losses']}; seconds from the launch to the rank's "
                  f"start, group, go (after (a)), steps and test() done "
                  f"{[round(m - t_wall, 1) for m in res['marks']]} "
                  f"[{card}]", flush=True)
            if res["counts"] != expect:
                fail(f"dp (b): rank {r} launches {res['counts']}")
            if any(s["bytes"] != want_bytes for s in steps_):
                fail(f"dp (b): rank {r} reduced {steps_}, expected "
                     f"{want_bytes} bytes a step")
        same = [len(set(d)) == 1
                for d in zip(*(res["digests"] for res in ranks))]
        loss_one = one["losses"]
        first = [abs(ranks[0]["losses"][0][k] - loss_one[0][k])
                 / max(abs(loss_one[0][k]), 1e-12) for k in loss_one[0]]
        print(f"dp (b): the ranks' G, R and D bit-identical after each step "
              f"{same}; rank 0 bit-equal to one process at batchSize "
              f"{world} and grad_accum {world} after {DP_STEPS} steps "
              f"{exact} (two runs of it "
              f"bit-equal {repeat}); against it "
              f"(||rank 0 - one||, ||a repeat of one - one||, ||one||; tol "
              f"{GRAD_RATIO} x repeat + {GRAD_TOL} x norm): step 1's "
              f"gradient by net {_dp_line(grad_2)}; the weights after "
              f"{DP_STEPS} steps by net {_dp_line(dist_2)}; first-step losses "
              f"{ranks[0]['losses'][0]} vs {loss_one[0]} (largest relative "
              f"{max(first):.2e}); one process's p50 {one['p50']:.1f} ms, "
              f"launches {one['counts']}; the world's wall from the go "
              f"{w2_s:.1f} s "
              f"[{card}]", flush=True)
        if len(same) != DP_STEPS or not all(same):
            fail(f"dp (b): the ranks' weights differ after a step {same}")
        # two gradients sum to the same bits in either order; more do not
        if (repeat and not exact and world == 2) or not (ok_g and ok_2) \
                or max(first) > FAMILY_ROUTE_TOL:
            fail("dp (b): two ranks moved off one process's steps")

        # (c) one process's test() at a slice a forward, as each rank's
        one_tests = _one_process_tests(torch, dev, yaml, tmp, "dp", plain)
        _held_rank_tests(torch, ranks, one_tests, paths, world, tmp, "dp",
                         "dp (c)", card)
        if nccl:
            _dp_launcher(tmp, lists, world, card)
    return counts


def _one_process_tests(torch, dev, yaml, tmp, prefix, plain):
    """One process's test() at eval_batch 1, as each rank of a world
    forwards a slice at a time: on the plain route (``plain``'s config
    lines) with cuDNN's deterministic algorithms, then twice on the default
    kernel route with cuDNN's defaults (the second without the writeback,
    for the card's run-to-run distance)."""
    from ctagan_tpu_torch.__main__ import test as run_test
    from ctagan_tpu_torch.utils.config import load_config

    reset_counts()
    torch.backends.cudnn.deterministic = True
    try:
        _, agg, secs = run_test(load_config(yaml(f"{prefix}_one_test",
                                                 plain)), dev)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"agg": agg, "secs": secs, "counts": launch_counts(),
           "tree": f"{tmp}/{prefix}_one_test_img"}
    config = load_config(yaml(f"{prefix}_one_test_k", ""))
    reset_counts()
    _, agg_k, secs_k = run_test(config, dev)
    torch.cuda.synchronize()
    out.update(agg_k=agg_k, secs_k=secs_k, counts_k=launch_counts(),
               tree_k=f"{tmp}/{prefix}_one_test_k_img")
    _, out["repeat_k"], _ = run_test(config, dev, write_dicom=False)
    return out


def _held_rank_tests(torch, ranks, one, paths, world, tmp, name, label,
                     card):
    """(c): the ranks' test() (:func:`dp_worker`, at eval_batch ``world``)
    against one process's (:func:`_one_process_tests`): on the plain route
    the 8 metrics within DP_METRIC_TOL (relative beyond 1) and the SE2
    trees file for file and pixel for pixel, no kernel launched; on the
    default training route (the body through K1, 18 launches a forward on
    each rank) each metric within GRAD_RATIO × the one process's distance
    in a repeat + DP_KERNEL_METRIC_TOL (relative beyond 1), the SE2 pixels
    within DP_KERNEL_PIXELS."""
    import math

    import numpy as np

    agg1 = one["agg"]
    tree1 = _read_se2_tree(one["tree"], paths)
    tree2 = _read_se2_tree(f"{tmp}/{name}_test_img", paths)
    px = max(int(np.abs(tree2[n] - tree1[n]).max()) for n in tree1)
    moved = sum(int((tree2[n] != tree1[n]).sum()) for n in tree1)
    errs = {k: abs(ranks[0]["agg"][k] - agg1[k]) for k in agg1}
    half = len(paths) // world
    print(f"{label} test() of {len(paths)} slices on the plain route at "
          f"eval_batch {world} over {world} ranks "
          f"({ranks[0]['test_s']:.2f} "
          f"s, {half} forwards a rank; launches "
          f"{[res['test_counts'] for res in ranks]}) vs one process at "
          f"eval_batch 1 ({one['secs']:.2f} s): metric distances {errs} (tol "
          f"{DP_METRIC_TOL}); SE2 trees of {len(tree1)} files, largest "
          f"pixel distance {px} stored units, {moved} pixels moved "
          f"[{card}]", flush=True)
    if any(res["test_counts"] != counts_of() for res in ranks) or \
            one["counts"] != counts_of():
        fail(f"{label}: the plain route's test() launched a kernel")
    if any(res["agg"] != ranks[0]["agg"] for res in ranks):
        fail(f"{label}: the ranks' aggregates differ")
    if any(e > DP_METRIC_TOL * max(1.0, abs(agg1[k]))
           for k, e in errs.items()) or sorted(tree1) != sorted(tree2) \
            or px:
        fail(f"{label}: test() over the ranks differs from one process")

    one_k = one["agg_k"]
    tree1 = _read_se2_tree(one["tree_k"], paths)
    tree2 = _read_se2_tree(f"{tmp}/{name}_test_k_img", paths)
    px = max(int(np.abs(tree2[n] - tree1[n]).max()) for n in tree1)
    moved = sum(int((tree2[n] != tree1[n]).sum()) for n in tree1)
    errs = {k: abs(ranks[0]["agg_k"][k] - v) for k, v in one_k.items()}
    noise = {k: abs(one["repeat_k"][k] - v) for k, v in one_k.items()}
    limit = {k: GRAD_RATIO * noise[k]
             + DP_KERNEL_METRIC_TOL * max(1.0, abs(v))
             for k, v in one_k.items()}
    forwards = math.ceil(len(paths) / world)
    want = counts_of(conv3x3_reflect_stats=18 * forwards)
    print(f"{label} test() of {len(paths)} slices on the kernel route "
          f"(fused_body_grad auto: the body through K1; cuDNN's "
          f"defaults) at eval_batch {world} over {world} ranks "
          f"({ranks[0]['test_k_s']:.2f} s; launches "
          f"{[res['test_k_counts'] for res in ranks]}, expected {want}) vs "
          f"one process at eval_batch 1 ({one['secs_k']:.2f} s; launches "
          f"{one['counts_k']}): metric distances {errs}; a repeat of the one "
          f"process, its distances {noise}; limits {limit}; SE2 "
          f"trees of {len(tree1)} files, largest pixel distance {px} stored "
          f"units (tol {DP_KERNEL_PIXELS}), {moved} pixels moved [{card}]",
          flush=True)
    if any(res["test_k_counts"] != want for res in ranks):
        fail(f"{label}: the kernel route's test() over the ranks launched "
             f"{[res['test_k_counts'] for res in ranks]}, expected {want}")
    if any(res["agg_k"] != ranks[0]["agg_k"] for res in ranks):
        fail(f"{label}: the ranks' kernel-route aggregates differ")
    if sorted(one_k) != sorted(ranks[0]["agg_k"]) or any(
            errs[k] > limit[k] for k in one_k) or \
            sorted(tree1) != sorted(tree2) or px > DP_KERNEL_PIXELS:
        fail(f"{label}: test() on the kernel route over the ranks differs "
             "from one process")


def _dp_launcher(tmp, lists, world, card):
    """(d), on a machine with several cards: ``python -m ctagan_tpu_torch
    --mode train`` in a fresh interpreter starts a rank a card itself
    through torchrun (``data_parallel``'s default): an epoch cut at 2
    global batches (``--max-steps 2``) with its validation; one checkpoint,
    one row of each CSV (rank 0 writes them)."""
    paths = _read_list(lists["train"])[:2 * world]
    sub = os.path.join(tmp, "dp_launch")
    os.makedirs(sub)
    lst = _write_list(os.path.join(sub, "train.txt"), paths)
    config = _smoke_config(sub, lst, "n_epochs: 1\ndecay_epoch: 0\n"
                           "val_every: 1\nlog_every: 1\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "ctagan_tpu_torch",
                          "--config", config, "--mode", "train",
                          "--max-steps", "2"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    model = os.path.join(sub, "model")
    saved = sorted(os.listdir(model)) if os.path.isdir(model) else []
    rows = {}
    for name in ("HdGan_losses.csv", "HdGan_val.csv"):
        if name in saved:
            with open(os.path.join(model, name)) as f:
                rows[name] = len(f.read().splitlines()) - 1
    pts = [f for f in saved if f.endswith(".pt")]
    print(f"dp (d) python -m ctagan_tpu_torch --mode train on {world} cards: "
          f"exit {res.returncode} in {secs:.1f} s; "
          + " | ".join(ln for ln in res.stdout.splitlines()
                       if ln.startswith(("mesh plan", "training", "PSNR")))
          + f"; saved {pts}, CSV rows {rows} [{card}]", flush=True)
    if res.returncode != 0 or f"{world} ranks, global batch {world}" \
            not in res.stdout or len(pts) != 1 or rows != {
                "HdGan_losses.csv": 1, "HdGan_val.csv": 1}:
        fail(f"dp (d): the launcher's run: {res.stdout[-2000:]} "
             f"{res.stderr[-3000:]}")


# -- the fsdp phase ------------------------------------------------------------

def _mesh_name(mesh):
    return "".join(f"{k}{v}" for k, v in mesh.items())


def _fsdp_expect(counts, mesh):
    """A rank's predicted bytes under ``mesh``, from the nets' parameter
    counts (G, R, D), f32: each net padded to a multiple of the fsdp
    extent N, a rank keeping 1/N of it, its two Adam moments alike; a step
    gathers G twice (D's fresh forward of the updated G), R and D once,
    reduce-scatters the three gradients, and all-reduces 5 losses (with a
    dp column, each gradient shard across it too)."""
    n, dp = mesh["fsdp"], mesh.get("dp", 1)
    g, r, d = (-(-c // n) * n for c in counts)
    return {"state": 3 * 4 * (g + r + d) // n,
            "gather": 4 * (2 * g + r + d),
            "scatter": 4 * (g + r + d),
            "reduce": 4 * 5 + (4 * (g + r + d) // n if dp > 1 else 0)}


def check_fsdp(torch, card):
    """Phase 19, a main path: the fsdp plan (``parallel/fsdp.py``) on HD
    stage 1 through the entry points' ``train()`` and ``test()``, under
    ``mesh: {fsdp: 2}`` over two gloo ranks sharing the card (several
    cards: NCCL, a rank a card; four or more: also ``{fsdp: 4}`` and
    ``{dp: 2, fsdp: 2}``): DP_STEPS steps against one process on the same
    global batch (held as dp (b)); each rank's resting state and the bytes
    it gathers, reduce-scatters and all-reduces a step against
    :func:`_fsdp_expect`; test() over the ranks on both routes (as dp
    (c)); the ``.pt`` the ranks write, read at world 1, bit-equal to their
    gathered state. Returns the ranks' launches (steps and the kernel
    route's test())."""
    dev = torch.device("cuda")
    cards = torch.cuda.device_count()
    meshes = [{"fsdp": 2}] + ([{"fsdp": 4}, {"dp": 2, "fsdp": 2}]
                              if cards >= 4 else [])
    counts = dict.fromkeys(SOURCES, 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _, paths, yaml = _dp_corpus(tmp)
        params = _hd_param_counts(torch)
        ones = {}
        print(f"fsdp: the corpus {time.perf_counter() - t0:.1f} s; G, R, D "
              f"parameters {params} [{card}]", flush=True)
        for mesh in meshes:
            run = _mesh_run(torch, dev, card, tmp, yaml, paths, mesh, params,
                            ones, cards > 1)
            world = mesh.get("dp", 1) * mesh["fsdp"]
            _held_rank_tests(torch, run, ones["tests"], paths, world, tmp,
                             _mesh_name(mesh), f"fsdp {mesh} (c)", card)
            for res in run:
                for k in counts:
                    counts[k] += (res["counts"].get(k, 0)
                                  + res["test_k_counts"].get(k, 0))
    return counts


def _mesh_run(torch, dev, card, tmp, yaml, paths, mesh, params, ones,
              nccl):
    """One mesh of the fsdp or the tp phase: the ranks (:func:`dp_worker`)
    started first; while they start, one process's DP_STEPS steps on the
    same global batch twice (for the card's run-to-run distance; under tp
    on the layer route, which the split step runs) and its test()s
    (:func:`_one_process_tests`), each once a phase (kept in ``ones``);
    then the go; (b), the bytes and the ``.pt`` checked, under tp also the
    sharded forward. Returns the ranks' results."""
    from ctagan_tpu_torch.train.trainers import HdTrainerStage1
    from ctagan_tpu_torch.utils.config import load_config

    kind = "tp" if "tp" in mesh else "fsdp"
    dp = mesh.get("dp", 1)
    world = dp * mesh[kind]
    batch = world if kind == "fsdp" else dp  # the global batch
    name = _mesh_name(mesh)
    spec = "mesh: {" + ", ".join(f"{k}: {v}" for k, v in mesh.items()) + "}\n"
    plain = "fused_body_grad: off\n"
    yaml(f"{name}_train", spec)
    yaml(f"{name}_test", spec + plain + f"eval_batch: {world}\n")
    yaml(f"{name}_test_k", spec + f"eval_batch: {world}\n")
    how = "a card each (NCCL)" if nccl else "on one card (gloo)"
    t_wall = time.time()
    ranks_proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={world}", os.path.abspath(__file__),
         "--dp-worker", tmp, "--dp-name", name])
    route = plain if kind == "tp" else ""
    try:
        if (batch, route) not in ones:
            cfg_one = load_config(yaml(
                f"one{batch}{kind}",
                f"batchSize: {batch}\ngrad_accum: {batch}\n" + route))
            ones[batch, route] = [_dp_run(torch, cfg_one, dev, DP_STEPS)
                                  for _ in "12"]
        if "tests" not in ones:
            ones["tests"] = _one_process_tests(torch, dev, yaml, tmp, kind,
                                               plain)
        open(os.path.join(tmp, f"{name}_go"), "w").close()
        t0 = time.perf_counter()
        rc = ranks_proc.wait()
    finally:
        if ranks_proc.poll() is None:
            ranks_proc.terminate()
            ranks_proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{kind} {mesh}: a rank exited {rc}")
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"{name}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = torch.load(os.path.join(tmp, f"{name}_rank0.pt"))
    one, one2 = ones[batch, route]
    grad_2, ok_g = _dp_held(r0["mu1"], one["mu1"], one2["mu1"])
    dist_2, ok_2 = _dp_held(r0["w"], one["w"], one2["w"])
    exact, repeat = (all(torch.equal(w[n][k], v) for n in one["w"]
                         for k, v in one["w"][n].items())
                     for w in (r0["w"], one2["w"]))
    if kind == "fsdp":
        expect = _fsdp_expect(params, mesh)
        launches = {k: v * DP_STEPS for k, v in PER_TRAIN_STEP.items()}
    else:
        expect = _tp_expect(params, mesh)
        launches = counts_of()  # JAX's gate: the split step has no kernel
    for r, res in enumerate(ranks):
        step_bytes = {kind_: sorted({s["bytes"] for s in res[kind_]})
                      for kind_ in ("gather", "scatter", "reduce")}
        if kind == "fsdp":
            colls = ("gathered, reduce-scattered, all-reduced "
                     f"{step_bytes} (expected {expect['gather']}, "
                     f"{expect['scatter']}, {expect['reduce']}); gather ms a "
                     "step " + ", ".join(
                         f"{s['ms']:.2f} (host {s['host_ms']:.2f}, "
                         f"{s['calls']} calls)" for s in res["gather"])
                     + "; reduce-scatter ms a step " + ", ".join(
                         f"{s['ms']:.2f} (host {s['host_ms']:.2f})"
                         for s in res["scatter"]) + "; ")
        else:
            colls = (f"summed (all-reduce) {step_bytes['reduce']} (expected "
                     f"{expect['reduce']}: {expect['sums']} of the "
                     "activations, the rest the means of the gradients "
                     "and losses); ")
        print(f"{kind} {mesh} rank {r} of {world} {how}: {DP_STEPS} steps at "
              f"batchSize 1 (global batch {batch}), p50 step "
              f"{res['p50_ms']:.1f} ms (one process at batchSize {batch} "
              f"and grad_accum {batch}{' on the layer route' * (kind == 'tp')}"
              f": {one['p50']:.1f} ms); resting state "
              f"{res['state_bytes']} B (expected {expect['state']}; one "
              f"process {one['state_bytes']}); a step's bytes {colls}"
              "all-reduce ms a step "
              + ", ".join(f"{s['ms']:.2f} (host {s['host_ms']:.2f}, "
                          f"{s['calls']} calls)" for s in res["reduce"])
              + f"; peak memory {res['peak'] / 2**30:.3f} GiB; launches "
              f"{res['counts']} (expected {launches}); losses "
              f"{res['losses']}; seconds from the launch to the rank's "
              f"start, group, go, steps and test() done "
              f"{[round(m - t_wall, 1) for m in res['marks']]} [{card}]",
              flush=True)
        if res["counts"] != launches:
            fail(f"{kind} {mesh}: rank {r} launches {res['counts']}")
        want_bytes = ({k: [expect[k]] for k in step_bytes} if kind == "fsdp"
                      else {"gather": [0], "scatter": [0],
                            "reduce": [expect["reduce"]]})
        if res["state_bytes"] != expect["state"] or step_bytes != want_bytes:
            fail(f"{kind} {mesh}: rank {r}'s bytes {res['state_bytes']}, "
                 f"{step_bytes}, expected {expect}")
    same = [len(set(d)) == 1 for d in zip(*(res["digests"] for res in ranks))]
    if kind == "tp" and (len(same) != DP_STEPS or not all(same)):
        fail(f"tp {mesh}: the ranks' replicated weights differ after a step "
             f"{same}")
    loss_one = one["losses"]
    first = [abs(ranks[0]["losses"][0][k] - loss_one[0][k])
             / max(abs(loss_one[0][k]), 1e-12) for k in loss_one[0]]
    # the .pt rank 0 wrote, at world 1
    pt = ranks[0]["pt"]
    back = HdTrainerStage1(load_config(yaml(f"{name}_back")), dev,
                           quiet=True)
    back._load_state(torch.load(pt, weights_only=False)["state"])
    portable = all(set(got) == set(want) and all(
        _equal_state(got[n], want[n]) for n in want)
        for got, want in ((_hd_weights(back), r0["w"]),
                          (_hd_first_moments(back), r0["mu"])))
    del back
    torch.cuda.empty_cache()
    replicas = (f"the ranks' replicated G, R and D bit-identical after each "
                f"step {same}; " if kind == "tp" else "")
    print(f"{kind} {mesh} (b): {replicas}rank 0 bit-equal to one process "
          f"at batchSize {batch} and grad_accum {batch} after {DP_STEPS} "
          f"steps {exact} (two runs of it bit-equal {repeat}); against it "
          f"(||rank 0 - one||, ||a repeat of one - one||, ||one||; tol "
          f"{GRAD_RATIO} x repeat + {GRAD_TOL} x norm): step 1's gradient "
          f"by net {_dp_line(grad_2)}; the weights after {DP_STEPS} steps "
          f"by net {_dp_line(dist_2)}; first-step losses "
          f"{ranks[0]['losses'][0]} vs {loss_one[0]} (largest relative "
          f"{max(first):.2e}); the .pt of the ranks ({os.path.basename(pt)}) "
          f"read at world 1 bit-equal to their gathered weights and first "
          f"moments {portable}; the world's wall from the go {wall:.1f} s "
          f"[{card}]", flush=True)
    if (repeat and not exact and world == 2 and kind == "fsdp") \
            or not (ok_g and ok_2) or max(first) > FAMILY_ROUTE_TOL:
        fail(f"{kind} {mesh} (b): the ranks moved off one process's steps")
    if not portable:
        fail(f"{kind} {mesh}: the ranks' .pt read at world 1 differs from "
             "their state")
    if kind == "tp":
        _tp_forward_held(torch, dev, tmp, name, mesh, ranks, card)
    return ranks


def _tp_expect(counts, mesh):
    """A tp rank's predicted bytes under ``mesh``, from the nets' parameter
    counts (G, R, D) and the rules' split counts of G and R, f32: each
    split parameter 1/N a rank, the rest whole, each with two Adam moments;
    a step sums each split block's input-shaped activation once in each
    forward and backward pass (G: its forward, backward and D's no-grad
    re-forward; R: its forward and backward), and averages the replicated
    gradients and 5 losses over every rank (with a dp column, each split
    gradient slice across it too)."""
    from ctagan_tpu_torch.models import Generator, RegNet
    from ctagan_tpu_torch.parallel import tensor

    n, dp = mesh["tp"], mesh.get("dp", 1)
    g_net, r_net = Generator(1, 1), RegNet()
    g_split, r_split = (
        sum(v.numel() for k, v in net.state_dict().items()
            if rules[k] != tensor.REPLICATED)
        for net, rules in ((g_net, tensor.tp_param_rules(g_net)),
                           (r_net, tensor.reg_param_rules(r_net))))
    g, r, d = counts
    held = (g - g_split) + (r - r_split) + d + (g_split + r_split) // n
    size = EVAL_SIZE  # one row a dp column
    g_pass = 9 * (size // 4) ** 2 * 256
    r_pass = sum((size >> i) ** 2 * c for i, c in enumerate(
        (32, 64, 64, 64, 64, 64, 64))) + 3 * (size >> 7) ** 2 * 128 \
        + size ** 2 * 32
    sums = 4 * (3 * g_pass + 2 * r_pass)
    means = 4 * ((g - g_split) + (r - r_split) + d) + 4 * 5 + (
        4 * (g_split + r_split) // n if dp > 1 else 0)
    return {"state": 3 * 4 * held, "sums": sums, "reduce": sums + means}


# the tp phase's sharded forward: a seeded full-width G on a seeded 512²
# batch of TP_FORWARD_ROWS slices, TP_FORWARD_CALLS calls on every rank,
# each rank's output held within GEN_TOL of one process's layer route (the
# split convs sum their halves, then the halves, in f32)
TP_FORWARD_ROWS, TP_FORWARD_SEED, TP_FORWARD_CALLS = 2, 11, 2


def _tp_forward_input(torch, dev):
    gen = torch.Generator().manual_seed(TP_FORWARD_SEED)
    return (torch.rand(TP_FORWARD_ROWS, EVAL_SIZE, EVAL_SIZE, 1,
                       generator=gen) * 2 - 1).to(dev)


def _tp_forward_g(torch, dev):
    from ctagan_tpu_torch.models import Generator

    return Generator(1, 1, fused_body=False).reset_parameters(
        TP_FORWARD_SEED).to(dev)


def _tp_forward_held(torch, dev, tmp, name, mesh, ranks, card):
    """The ranks' ``infer_tensor_sharded`` (:func:`dp_worker`) against one
    process's forward of the same G on the same batch."""
    with torch.no_grad():
        want = _tp_forward_g(torch, dev)(_tp_forward_input(torch, dev)).cpu()
    got = [torch.load(os.path.join(tmp, f"{name}_fwd{r}.pt"))
           for r in range(len(ranks))]
    errs = [rel_err(torch, g, want) for g in got]
    print(f"tp {mesh}: infer_tensor_sharded at {TP_FORWARD_ROWS}x"
          f"{EVAL_SIZE}^2 (data_parallel {mesh.get('dp', 1) > 1}) vs one "
          f"process's layer route: max error by rank {errs} (tol {GEN_TOL}); "
          f"the ranks' outputs bit-equal "
          f"{all(torch.equal(g, got[0]) for g in got)}; seconds a rank of "
          f"{TP_FORWARD_CALLS} calls, then of G copied and split, then of "
          f"its split forward alone "
          f"{[[round(t, 3) for t in r['fwd_s']] for r in ranks]}, that "
          f"forward's {len(ranks[0]['fwd_sums_ms'])} sums ms a rank "
          f"{[round(sum(r['fwd_sums_ms']), 2) for r in ranks]} [{card}]",
          flush=True)
    if any(tuple(g.shape) != tuple(want.shape) for g in got) or \
            not max(errs) <= GEN_TOL:
        fail(f"tp {mesh}: the sharded forward differs from one process's")


def check_tp(torch, card):
    """Phase 20, a main path: the tp plan (``parallel/tensor.py``) on HD
    stage 1 through the entry points' ``train()`` and ``test()``, under
    ``mesh: {tp: 2}`` over two gloo ranks sharing the card (several cards:
    NCCL, a rank a card; four or more: also ``{tp: 4}`` and ``{dp: 2, tp:
    2}``): DP_STEPS steps against one process's on the layer route (held
    as dp (b)), the replicated weights bit-identical across the ranks after
    every step; each rank's resting state and the bytes it sums a step
    against :func:`_tp_expect`; no kernel launched in the steps; test()
    over the ranks on both routes (as dp (c); the eval G gathered, the
    kernel route's body through K1); the ``.pt`` the ranks write, read at
    world 1, bit-equal to their gathered state; ``infer_tensor_sharded``
    at 512² against one process. Returns the ranks' launches (steps and the
    kernel route's test())."""
    dev = torch.device("cuda")
    cards = torch.cuda.device_count()
    meshes = [{"tp": 2}] + ([{"tp": 4}, {"dp": 2, "tp": 2}]
                            if cards >= 4 else [])
    counts = dict.fromkeys(SOURCES, 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _, paths, yaml = _dp_corpus(tmp)
        params = _hd_param_counts(torch)
        ones = {}
        print(f"tp: the corpus {time.perf_counter() - t0:.1f} s; G, R, D "
              f"parameters {params}; predicted a rank under "
              f"{meshes[0]}: {_tp_expect(params, meshes[0])} [{card}]",
              flush=True)
        for mesh in meshes:
            run = _mesh_run(torch, dev, card, tmp, yaml, paths, mesh, params,
                            ones, cards > 1)
            world = mesh.get("dp", 1) * mesh["tp"]
            _held_rank_tests(torch, run, ones["tests"], paths, world, tmp,
                             _mesh_name(mesh), f"tp {mesh} (c)", card)
            for res in run:
                for k in counts:
                    counts[k] += (res["counts"].get(k, 0)
                                  + res["test_k_counts"].get(k, 0))
    return counts


# the sp phase (parallel/halo.py, parallel/spatial.py): (a)
# infer_spatial_sharded of a seeded full-width G (f32, TF32 off) on a seeded
# SP_FORWARD_SIZE² slice with halo SP_HALO, SP_FORWARD_CALLS calls a rank,
# held within GEN_TOL of one process's forward of the symmetric-extended
# slice, cropped; (b) configs/P2p.yaml (512², batchSize 1) for DP_STEPS
# steps under {sp: 2} (four cards: {dp: 2, sp: 2}) on a seeded corpus of
# SP_SLICES slice pairs, held as tp's (b) against one process at batchSize
# dp and grad_accum dp on the layer route; (c) test() over the ranks of
# the first SP_TEST slices a rank (the eval G whole, its configured route)
SP_FORWARD_SIZE, SP_HALO, SP_FORWARD_SEED, SP_FORWARD_CALLS = 2048, 96, 13, 2
SP_SLICES = 8
# (d) HD stage 1's steps, (e) each other family's
SP_HD_STEPS, SP_FAMILY_STEPS = 4, 2
# the depth phase: (a) infer_volume_depth_sharded of the shipped
# Generator3D (6 blocks, base 32, seeded) on a seeded DEPTH_SERIES-slice
# 512² series (four cards: 2 × DEPTH_SERIES over four ranks), halo 18, in
# f32 (held within GEN_TOL of one process's forward of the
# symmetric-extended series, cropped) and in bf16 (timed), DEPTH_FWD_CALLS
# calls each; (b) configs/P3d.yaml at 512² in f32 (TF32 off) on a corpus of
# DEPTH_PATIENTS series of DEPTH_SLICES slices: DEPTH_STEPS steps at
# patch_depth 8 under {depth: 2}, DEPTH_SP_STEPS under {sp: 2} (four
# cards: {depth: 4} and {dp: 2, depth: 2} on twice the series), held as
# the sp phase's runs;
# DEPTH_DEEP_STEPS step at patch_depth DEPTH_DEEP under {depth: 2} on a
# series of as many slices, its losses within FAMILY_ROUTE_TOL of one
# process's; (c) --mode infer with
# infer_depth_sharded at world 1 on a seeded DEPTH_SERIES-slice DICOM
# series
DEPTH_SERIES, DEPTH_HALO, DEPTH_SEED, DEPTH_FWD_CALLS = 40, 18, 17, 2
DEPTH_PATIENTS, DEPTH_SLICES, DEPTH_STEPS, DEPTH_SP_STEPS = 4, 12, 4, 2
DEPTH_DEEP, DEPTH_DEEP_STEPS = 32, 1


def _mesh_spec(mesh):
    return "mesh: {" + ", ".join(f"{k}: {v}" for k, v in mesh.items()) \
        + "}\n"


def _sp_runs(world):
    """The sp phase's runs of the other families: (d) HD stage 1 for
    SP_HD_STEPS steps under ``{sp: 2}`` on one card, under ``{sp: 4}``
    (the ResUNet's bottleneck gathered whole) and ``{dp: 2, sp: 2}`` on
    four; (e) on one card RegGAN, HD stage 2 and CycleGAN under ``{sp:
    2}`` for SP_FAMILY_STEPS steps."""
    def run(name, base, cls, mesh, steps):
        return {"name": name, "base": base, "cls": cls, "mesh": mesh,
                "steps": steps}

    hd1 = ("HdGan.yaml", "HdTrainerStage1")
    if world == 4:
        return [run("sp_hd1_sp4", *hd1, {"sp": 4}, SP_HD_STEPS),
                run("sp_hd1_dp2", *hd1, {"dp": 2, "sp": 2}, SP_HD_STEPS)]
    return [run("sp_hd1", *hd1, {"sp": 2}, SP_HD_STEPS),
            run("sp_reg", "RegGan.yaml", "RegTrainer", {"sp": 2},
                SP_FAMILY_STEPS),
            run("sp_hd2", "HdGan2.yaml", "HdTrainerStage2", {"sp": 2},
                SP_FAMILY_STEPS),
            run("sp_cyc", "CycleGan.yaml", "CycTrainer", {"sp": 2},
                SP_FAMILY_STEPS)]


def _sp_forward_g(torch, dev):
    from ctagan_tpu_torch.models import Generator

    return Generator(1, 1, fused_body=False).reset_parameters(
        SP_FORWARD_SEED).to(dev)


def _sp_forward_image():
    import numpy as np

    return np.random.default_rng(SP_FORWARD_SEED).uniform(
        -1, 1, (SP_FORWARD_SIZE, SP_FORWARD_SIZE)).astype(np.float32)


def _net_weights(trainer):
    """Each net's weights on the host, by checkpoint key."""
    return _state_weights(trainer.state, trainer._NETS)


def _state_weights(state, nets):
    return {key: {k: v.detach().cpu().clone()
                  for k, v in getattr(state, attr).state_dict().items()}
            for key, attr in nets}


def _net_first_moments(trainer):
    """Adam's first moment of each parameter, by checkpoint key."""
    return _state_first_moments(trainer.state, trainer._NETS)


def _state_first_moments(state, nets):
    opt_of = {net: getattr(state, opt)
              for opt, names in state.OPT_NETS.items() for net in names}
    return {key: {k: opt_of[attr].state[p]["exp_avg"].detach().cpu()
                  .clone()
                  for k, p in getattr(state, attr).named_parameters()}
            for key, attr in nets}


def _net_digest(trainer):
    """Every net's weights as one number, reduced on the device (as
    :func:`_hd_digest`)."""
    import torch

    sums = []
    for _, attr in trainer._NETS:
        for v in getattr(trainer.state, attr).state_dict().values():
            bits = v.detach().reshape(-1).view(torch.int32).long()
            pos = torch.arange(1, bits.numel() + 1, device=bits.device)
            sums.append((bits * pos).sum())
    total = 0
    for x in torch.stack(sums).tolist():
        total = total * 1000003 + x
    return total % (1 << 64)


# the ResUNet's widths (``ctagan_tpu_torch/models/reg.py``)
SP_NDF = (32, 64, 64, 64, 64, 64, 64)
SP_NUF = (64, 64, 64, 64, 64, 64, 32)


class _SpTally:
    """A rank's predicted collectives of one sp step (f32, one row a rank),
    tallied layer by layer: bytes and calls gathered (the row exchanges
    and the whole-image gathers), all-reduced (the sums) and
    reduce-scattered (a gather's gradient)."""

    def __init__(self, n, dp):
        self.n, self.dp = n, dp
        self.bytes = {"gather": 0, "reduce": 0, "scatter": 0}
        self.calls = dict.fromkeys(self.bytes, 0)

    def _add(self, kind, elems):
        self.bytes[kind] += 4 * elems
        self.calls[kind] += 1

    def rows(self, w, c, top, below, back):
        """A halo exchange of a map ``w`` wide of ``c`` channels: every
        rank's ``top`` and ``below`` edge rows and its row count gathered;
        with ``back`` the ghost rows' gradient, without the count."""
        self._add("gather", self.n * ((top + below) * w * c + 1))
        if back:
            self._add("gather", self.n * (top + below) * w * c)

    def sums(self, elems, back):
        """A ``SumOverGroup`` of ``elems`` elements, and of its
        gradient."""
        self._add("reduce", elems)
        if back:
            self._add("reduce", elems)

    def norm(self, c, back):
        self.sums(2 * c + 1, back)  # Σx, Σx², the row count

    def count(self):
        self._add("reduce", 1)  # an L1's element count

    def whole(self, elems, back):
        """A strip gathered whole (``elems`` the whole map's), and the
        reduce-scatter of its gradient."""
        self._add("gather", elems)
        if back:
            self._add("scatter", elems)

    def grads(self, elems):
        """The step's losses and gradients: summed over the block, and
        with a dp column averaged across it."""
        self._add("reduce", elems)
        if self.dp > 1:
            self._add("reduce", elems)


def _sp_g(t, s, grad_in, back, f=64, blocks=9):
    """G (reflect pads, ``blocks`` residual blocks, base ``f``) on a 1-channel
    image ``s`` wide: its input's exchange backward only with
    ``grad_in``, the rest with ``back`` (a forward with grad)."""
    t.rows(s, 1, 3, 3, grad_in)
    t.norm(f, back)
    t.rows(s, f, 1, 0, back)
    t.norm(2 * f, back)
    t.rows(s // 2, 2 * f, 1, 0, back)
    t.norm(4 * f, back)
    for _ in range(2 * blocks):
        t.rows(s // 4, 4 * f, 1, 1, back)
        t.norm(4 * f, back)
    t.rows(s // 4, 4 * f, 0, 1, back)
    t.norm(2 * f, back)
    t.rows(s // 2, 2 * f, 0, 1, back)
    t.norm(f, back)
    t.rows(s, f, 3, 3, back)


def _sp_d(t, s, grad_in, back=True, cin=1):
    """The PatchGAN D (stage 1's scalar one, or one scale of stage 2's):
    four 4×4 stride-2 / stride-1 stages and the head, then the pooled
    logit's sum (of the map and its count)."""
    t.rows(s, cin, 1, 1, grad_in)
    t.rows(s // 2, 64, 1, 1, back)
    t.norm(128, back)
    t.rows(s // 4, 128, 1, 1, back)
    t.norm(256, back)
    t.rows(s // 8, 256, 1, 2, back)
    t.norm(512, back)
    t.rows(s // 8 - 1, 512, 1, 2, back)
    t.sums(2, back or grad_in)


def _sp_reg_cut(rows):
    """The first ResUNet level (1-7 the downs, 8 the bottleneck) that runs
    whole at a strip of ``rows``: under 2 rows, or odd before a pool; 9
    for none."""
    for level in range(1, 8):
        if rows < 2 or rows % 2:
            return level
        rows //= 2
    return 8 if rows < 2 else 9


def _sp_r(t, s, n):
    """The ResUNet on [fake, real] (2 channels, its input with grad) at
    ``s``² under ``n`` ranks: each level's 3×3 conv and resnet block on
    strips down to the rule's cut, gathered whole there (its gradient
    reduce-scattered), the up path's resizes (one row from each neighbour)
    and convs back on strips, the refine block and the flow head."""
    cut = _sp_reg_cut(s // n)
    cin, w = 2, s
    for level, c in enumerate(SP_NDF, 1):
        if level == cut:
            t.whole(w * w * cin, True)
        if level < cut:
            t.rows(w, cin, 1, 1, True)
            for _ in range(2):
                t.rows(w, c, 1, 1, True)
                t.norm(c, True)
        cin, w = c, w // 2
    if cut == 8:
        t.whole(w * w * cin, True)
    if cut > 8:
        for _ in range(6):  # three resnet blocks of 128
            t.rows(w, 2 * cin, 1, 1, True)
            t.norm(2 * cin, True)
    prev = SP_NDF[-1]
    for i, level in enumerate(range(7, 0, -1)):
        w = s >> (level - 1)
        if level < cut:
            if level + 1 < cut:  # a strip's resize
                t.rows(w // 2, prev, 1, 1, True)
            t.rows(w, prev + SP_NDF[level - 1], 1, 1, True)
        prev = SP_NUF[i]
    if cut > 1:
        for _ in range(2):
            t.rows(s, prev, 1, 1, True)
            t.norm(prev, True)
        t.rows(s, prev, 1, 1, True)


def _sp_family_expect(cls, mesh, size, params):
    """A rank's predicted bytes and calls of one step of the trainer
    ``cls`` (its config's defaults: b=1, no ``grad_accum``, ``d_refwd``,
    ``reg_downsample`` 1, stage 2 with one scale and no feature matching)
    under ``mesh`` at ``size``², f32, from the nets' shapes and
    ``params`` (parameter counts: G, R, D; P2p and CycleGAN G, D).
    P2p: G forward and backward (its first exchange's input takes no
    gradient), the conditional D on [A, fake] forward and backward, the
    L1's count, G's gradient with 3 losses; then G forward without grad,
    D on fake and real (its first exchange's input takes no gradient), D's
    gradient with its loss."""
    n, dp = mesh["sp"], mesh.get("dp", 1)
    t = _SpTally(n, dp)
    s = size
    if cls == "P2pTrainer":
        g, d = params
        _sp_g(t, s, False, True)
        _sp_d(t, s, True, cin=2)
        t.count()
        t.grads(g + 3)
        _sp_g(t, s, False, False)
        _sp_d(t, s, False, cin=2)
        _sp_d(t, s, False, cin=2)
        t.grads(d + 1)
        return {**t.bytes, **{f"{k}_calls": v for k, v in t.calls.items()}}
    if cls == "CycTrainer":
        g, d = params
        for _ in range(2):  # ga(a), db(fake_b); gb(b), da(fake_a)
            _sp_g(t, s, False, True)
            _sp_d(t, s, True)
        for _ in range(2):  # the cycles, each an L1
            _sp_g(t, s, True, True)
            t.count()
        t.grads(1 + 2 + 2 * g)
        for _ in range(2):  # the pools take the whole fakes
            t.whole(s * s, False)
            if dp > 1:
                t.sums(dp * s * s, False)
        for _ in range(2):  # D_A, D_B on the real and the pooled fake
            _sp_d(t, s, False)
            _sp_d(t, s, False)
            t.grads(1 + d)
        return {**t.bytes, **{f"{k}_calls": v for k, v in t.calls.items()}}
    stage2 = cls == "HdTrainerStage2"
    g, r, d = params
    _sp_g(t, s, False, True)
    _sp_r(t, s, n)
    t.whole(s * s, True)  # the warp's moving image
    t.rows(s, 2, 0, 1, True)  # the smoothness loss: a row from below
    t.count()  # SR_loss
    _sp_d(t, s, True)
    if stage2:
        t.count()  # SR_loss2
    t.grads(1 + (4 if stage2 else 3) + g + r)
    _sp_g(t, s, False, False)  # D's fresh forward of the updated G
    _sp_d(t, s, False)
    _sp_d(t, s, False)
    t.grads(1 + d)
    return {**t.bytes, **{f"{k}_calls": v for k, v in t.calls.items()}}


def sp_worker(torch, tmp):
    """One rank of the sp phase's world (two gloo ranks on one card; with
    four or more cards four, a card each under NCCL), after the file
    ``tmp``/sp_go appears: (a) SP_FORWARD_CALLS calls of
    ``infer_spatial_sharded`` over every rank, timed, the peak memory
    (the output in sp_fwd<r>.npy); (b) DP_STEPS steps of
    ``tmp``/sp_train.yaml, each collective inside a step timed by CUDA
    events and the host clock with its bytes, a digest of G and D after
    every step, the peak memory, a checkpoint (rank 0 writes it)
    (:func:`_sp_rank_train`); (c) test() of ``tmp``/sp_test.yaml (the
    configured route); (d), (e) each run of ``tmp``/sp_runs.json (the
    other families) as (b), then test() of its checkpoint. Results in
    ``tmp``/sp_rank<r>.json, rank 0's weights in <run>_rank0.pt."""
    import numpy as np

    from ctagan_tpu_torch.__main__ import test as run_test
    from ctagan_tpu_torch.parallel import dist, halo, spatial
    from ctagan_tpu_torch.utils.config import load_config

    # entry, the group, the go, (a), (b), (c), each run
    marks = [time.time()]
    dev = (dist.init(torch.device("cuda")) if torch.cuda.device_count() > 1
           else dist.init(torch.device("cuda", 0), backend="gloo"))
    marks.append(time.time())
    while not os.path.exists(os.path.join(tmp, "sp_go")):
        time.sleep(0.05)
    marks.append(time.time())
    rank, world = dist.rank(), dist.world()
    res = {}
    # (a) the sharded forward
    g, img = _sp_forward_g(torch, dev), _sp_forward_image()
    mesh = spatial.make_sp_mesh(1, world)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    calls = []
    for _ in range(SP_FORWARD_CALLS):
        t0 = time.perf_counter()
        out = halo.infer_spatial_sharded(g, img, mesh, halo=SP_HALO)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
    res.update(fwd_s=calls, fwd_peak=torch.cuda.max_memory_allocated(dev))
    np.save(os.path.join(tmp, f"sp_fwd{rank}.npy"), out)
    del g, out
    torch.cuda.empty_cache()
    marks.append(time.time())
    # (b) the steps
    res.update(_sp_rank_train(torch, dev, tmp, "sp", "P2pTrainer", DP_STEPS,
                              "sp_train.yaml"))
    torch.cuda.empty_cache()
    marks.append(time.time())
    # (c) test() on the configured route
    reset_counts()
    _, agg, secs = run_test(load_config(os.path.join(tmp, "sp_test.yaml")),
                            dev)
    torch.cuda.synchronize()
    marks.append(time.time())
    res.update(test_counts=launch_counts(), agg=agg, test_s=secs)
    # (d), (e) the other families, as the parent lists them: their steps,
    # then test() of their checkpoint
    with open(os.path.join(tmp, "sp_runs.json")) as f:
        runs = json.load(f)
    res["runs"] = {}
    for run in runs:
        out = _sp_rank_train(torch, dev, tmp, run["name"], run["cls"],
                             run["steps"])
        torch.cuda.empty_cache()
        reset_counts()
        _, agg, secs = run_test(load_config(os.path.join(
            tmp, f"{run['name']}_test.yaml")), dev)
        torch.cuda.synchronize()
        out.update(test_counts=launch_counts(), agg=agg, test_s=secs)
        res["runs"][run["name"]] = out
        marks.append(time.time())
    res["marks"] = marks
    with open(os.path.join(tmp, f"sp_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    return 0


def _sp_rank_train(torch, dev, tmp, name, cls_name, n_steps, yaml=None):
    """One rank's ``n_steps`` steps of ``tmp``/``yaml`` (<name>.yaml)
    through the entry point's ``train()`` (the trainer ``cls_name``): each
    collective
    inside a step timed by CUDA events and the host clock with its bytes,
    a digest of the nets after every step, the launches, the peak memory,
    a checkpoint (rank 0 writes it). Rank 0's weights and first moments
    after step 1 and after the run (and CycleGAN's pools) go to
    ``tmp``/<name>_rank0.pt. Returns the rank's results."""
    import torch.distributed as tdist

    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.parallel import dist
    from ctagan_tpu_torch.train import trainers
    from ctagan_tpu_torch.utils.config import load_config

    digests, colls, done, in_step = [], [], [0], [False]
    step_s = []  # each step's wall to its digest (which reads the device)
    # each collective's kind, and which argument holds the bytes it moves
    moved = {"all_reduce": 0, "all_gather_into_tensor": 0,
             "reduce_scatter_tensor": 1}
    kinds = {"all_reduce": "reduce", "all_gather_into_tensor": "gather",
             "reduce_scatter_tensor": "scatter"}
    originals = {kind: getattr(tdist, kind) for kind in moved}

    def timed(kind):
        def call(*args, **kw):
            if not in_step[0]:
                return originals[kind](*args, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            h0 = time.perf_counter()
            ev[0].record()
            out_ = originals[kind](*args, **kw)
            ev[1].record()
            t = args[moved[kind]]
            colls.append((kinds[kind], done[0], ev,
                          t.numel() * t.element_size(),
                          time.perf_counter() - h0))
            return out_
        return call

    cls = getattr(trainers, cls_name)
    own, step = cls.__dict__.get("_step"), cls._step
    first = {}

    def spy(self, batch, lr, lr_d):
        in_step[0] = True
        t_step = time.perf_counter()
        try:
            out_ = step(self, batch, lr, lr_d)
        finally:
            in_step[0] = False
        done[0] += 1
        digests.append(_net_digest(self))
        step_s.append(time.perf_counter() - t_step)
        if not first:
            first.update(w1=_net_weights(self), mu1=_net_first_moments(self))
        return out_

    for kind in moved:
        setattr(tdist, kind, timed(kind))
    cls._step = spy
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        reset_counts()
        trainer = train(load_config(os.path.join(tmp, yaml or f"{name}.yaml")),
                        dev, max_steps=n_steps)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        for kind, fn in originals.items():
            setattr(tdist, kind, fn)
        if own is None:
            del cls._step
        else:
            cls._step = own
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {kind: [{"ms": 0.0, "host_ms": 0.0, "bytes": 0, "calls": 0}
                       for _ in range(n_steps)] for kind in kinds.values()}
    for kind, i, ev, nb, host_s in colls:
        s = per_step[kind][i]
        s["ms"] += ev[0].elapsed_time(ev[1])
        s["host_ms"] += host_s * 1e3
        s["bytes"] += nb
        s["calls"] += 1
    timer = trainer.timer.summary(skip=1 if n_steps > 2 else 0)
    mesh = trainer.state.sp or getattr(trainer.state, "depth", None)
    res = dict(digests=digests, losses=trainer.loss_history, counts=counts,
               peak=peak, p50_ms=timer.get("p50_ms", float("nan")),
               step_s=step_s,
               kind=trainer.plan.kind, sp=mesh.n,
               pt=trainer._save(trainer._current_epoch), **per_step)
    if dist.rank() == 0:
        torch.save(dict(first, w=_net_weights(trainer),
                        mu=_net_first_moments(trainer),
                        pools=_pools(trainer.state)),
                   os.path.join(tmp, f"{name}_rank0.pt"))
    del trainer
    return res


def _pools(state):
    """A CycleGAN state's history pools on the host (None for the other
    families)."""
    if not hasattr(state, "fake_a_buffer"):
        return None
    return [(b.data.detach().cpu().clone(), b.size)
            for b in (state.fake_a_buffer, state.fake_b_buffer)]


def _state64(state):
    """A float64 copy of a state as its first step finds it: its nets and
    EMAs in f64, fresh optimizers over the copies (in the state's
    parameter order), its generator's state and (CycleGAN) its pools."""
    import torch

    from ctagan_tpu_torch.train import steps

    new = copy.copy(state)
    for names in state.OPT_NETS.values():
        for attr in names:
            setattr(new, attr, copy.deepcopy(getattr(state, attr)).double())
    for opt, names in state.OPT_NETS.items():
        setattr(new, opt, steps.make_optimizer(
            [p for attr in names for p in getattr(new, attr).parameters()]))
    for attr in state.EMA_NETS:
        if getattr(state, attr) is not None:
            setattr(new, attr, copy.deepcopy(getattr(state, attr)).double())
    new.gen = torch.Generator()
    new.gen.set_state(state.gen.get_state())
    for key in ("fake_a_buffer", "fake_b_buffer"):
        if hasattr(state, key):
            buf = getattr(state, key)
            setattr(new, key, type(buf)(buf.data.double().clone(), buf.size))
    return new


def _sp_one(torch, config, dev, f64=False, cls_name="P2pTrainer",
            n_steps=DP_STEPS):
    """One process's ``n_steps`` steps of ``config`` (the trainer
    ``cls_name``): the weights and first moments after step 1 and after
    the run, the losses, the p50 step and the peak memory; with ``f64``
    also the same steps replayed in float64 (:func:`_state64` of the state
    the first step found, and the batches each step took, in f64, through
    the trainer's own step) under ``"f64"``."""
    import torch as _torch

    from ctagan_tpu_torch.__main__ import train
    from ctagan_tpu_torch.train import trainers

    cls = getattr(trainers, cls_name)
    own, step = cls.__dict__.get("_step"), cls._step
    first, replay, step_s = {}, {"batches": []}, []

    def spy(self, batch, lr, lr_d):
        if f64 and "shim" not in replay:
            replay["shim"] = copy.copy(self)
            replay["shim"].state = _state64(self.state)
        if f64:
            replay["batches"].append(
                ({k: v.detach().double() for k, v in batch.items()}, lr,
                 lr_d))
        t_step = time.perf_counter()
        out = step(self, batch, lr, lr_d)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_step)
        if not first:
            first.update(w1=_net_weights(self), mu1=_net_first_moments(self))
        return out

    cls._step = spy
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        trainer = train(config, dev, max_steps=n_steps)
        torch.cuda.synchronize()
    finally:
        if own is None:
            del cls._step
        else:
            cls._step = own
    nets = trainer._NETS
    timer = trainer.timer.summary(skip=1 if n_steps > 2 else 0)
    out = dict(first, w=_net_weights(trainer), mu=_net_first_moments(trainer),
               losses=trainer.loss_history,
               p50=timer.get("p50_ms", float("nan")), step_s=step_s,
               peak=torch.cuda.max_memory_allocated(dev))
    del trainer
    if f64:
        shim, res = replay["shim"], {}
        for i, (batch, lr, lr_d) in enumerate(replay["batches"]):
            step(shim, batch, lr, lr_d)
            if i == 0:
                res.update(w1=_state_weights(shim.state, nets),
                           mu1=_state_first_moments(shim.state, nets))
        res.update(w=_state_weights(shim.state, nets),
                   mu=_state_first_moments(shim.state, nets))
        out["f64"] = res
        del replay, shim
        _torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def check_sp(torch, card):
    """Phase 21, a main path: the sp plan. Two gloo ranks share the card
    (four or more cards: four ranks, a card each, under NCCL), started
    first (:func:`sp_worker`); meanwhile one process's references. (a)
    ``infer_spatial_sharded`` at SP_FORWARD_SIZE² over every rank against
    one process's forward of the symmetric-extended slice, cropped, within
    GEN_TOL, each rank's time and peak memory beside the one process's;
    (b) P2p through the entry point's ``train()`` under ``{sp: 2}`` (four
    cards: ``{dp: 2, sp: 2}``) for DP_STEPS steps against one process on
    the layer route at batchSize dp and grad_accum dp (held as tp's (b)),
    the weights bit-identical across the ranks after every step, the bytes
    each rank gathers and all-reduces a step against
    :func:`_sp_family_expect`, no kernel launched, the peak memory beside
    one process's, the ``.pt`` the ranks wrote read at world 1 bit-equal to
    rank 0's state; (c) test() over the ranks, 18 K1 launches a forwarded
    slice; (d), (e) the other families' runs (:func:`_sp_runs`), each held
    by :func:`_sp_run_held`. Returns the ranks' launches."""
    import math

    import numpy as np

    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.models import Discriminator, Generator, RegNet
    from ctagan_tpu_torch.train.trainers import P2pTrainer
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2
    nccl = cards > 1
    mesh = {"dp": 2, "sp": 2} if world == 4 else {"sp": 2}
    dp = mesh.get("dp", 1)
    n_g, n_r, n_d2, n_d = (sum(p.numel() for p in m.parameters()) for m in (
        Generator(1, 1), RegNet(), Discriminator(2), Discriminator(1)))
    params = [n_g, n_d2]
    expect = _sp_family_expect("P2pTrainer", mesh, 512, params)
    runs = _sp_runs(world)
    for run in runs:
        run["expect"] = _sp_family_expect(
            run["cls"], run["mesh"], 512,
            [n_g, n_d] if run["cls"] == "CycTrainer" else [n_g, n_r, n_d])
    counts = dict.fromkeys(SOURCES, 0)
    how = "a card each (NCCL)" if nccl else "on one card (gloo)"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_list = make_corpus(tmp, n_patients=1,
                                 slices_per_patient=SP_SLICES, size=512,
                                 seed=0, lists=("train",))["train"]
        paths = _read_list(train_list)
        test_list = _write_list(os.path.join(tmp, "sp_test.txt"),
                                paths[:world])
        lists = {"train": train_list, "val": test_list, "test": test_list}
        spec = "mesh: {" + ", ".join(f"{k}: {v}" for k, v in mesh.items()) \
            + "}\n"

        def yaml(name, extra, base="P2p.yaml"):
            path = _smoke_config(tmp, lists, f"save_root: '{tmp}/{name}/'\n"
                                 f"image_save: '{tmp}/{name}_img/'\n"
                                 "live_panels: false\n" + extra,
                                 base=base)
            shutil.move(path, os.path.join(tmp, f"{name}.yaml"))
            return os.path.join(tmp, f"{name}.yaml")

        def with_test(name, extra, base="P2p.yaml"):
            # <name>.yaml and <name>_test.yaml, test() split over the ranks
            yaml(name, extra, base)
            with open(os.path.join(tmp, f"{name}_test.yaml"), "w") as f:
                with open(os.path.join(tmp, f"{name}.yaml")) as src:
                    f.write(src.read() + f"\neval_batch: {world}\n")

        yaml("sp_train", spec)
        with open(os.path.join(tmp, "sp_test.yaml"), "w") as f:
            with open(os.path.join(tmp, "sp_train.yaml")) as src:
                f.write(src.read() + f"\neval_batch: {world}\n")
        for run in runs:
            with_test(run["name"], _mesh_spec(run["mesh"]), run["base"])
        with open(os.path.join(tmp, "sp_runs.json"), "w") as f:
            json.dump(runs, f)
        print(f"sp: the corpus {time.perf_counter() - t0:.1f} s; G, D "
              f"parameters {params}; predicted a rank's step under {mesh}: "
              f"{expect}; G, R, D, 1-channel D parameters "
              f"{[n_g, n_r, n_d]}; predicted a rank's step of "
              + "; ".join(f"{r['name']} ({r['cls']}, {r['mesh']}): "
                          f"{r['expect']}" for r in runs)
              + f" [{card}]", flush=True)
        t_wall = time.time()
        ranks_proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", os.path.abspath(__file__),
             "--dp-worker", tmp, "--dp-name", "sp"])
        try:
            # (a) one process: the extended slice's forward, cropped
            g, img = _sp_forward_g(torch, dev), _sp_forward_image()
            ext = np.pad(img, ((SP_HALO, SP_HALO), (0, 0)), mode="symmetric")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            one_s = []
            with torch.no_grad():
                for _ in range(SP_FORWARD_CALLS):
                    t1 = time.perf_counter()
                    want = g(torch.from_numpy(ext).to(dev)[None, :, :, None])
                    torch.cuda.synchronize()
                    one_s.append(time.perf_counter() - t1)
            one_peak = torch.cuda.max_memory_allocated(dev)
            want = want[0, SP_HALO:-SP_HALO, :, 0].cpu()
            del g
            torch.cuda.empty_cache()
            # (b) one process on the layer route, twice
            cfg_one = load_config(yaml(
                "sp_one", f"batchSize: {dp}\ngrad_accum: {dp}\n"
                "fused_body_grad: off\n"))
            one, one2 = (_sp_one(torch, cfg_one, dev, f64=f) for f in
                         (True, False))
            # (d), (e) one process of each run on the layer route, its
            # float64 replay
            refs = {}
            for run in runs:
                r_dp = run["mesh"].get("dp", 1)
                refs[run["name"]] = _sp_one(torch, load_config(yaml(
                    f"{run['name']}_one", f"batchSize: {r_dp}\n"
                    f"grad_accum: {r_dp}\nfused_body_grad: off\n",
                    run["base"])), dev, f64=True, cls_name=run["cls"],
                    n_steps=run["steps"])
            open(os.path.join(tmp, "sp_go"), "w").close()
            t1 = time.perf_counter()
            rc = ranks_proc.wait()
        finally:
            if ranks_proc.poll() is None:
                ranks_proc.terminate()
                ranks_proc.wait()
        wall = time.perf_counter() - t1
        if rc != 0:
            fail(f"sp {mesh}: a rank exited {rc}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"sp_rank{r}.json")) as f:
                ranks.append(json.load(f))
        # (a)
        got = [torch.from_numpy(np.load(os.path.join(tmp, f"sp_fwd{r}.npy")))
               for r in range(world)]
        errs = [rel_err(torch, x, want) for x in got]
        print(f"sp {{sp: {world}}} (a): infer_spatial_sharded at "
              f"{SP_FORWARD_SIZE}^2, halo {SP_HALO}, {world} ranks {how}, "
              f"vs one process's forward of the symmetric-extended "
              f"{SP_FORWARD_SIZE + 2 * SP_HALO}x{SP_FORWARD_SIZE} slice, "
              f"cropped: max error by rank {errs} (tol {GEN_TOL}); the ranks' "
              f"outputs bit-equal {all(torch.equal(x, got[0]) for x in got)}; "
              f"seconds of {SP_FORWARD_CALLS} calls by rank "
              f"{[[round(t, 3) for t in r['fwd_s']] for r in ranks]} (one "
              f"process {[round(t, 3) for t in one_s]}); peak memory by rank "
              f"{[round(r['fwd_peak'] / 2**30, 3) for r in ranks]} GiB (one "
              f"process {one_peak / 2**30:.3f} GiB) [{card}]", flush=True)
        if any(tuple(x.shape) != tuple(want.shape) for x in got) or \
                not max(errs) <= GEN_TOL:
            fail(f"sp: the sharded forward differs from one process's")
        # (b)
        r0 = torch.load(os.path.join(tmp, "sp_rank0.pt"))
        # held as the grad phase holds a route: against one process's
        # float64 replay of the same steps, within GRAD_RATIO x one f32
        # process's distance from it (+ GRAD_TOL x its norm); beside it,
        # tp's figures against one f32 process and a repeat of it
        exact = one["f64"]
        grad_64, ok_g = _dp_held(r0["mu1"], exact["mu1"], one["mu1"])
        dist_64, ok_2 = _dp_held(r0["w"], exact["w"], one["w"])
        grad_2, _ = _dp_held(r0["mu1"], one["mu1"], one2["mu1"])
        dist_2, _ = _dp_held(r0["w"], one["w"], one2["w"])
        for r, res in enumerate(ranks):
            step_bytes = {k: sorted({s["bytes"] for s in res[k]})
                          for k in ("gather", "reduce")}
            step_calls = {k: sorted({s["calls"] for s in res[k]})
                          for k in ("gather", "reduce")}
            print(f"sp {mesh} rank {r} of {world} {how}: {DP_STEPS} steps at "
                  f"batchSize 1 (global batch {dp}), p50 step "
                  f"{res['p50_ms']:.1f} ms (one process at batchSize {dp} "
                  f"and grad_accum {dp} on the layer route: "
                  f"{one['p50']:.1f} ms); a step's bytes gathered (the row "
                  f"exchanges) {step_bytes['gather']} in "
                  f"{step_calls['gather']} calls (expected "
                  f"{expect['gather']} in {expect['gather_calls']}), "
                  f"all-reduced {step_bytes['reduce']} in "
                  f"{step_calls['reduce']} calls (expected "
                  f"{expect['reduce']} in {expect['reduce_calls']}); gather "
                  "ms a step " + ", ".join(
                      f"{s['ms']:.2f} (host {s['host_ms']:.2f})"
                      for s in res["gather"]) + "; all-reduce ms a step "
                  + ", ".join(f"{s['ms']:.2f} (host {s['host_ms']:.2f})"
                              for s in res["reduce"])
                  + f"; peak memory {res['peak'] / 2**30:.3f} GiB (one "
                  f"process {one['peak'] / 2**30:.3f} GiB); launches "
                  f"{res['counts']} (expected none); losses {res['losses']}; "
                  f"seconds from the launch to the rank's start, group, go, "
                  f"(a), (b) and (c) done "
                  f"{[round(m - t_wall, 1) for m in res['marks']]} [{card}]",
                  flush=True)
            if res["counts"] != counts_of():
                fail(f"sp {mesh}: rank {r}'s steps launched {res['counts']}")
            if (step_bytes != {"gather": [expect["gather"]],
                               "reduce": [expect["reduce"]]}
                    or (res["kind"], res["sp"]) != ("sp", 2)):
                fail(f"sp {mesh}: rank {r}'s bytes {step_bytes}, expected "
                     f"{expect}")
        same = [len(set(d)) == 1
                for d in zip(*(res["digests"] for res in ranks))]
        if len(same) != DP_STEPS or not all(same):
            fail(f"sp {mesh}: the ranks' weights differ after a step {same}")
        loss_one = one["losses"]
        first = [abs(ranks[0]["losses"][0][k] - loss_one[0][k])
                 / max(abs(loss_one[0][k]), 1e-12) for k in loss_one[0]]
        pt = ranks[0]["pt"]
        back = P2pTrainer(load_config(yaml("sp_back", "")), dev, quiet=True)
        back._load_state(torch.load(pt, weights_only=False)["state"])
        portable = all(set(g_) == set(w_) and all(
            _equal_state(g_[n], w_[n]) for n in w_)
            for g_, w_ in ((_net_weights(back), r0["w"]),
                           (_net_first_moments(back), r0["mu"])))
        del back
        torch.cuda.empty_cache()
        print(f"sp {mesh} (b): the ranks' G and D bit-identical after each "
              f"step {same}; against one process's float64 replay "
              f"(||rank 0 - f64||, ||one f32 process - f64||, ||f64||; tol "
              f"{GRAD_RATIO} x the f32 process's + {GRAD_TOL} x norm): step "
              f"1's first moments by net {_dp_line(grad_64)}; the weights "
              f"after {DP_STEPS} steps by net {_dp_line(dist_64)}; against "
              f"one f32 process (||rank 0 - one||, ||a repeat of one - "
              f"one||, ||one||): step 1 {_dp_line(grad_2)}; after "
              f"{DP_STEPS} steps {_dp_line(dist_2)}; first-step losses "
              f"{ranks[0]['losses'][0]} vs {loss_one[0]} (largest relative "
              f"{max(first):.2e}); the .pt of the ranks "
              f"({os.path.basename(pt)}) read at world 1 bit-equal to rank "
              f"0's weights and first moments {portable}; the world's wall "
              f"from the go {wall:.1f} s [{card}]", flush=True)
        if not (ok_g and ok_2) or max(first) > FAMILY_ROUTE_TOL:
            fail(f"sp {mesh} (b): the ranks moved off one process's steps")
        if not portable:
            fail(f"sp {mesh}: the ranks' .pt read at world 1 differs from "
                 "their state")
        # (c)
        k1 = [res["test_counts"].get("conv3x3_reflect_stats", 0)
              for res in ranks]
        print(f"sp {mesh} (c): test() of {world} slices at eval_batch "
              f"{world} over the ranks (the eval G whole, the configured "
              f"route): launches by rank {[res['test_counts'] for res in ranks]}"
              f" (18 K1 a slice); aggregates {ranks[0]['agg']} [{card}]",
              flush=True)
        if k1 != [18] * world or any(
                res["test_counts"] != counts_of(conv3x3_reflect_stats=18)
                for res in ranks) or not all(
                math.isfinite(v) for v in ranks[0]["agg"].values()):
            fail(f"sp {mesh} (c): test() launches {k1} or its metrics")
        for res in ranks:
            for k in counts:
                counts[k] += res["counts"].get(k, 0) + \
                    res["test_counts"].get(k, 0)
        # (d), (e)
        for run in runs:
            for k, n in _sp_run_held(torch, card, tmp, run, refs[run["name"]],
                                     [res["runs"][run["name"]]
                                      for res in ranks], world, how,
                                     yaml, dev).items():
                counts[k] += n
    return counts


def _mesh_kind(mesh):
    """A mesh dict's plan and its model axis' extent: ("sp", N) or
    ("depth", N)."""
    kind = "depth" if "depth" in mesh else "sp"
    return kind, mesh[kind]


def _sp_run_held(torch, card, tmp, run, one, ranks, world, how, yaml, dev):
    """(d), (e): one run of the other families held as (b) and (c) hold
    P2p's: each step's bytes gathered, all-reduced and reduce-scattered
    against the run's prediction exactly, no launch in the steps, the
    replicas bit-identical after every step, rank 0 against one process's
    float64 replay by the GRAD_RATIO rule and its first-step losses within
    FAMILY_ROUTE_TOL, the ``.pt`` read at world 1 bit-equal (CycleGAN's
    pools too), test() 18 K1 a slice on each rank (where the ranks ran
    it: the depth phase's runs, held alike, run none). Returns the ranks'
    launches."""
    import math

    from ctagan_tpu_torch.train import trainers
    from ctagan_tpu_torch.utils.config import load_config

    name, mesh, expect = run["name"], run["mesh"], run["expect"]
    kind, n_model = _mesh_kind(mesh)
    tested = "test_counts" in ranks[0]
    label = f"{kind} {name} ({run['cls']}, {run['base']}, {mesh})"
    r0 = torch.load(os.path.join(tmp, f"{name}_rank0.pt"))
    exact = one["f64"]
    grad_64, ok_g = _dp_held(r0["mu1"], exact["mu1"], one["mu1"])
    dist_64, ok_w = _dp_held(r0["w"], exact["w"], one["w"])
    kinds = ("gather", "reduce", "scatter")
    for r, res in enumerate(ranks):
        step_bytes = {k: sorted({s["bytes"] for s in res[k]}) for k in kinds}
        step_calls = {k: sorted({s["calls"] for s in res[k]}) for k in kinds}
        print(f"{label} rank {r} of {world} {how}: {run['steps']} steps at "
              f"512^2, p50 step {res['p50_ms']:.1f} ms (one process on the "
              f"layer route {one['p50']:.1f} ms); a step's bytes and calls "
              + ", ".join(f"{k} {step_bytes[k]} in {step_calls[k]} "
                          f"(expected {expect[k]} in {expect[k + '_calls']})"
                          for k in kinds)
              + "; ms a step " + ", ".join(
                  f"{k} " + "/".join(f"{s['ms']:.1f} (host "
                                     f"{s['host_ms']:.1f})" for s in res[k])
                  for k in kinds)
              + f"; peak memory {res['peak'] / 2**30:.3f} GiB (one process "
              f"{one['peak'] / 2**30:.3f} GiB); launches {res['counts']} "
              f"(expected none); losses {res['losses']} [{card}]",
              flush=True)
        if res["counts"] != counts_of():
            fail(f"{label}: rank {r}'s steps launched {res['counts']}")
        if (any(step_bytes[k] != [expect[k]] or step_calls[k]
                != [expect[k + "_calls"]] for k in kinds)
                or (res["kind"], res["sp"]) != (kind, n_model)):
            fail(f"{label}: rank {r}'s bytes {step_bytes} in {step_calls}, "
                 f"expected {expect}")
    same = [len(set(d)) == 1 for d in zip(*(res["digests"] for res in ranks))]
    if len(same) != run["steps"] or not all(same):
        fail(f"{label}: the ranks' weights differ after a step {same}")
    loss_one = one["losses"]
    first = [abs(ranks[0]["losses"][0][k] - loss_one[0][k])
             / max(abs(loss_one[0][k]), 1e-12) for k in loss_one[0]]
    pt = ranks[0]["pt"]
    cls = getattr(trainers, run["cls"])
    back = cls(load_config(yaml(f"{name}_back", "", run["base"])), dev,
               quiet=True)
    back._load_state(torch.load(pt, weights_only=False)["state"])
    portable = all(set(g_) == set(w_) and all(
        _equal_state(g_[n], w_[n]) for n in w_)
        for g_, w_ in ((_net_weights(back), r0["w"]),
                       (_net_first_moments(back), r0["mu"])))
    pools = _pools(back.state)
    if pools is not None:
        portable = portable and all(
            a[1] == b[1] and torch.equal(a[0], b[0])
            for a, b in zip(pools, r0["pools"]))
    del back
    torch.cuda.empty_cache()
    k1 = [res["test_counts"].get("conv3x3_reflect_stats", 0)
          for res in ranks] if tested else None
    print(f"{label}: the ranks' nets bit-identical after each step {same}; "
          f"against one process's float64 replay (||rank 0 - f64||, ||one "
          f"f32 process - f64||, ||f64||; tol {GRAD_RATIO} x the f32 "
          f"process's + {GRAD_TOL} x norm): step 1's first moments by net "
          f"{_dp_line(grad_64)}; the weights after {run['steps']} steps by "
          f"net {_dp_line(dist_64)}; first-step losses "
          f"{ranks[0]['losses'][0]} vs {loss_one[0]} (largest relative "
          f"{max(first):.2e}); the .pt of the ranks ({os.path.basename(pt)}) "
          f"read at world 1 bit-equal to rank 0's weights, first moments"
          f"{' and pools' if pools is not None else ''} {portable}"
          + (f"; test() of {world} slices over the ranks: launches by rank "
             f"{[res['test_counts'] for res in ranks]} (18 K1 a slice), "
             f"{[round(res['test_s'], 2) for res in ranks]} s; aggregates "
             f"{ranks[0]['agg']}" if tested else "") + f" [{card}]",
          flush=True)
    if not (ok_g and ok_w) or max(first) > FAMILY_ROUTE_TOL:
        fail(f"{label}: the ranks moved off one process's steps")
    if not portable:
        fail(f"{label}: the ranks' .pt read at world 1 differs from their "
             "state")
    if tested and (k1 != [18] * world or any(
            res["test_counts"] != counts_of(conv3x3_reflect_stats=18)
            for res in ranks) or not all(
            math.isfinite(v) for v in ranks[0]["agg"].values())):
        fail(f"{label}: test() launches {k1} or its metrics")
    counts = dict.fromkeys(SOURCES, 0)
    for res in ranks:
        for k in counts:
            counts[k] += res["counts"].get(k, 0) + \
                res.get("test_counts", {}).get(k, 0)
    return counts


def _depth_g(torch, dev, dtype=None):
    """The depth phase's forward G: the shipped Generator3D, seeded."""
    from ctagan_tpu_torch.models.volumetric import Generator3D

    return Generator3D(1, 1, dtype=dtype).reset_parameters(DEPTH_SEED).to(dev)


def _depth_series(world):
    """The sharded forward's seeded series: DEPTH_SERIES slices of 512²
    (DEPTH_SERIES × 2 over four ranks, a slab of 20 each)."""
    import numpy as np

    slices = DEPTH_SERIES * (2 if world == 4 else 1)
    return np.random.default_rng(DEPTH_SEED).uniform(
        -1, 1, (slices, 512, 512)).astype(np.float32)


def _depth_runs(world):
    """The depth phase's P3d runs: on one card {depth: 2} for DEPTH_STEPS
    steps and {sp: 2} for DEPTH_SP_STEPS at patch_depth 8, then
    DEPTH_DEEP_STEPS at DEPTH_DEEP; on four {depth: 4} and {dp: 2, depth:
    2}."""
    def run(name, mesh, steps, patch=8):
        return {"name": name, "base": "P3d.yaml", "cls": "P3dTrainer",
                "mesh": mesh, "steps": steps, "patch": patch}

    if world == 4:
        return [run("depth_d4", {"depth": 4}, DEPTH_STEPS),
                run("depth_dp2", {"dp": 2, "depth": 2}, DEPTH_STEPS)]
    return [run("depth_d2", {"depth": 2}, DEPTH_STEPS),
            run("depth_sp2", {"sp": 2}, DEPTH_SP_STEPS),
            run("depth_deep", {"depth": 2}, DEPTH_DEEP_STEPS, DEPTH_DEEP)]


def _depth_expect(mesh, size, params, f=32, blocks=6):
    """A rank's predicted bytes and calls of one P3d step under ``mesh``
    ({depth: N}, {sp: N} or with dp) at ``size``², f32, b=1, from the nets'
    shapes and ``params`` (G's and D's parameter counts). Every conv of
    the family takes one slice from each neighbour (a gather of every
    rank's two edge slices and its slice count; its gradient's without
    the count), every InstanceNorm3d sums its mean and then its centred
    second moment over the block (two all-reduces of N·C, and two of
    their gradients), D's logit its sum (one, and its gradient); the
    losses' counts are local. G's phase: G's forward and backward (its
    input's exchange takes no gradient), D on [A, fake] forward and
    backward, G's gradient with 3 losses; D's phase: G forward without
    grad, D on fake and real (their input's exchanges take no gradient),
    D's gradient with its loss. The count of slices a rank holds does
    not enter: each exchange moves one slice of each side."""
    _, n = _mesh_kind(mesh)
    t = _SpTally(n, mesh.get("dp", 1))
    s = size

    def norm(c, back):
        t.sums(c, back)
        t.sums(c, back)

    def g_pass(back):
        t.rows(s * s, 1, 1, 1, False)  # the head's input: the batch
        norm(f, back)
        for w, c, out in ((s, f, 2 * f), (s // 2, 2 * f, 4 * f)):
            t.rows(w * w, c, 1, 1, back)  # the downs
            norm(out, back)
        for _ in range(2 * blocks):
            t.rows((s // 4) ** 2, 4 * f, 1, 1, back)
            norm(4 * f, back)
        for w, c, out in ((s // 4, 4 * f, 2 * f), (s // 2, 2 * f, f)):
            t.rows(w * w, c, 1, 1, back)  # the transposed ups
            norm(out, back)
        t.rows(s * s, f, 1, 1, back)  # the tail

    def d_pass(grad_in):
        t.rows(s * s, 2, 1, 1, grad_in)
        for w, c, out in ((s // 2, 32, 64), (s // 4, 64, 128),
                          (s // 8, 128, 256)):
            t.rows(w * w, c, 1, 1, True)
            norm(out, True)
        t.rows((s // 8 - 1) ** 2, 256, 1, 1, True)
        t.sums(1, True)  # the logit

    g, d = params
    g_pass(True)
    d_pass(True)
    t.grads(g + 3)
    g_pass(False)
    d_pass(False)
    d_pass(False)
    t.grads(d + 1)
    return {**t.bytes, **{f"{k}_calls": v for k, v in t.calls.items()}}


def depth_worker(torch, tmp):
    """One rank of the depth phase's world (two gloo ranks on one card; with
    four or more cards four, a card each under NCCL), after the file
    ``tmp``/depth_go appears: (a) DEPTH_FWD_CALLS calls of
    ``infer_volume_depth_sharded`` over every rank in f32 and in bf16,
    timed, each with its peak memory (the outputs in
    depth_fwd_<dtype><r>.npy); (b) each run of ``tmp``/depth_runs.json
    through :func:`_sp_rank_train`. Results in ``tmp``/depth_rank<r>.json,
    rank 0's weights in <run>_rank0.pt."""
    import numpy as np

    from ctagan_tpu_torch.parallel import dist, volume

    # entry, the group, the go, (a), each run
    marks = [time.time()]
    dev = (dist.init(torch.device("cuda")) if torch.cuda.device_count() > 1
           else dist.init(torch.device("cuda", 0), backend="gloo"))
    marks.append(time.time())
    while not os.path.exists(os.path.join(tmp, "depth_go")):
        time.sleep(0.05)
    marks.append(time.time())
    rank = dist.rank()
    res = {"forward": {}}
    vol = _depth_series(dist.world())
    mesh = volume.make_depth_mesh()
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        g = _depth_g(torch, dev, dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        calls = []
        for _ in range(DEPTH_FWD_CALLS):
            t0 = time.perf_counter()
            out = volume.infer_volume_depth_sharded(g, vol, mesh,
                                                    halo=DEPTH_HALO)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
        res["forward"][name] = {"s": calls,
                                "peak": torch.cuda.max_memory_allocated(dev)}
        np.save(os.path.join(tmp, f"depth_fwd_{name}{rank}.npy"), out)
        del g, out
        torch.cuda.empty_cache()
    marks.append(time.time())
    with open(os.path.join(tmp, "depth_runs.json")) as f:
        runs = json.load(f)
    res["runs"] = {}
    for run in runs:
        res["runs"][run["name"]] = _sp_rank_train(
            torch, dev, tmp, run["name"], run["cls"], run["steps"])
        torch.cuda.empty_cache()
        marks.append(time.time())
    res["marks"] = marks
    with open(os.path.join(tmp, f"depth_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()
    return 0


def _depth_forward_one(torch, dev, world):
    """One process's forwards of the symmetric-extended series, cropped,
    f32 and bf16: {dtype: (the output, seconds by call, peak bytes)}."""
    import numpy as np

    ext = np.pad(_depth_series(world), ((DEPTH_HALO, DEPTH_HALO), (0, 0),
                                        (0, 0)), mode="symmetric")
    x = torch.from_numpy(ext).to(dev)[None, ..., None]
    out = {}
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        g = _depth_g(torch, dev, dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        secs = []
        with torch.no_grad():
            for _ in range(DEPTH_FWD_CALLS):
                t0 = time.perf_counter()
                y = g(x)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        out[name] = (y[0, DEPTH_HALO:-DEPTH_HALO, :, :, 0].float().cpu(),
                     secs, peak)
        del g, y
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return out


def _depth_infer(torch, dev, tmp, card):
    """(c) ``--mode infer``'s ``infer()`` on a copy of configs/P3d.yaml in
    f32 with ``infer_depth_sharded: true`` at world 1 (seeded weights: no
    checkpoint in its save_root) over a seeded DEPTH_SERIES-slice DICOM
    series: every SE2 file named as its source, within INFER_PIXEL_TOL of
    the direct forward of the symmetric-extended series, cropped."""
    import numpy as np

    from ctagan_tpu_torch.__main__ import infer
    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.models.volumetric import Generator3D
    from ctagan_tpu_torch.parallel.serve import load_series_fullrange
    from ctagan_tpu_torch.utils.config import load_config

    root = os.path.join(tmp, "infer")
    make_corpus(root, n_patients=1, slices_per_patient=DEPTH_SERIES,
                size=512, seed=9, lists=("train",))
    series = os.path.join(root, "patient0", "ST0", "SE0")
    config = load_config(_smoke_config(
        root, os.path.join(root, "unused.txt"),
        f"image_save: '{root}/img/'\ncompute_dtype: float32\n"
        "infer_depth_sharded: true\n", base="P3d.yaml"))
    reset_counts()
    times = {}
    t0 = time.perf_counter()
    out_dir = infer(config, dev, series, times)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    px = _se2_series(torch, out_dir, series)
    volume, paths = load_series_fullrange(series, size=config.size)
    ext = np.pad(volume, ((DEPTH_HALO, DEPTH_HALO), (0, 0), (0, 0)),
                 mode="symmetric")
    g = Generator3D(1, 1).reset_parameters(config.seed).to(dev)
    with torch.no_grad():
        direct = g(torch.from_numpy(ext).to(dev)[None, ..., None])[
            0, DEPTH_HALO:-DEPTH_HALO, :, :, 0].float().cpu().numpy()
    del g
    torch.cuda.empty_cache()
    # the writeback's own f32 arithmetic and truncation: a slice within
    # one stored unit of it
    worst = max(int(np.abs(px[os.path.basename(p)] - (
        (direct[i] + 1.0) * 0.5 * 4095.0).astype(np.int16)).max())
        for i, p in enumerate(paths))
    print(f"depth (c): --mode infer, infer_depth_sharded at world 1, P3d.yaml "
          f"in f32 (seeded G), a {DEPTH_SERIES}-slice 512^2 series: "
          f"{secs:.3f} s = {DEPTH_SERIES / secs:.2f} slices/s; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; launches {counts}; {len(px)} SE2 files vs the direct forward "
          f"of the symmetric-extended series (halo {DEPTH_HALO}), cropped, "
          f"stored as the writeback stores it: max {worst} stored units "
          f"(tol {INFER_PIXEL_TOL}) [{card}]",
          flush=True)
    if counts != counts_of() or len(px) != DEPTH_SERIES \
            or worst > INFER_PIXEL_TOL:
        fail(f"depth (c): the sharded infer's series is {worst} stored units "
             f"from the direct forward ({len(px)} files, launches {counts})")


def check_depth(torch, card):
    """Phase 22, a main path: the depth plan (``parallel/volume.py``). Two
    gloo ranks share the card (four or more cards: four ranks, a card each,
    under NCCL), started first (:func:`depth_worker`); meanwhile one
    process's references and (c). (a) ``infer_volume_depth_sharded`` over
    every rank against one process's forward of the symmetric-extended
    series, cropped, within GEN_TOL (f32), the bf16 run's error printed,
    each rank's seconds and peak memory beside the one process's; (b) the
    P3d runs (:func:`_depth_runs`) through the entry point's ``train()``,
    each held by :func:`_sp_run_held` against one process's float64 replay
    (the bytes each rank gathers and all-reduces a step exactly as
    :func:`_depth_expect` predicts, no launch, the replicas bit-identical,
    the ``.pt`` bit-equal at world 1), the DEPTH_DEEP step against one
    f32 process, its peak memory per rank beside one process's; (c)
    :func:`_depth_infer`. Returns the ranks' launches (none: the 3-D convs
    are cuDNN's)."""
    import numpy as np

    from ctagan_tpu_torch.data.fixtures import make_corpus
    from ctagan_tpu_torch.models.volumetric import Discriminator3D, Generator3D
    from ctagan_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2
    how = "a card each (NCCL)" if cards > 1 else "on one card (gloo)"
    params = [sum(p.numel() for p in m.parameters())
              for m in (Generator3D(1, 1), Discriminator3D(2))]
    runs = _depth_runs(world)
    for run in runs:
        run["expect"] = _depth_expect(run["mesh"], 512, params)
    counts = dict.fromkeys(SOURCES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lists = {}
        # an epoch of DEPTH_STEPS global batches for every run's dp
        n_train = DEPTH_PATIENTS * max(r["mesh"].get("dp", 1) for r in runs)
        for name, n_pat, n_sl in (("train", n_train, DEPTH_SLICES),
                                  ("deep", DEPTH_DEEP_STEPS, DEPTH_DEEP)):
            lst = make_corpus(os.path.join(tmp, name), n_patients=n_pat,
                              slices_per_patient=n_sl, size=512, seed=0,
                              lists=("train",))["train"]
            first = _write_list(os.path.join(tmp, f"{name}_val.txt"),
                                _read_list(lst)[:n_sl])
            lists[name] = {"train": lst, "val": first, "test": first}

        def yaml(name, extra, base="P3d.yaml", patch=8):
            path = _smoke_config(
                tmp, lists["deep" if patch == DEPTH_DEEP else "train"],
                f"save_root: '{tmp}/{name}/'\nimage_save: '{tmp}/{name}_img/'"
                f"\nlive_panels: false\ncompute_dtype: float32\nn_epochs: 1\n"
                f"decay_epoch: 0\npatch_depth: {patch}\n" + extra, base=base)
            shutil.move(path, os.path.join(tmp, f"{name}.yaml"))
            return os.path.join(tmp, f"{name}.yaml")

        for run in runs:
            yaml(run["name"], _mesh_spec(run["mesh"]), patch=run["patch"])
        with open(os.path.join(tmp, "depth_runs.json"), "w") as f:
            json.dump(runs, f)
        print(f"depth: the corpora {time.perf_counter() - t0:.1f} s; G, D "
              f"parameters {params}; predicted a rank's step of "
              + "; ".join(f"{r['name']} ({r['mesh']}, patch_depth "
                          f"{r['patch']}): {r['expect']}" for r in runs)
              + f" [{card}]", flush=True)
        t_wall = time.time()
        ranks_proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", os.path.abspath(__file__),
             "--dp-worker", tmp, "--dp-name", "depth"])
        try:
            # (a) one process: the extended series' forwards
            one_fwd = _depth_forward_one(torch, dev, world)
            # (b) one process of each run (at batchSize dp and grad_accum
            # dp), its float64 replay at patch_depth 8
            refs = {}
            for run in runs:
                r_dp = run["mesh"].get("dp", 1)
                refs[run["name"]] = _sp_one(torch, load_config(yaml(
                    f"{run['name']}_one", f"batchSize: {r_dp}\n"
                    f"grad_accum: {r_dp}\n", patch=run["patch"])), dev,
                    f64=run["patch"] != DEPTH_DEEP, cls_name=run["cls"],
                    n_steps=run["steps"])
            # (c) the sharded infer at world 1
            _depth_infer(torch, dev, tmp, card)
            open(os.path.join(tmp, "depth_go"), "w").close()
            t1 = time.perf_counter()
            rc = ranks_proc.wait()
        finally:
            if ranks_proc.poll() is None:
                ranks_proc.terminate()
                ranks_proc.wait()
        wall = time.perf_counter() - t1
        if rc != 0:
            fail(f"depth: a rank exited {rc}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"depth_rank{r}.json")) as f:
                ranks.append(json.load(f))
        # (a)
        for name, (want, one_s, one_peak) in one_fwd.items():
            got = [torch.from_numpy(np.load(os.path.join(
                tmp, f"depth_fwd_{name}{r}.npy"))) for r in range(world)]
            errs = [rel_err(torch, x, want) for x in got]
            secs = [[round(t, 3) for t in r["forward"][name]["s"]]
                    for r in ranks]
            peaks = [round(r["forward"][name]["peak"] / 2**30, 3)
                     for r in ranks]
            print(f"depth (a) {name}: infer_volume_depth_sharded of the "
                  f"shipped Generator3D on a {len(want)}-slice 512^2 series, "
                  f"halo {DEPTH_HALO}, {world} ranks {how}, vs one process's "
                  f"forward of the symmetric-extended series, cropped: max "
                  f"error by rank {errs}"
                  + (f" (tol {GEN_TOL})" if name == "float32" else "")
                  + f"; the ranks' outputs bit-equal "
                  f"{all(torch.equal(x, got[0]) for x in got)}; seconds of "
                  f"{DEPTH_FWD_CALLS} calls by rank {secs} (one process "
                  f"{[round(t, 3) for t in one_s]}); peak memory by rank "
                  f"{peaks} GiB (one process {one_peak / 2**30:.3f} GiB) "
                  f"[{card}]", flush=True)
            if any(tuple(x.shape) != tuple(want.shape) for x in got) or \
                    (name == "float32" and not max(errs) <= GEN_TOL):
                fail(f"depth (a): the sharded {name} forward differs from "
                     "one process's")
        # (b)
        for run in runs:
            res = [r["runs"][run["name"]] for r in ranks]
            if run["patch"] != DEPTH_DEEP:
                held = _sp_run_held(torch, card, tmp, run, refs[run["name"]],
                                    res, world, how, yaml, dev)
            else:
                held = _depth_deep_held(card, run, refs[run["name"]], res,
                                        world, how)
            for k, n in held.items():
                counts[k] += n
        print(f"depth: the world's wall from the go {wall:.1f} s; seconds "
              f"from the launch to each rank's start, group, go, (a) and "
              f"each run done "
              f"{[[round(m - t_wall, 1) for m in r['marks']] for r in ranks]}"
              f" [{card}]", flush=True)
    return counts


def _depth_deep_held(card, run, one, ranks, world, how):
    """The DEPTH_DEEP steps: each rank's bytes against
    :func:`_depth_expect` exactly (the slab's depth does not enter), no
    launch, the replicas bit-identical after each step, the first-step
    losses within FAMILY_ROUTE_TOL of one f32 process's; each rank's peak
    memory and each step's wall beside the one process's. Returns the
    ranks' launches."""
    expect = run["expect"]
    for r, res in enumerate(ranks):
        step_bytes = {k: sorted({s["bytes"] for s in res[k]})
                      for k in ("gather", "reduce", "scatter")}
        print(f"depth {run['name']} ({run['mesh']}, patch_depth "
              f"{run['patch']}) rank {r} of {world} {how}: a step's bytes "
              f"{step_bytes} (expected {expect}); peak memory "
              f"{res['peak'] / 2**30:.3f} GiB (one process "
              f"{one['peak'] / 2**30:.3f} GiB); steps "
              f"{[round(t * 1e3, 1) for t in res['step_s']]} ms (one "
              f"process {[round(t * 1e3, 1) for t in one['step_s']]}; a "
              f"single step: its shapes' first); losses {res['losses']} "
              f"(one process {one['losses']}) [{card}]", flush=True)
        if res["counts"] != counts_of() or any(
                step_bytes[k] != [expect[k]] for k in step_bytes):
            fail(f"depth {run['name']}: rank {r}'s launches {res['counts']} "
                 f"or bytes {step_bytes}, expected {expect}")
    same = [len(set(d)) == 1 for d in zip(*(res["digests"] for res in ranks))]
    if len(same) != run["steps"] or not all(same):
        fail(f"depth {run['name']}: the ranks' weights differ after a step "
             f"{same}")
    first = max(abs(ranks[0]["losses"][0][k] - v) / max(abs(v), 1e-12)
                for k, v in one["losses"][0].items())
    if first > FAMILY_ROUTE_TOL:
        fail(f"depth {run['name']}: first-step losses {first:.2e} from one "
             "process's")
    counts = dict.fromkeys(SOURCES, 0)
    for res in ranks:
        for k in counts:
            counts[k] += res["counts"].get(k, 0)
    return counts


def check_tensor_cores(lib_path):
    """K1's, K2's, K3's, K4's and K5's kernels (each instantiation, f32 and
    bf16 I/O) hold HGMMA (wgmma) instructions in the built library's SASS,
    so one that runs on CUDA-core FMAs fails; K7's (each input and output
    type) hold IGMMA (int8 wgmma) and no IDP4A."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        res = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"cuobjdump: {e!r}")
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[-2000:]}")
    funcs = [(f.split("\n", 1)[0].strip(), f)
             for f in res.stdout.split("Function : ")[1:]]
    for k, kernel in WGMMA_KERNELS.items():
        counts = {name: f.count("HGMMA") for name, f in funcs
                  if kernel in name}
        print(f"sass: {k} kernels and their HGMMA instructions: {counts}",
              flush=True)
        dtypes = {"f32" if "kernelIf" in name else "bf16" for name in counts}
        if dtypes != {"f32", "bf16"} or not all(counts.values()):
            fail(f"{k}'s f32 and bf16 kernels must all run on wgmma (HGMMA)")
    k7 = {name: (f.count("IGMMA"), f.count("IDP4A")) for name, f in funcs
          if K7_WGMMA_KERNEL in name}
    print(f"sass: K7 kernels and their (IGMMA, IDP4A) instructions: {k7}",
          flush=True)
    # the mangled template arguments' types (input, output), without the
    # tile width: e.g. "af" for <signed char, float, 256>
    kinds = {re.sub(r"Li\d+E.*", "", name.split(K7_WGMMA_KERNEL + "I", 1)[1])
             for name in k7}
    if len(kinds) < K7_KINDS or not all(i > 0 and d == 0
                                         for i, d in k7.values()):
        fail(f"K7's {K7_KINDS} input/output kinds must all run on int8 "
             "wgmma (IGMMA) with no IDP4A")


SOURCES = {
    "conv3x3_reflect_stats": ("ctagan_tpu_torch/csrc/fused_resblock.cu",
                              "ctagan_tpu/ops/fused_resblock.py:172"),
    "conv3x3_s2_zero_stats": ("ctagan_tpu_torch/csrc/fused_down.cu",
                              "ctagan_tpu/ops/fused_down.py:121"),
    "convt2x_stats": ("ctagan_tpu_torch/csrc/fused_convt.cu",
                      "ctagan_tpu/ops/fused_convt.py:141"),
    "conv3x3_input_grad": ("ctagan_tpu_torch/csrc/fused_resblock_grad.cuh",
                           "ctagan_tpu/ops/fused_resblock_grad.py:100"),
    "conv3x3_weight_grad": ("ctagan_tpu_torch/csrc/fused_resblock_grad.cuh",
                            "ctagan_tpu/ops/fused_resblock_grad.py:282"),
    "instance_norm_pallas": ("ctagan_tpu_torch/csrc/instance_norm.cu",
                             "ctagan_tpu/ops/pallas_kernels.py:65"),
    "conv3x3_reflect_s8": ("ctagan_tpu_torch/csrc/fused_s8.cu",
                           "ctagan_tpu/ops/fused_s8.py:105"),
}


MAIN_PATHS = {"serving": check_serving,
              "int8_serving": lambda torch, card: check_serving(
                  torch, card, quantize="int8"),
              "training": check_training,
              "test": check_test,
              "stage2": check_stage2,
              "families": check_families,
              "infer": check_infer,
              "figures": check_figures,
              "loop": check_loop,
              "p3d": check_p3d,
              "corpus": check_corpus,
              "dp": check_dp,
              "fsdp": check_fsdp,
              "tp": check_tp,
              "sp": check_sp,
              "depth": check_depth}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES)
                    + " (a subset stops before the result lines)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated kernels (K1..K7) whose cases and "
                    "timing lines the kernels phase runs (stops before the "
                    "result lines)")
    ap.add_argument("--dp-worker", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)  # a rank of the dp phase
    ap.add_argument("--dp-name", default="dp",
                    help=argparse.SUPPRESS)  # or of an fsdp phase's mesh
    args = ap.parse_args()
    phases = args.phases.split(",")
    cases = args.cases.split(",") if args.cases else None
    try:
        import torch
    except ImportError as e:
        fail(f"torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "ctagan_tpu_torch")):
        fail(f"ctagan_tpu_torch not found beside {__file__}")
    sys.path.insert(0, REPO)
    for mod in ("jax", "flax", "ctagan_tpu"):  # the port must not need them
        sys.modules[mod] = None
    # the plain versions are the oracle: f32 convs and matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dp_worker:
        if args.dp_name == "sp":
            return sp_worker(torch, args.dp_worker)
        if args.dp_name == "depth":
            return depth_worker(torch, args.dp_worker)
        return dp_worker(torch, args.dp_worker, args.dp_name)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from ctagan_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load_library(verbose=True)
    print(f"built kernels from {os.path.relpath(_build.SRC_DIR, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s -> {lib._name}", flush=True)
    check_tensor_cores(lib._name)

    kernels, launches = {}, {name: 0 for name in SOURCES}
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "kernels":
            kernels = check_kernels(torch, cases)
            if cases is None or "K5" in cases:
                check_k5_operands(torch)
            time_wrapper_parts(torch, cases)
            if cases is None or "K6" in cases:
                time_k6(torch)
        elif phase == "generator":
            check_generator(torch, card)
            check_zero_pad_serving(torch, card)
            check_zero_pad_serving(torch, card, norm_switch=True)
        elif phase == "int8":
            check_int8_generator(torch, card)
        elif phase == "grad":
            check_generator_grad(torch, card)
        elif phase == "export":
            check_export(torch, card)
        elif phase in MAIN_PATHS:
            for name, n in MAIN_PATHS[phase](torch, card).items():
                launches[name] += n
        else:
            fail(f"unknown phase {phase!r}")
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    if tuple(phases) != ALL_PHASES or cases is not None:
        print(f"partial run ({','.join(phases)}"
              f"{'; cases ' + args.cases if cases else ''}): no result lines",
              flush=True)
        return 0
    line = []
    for name, (src, replaces) in SOURCES.items():
        if launches[name] < 1:
            fail(f"{name} was not launched on a main path")
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     **kernels[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
