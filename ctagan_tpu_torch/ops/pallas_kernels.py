"""Fused InstanceNorm (+activation) kernel (K6), a CUDA kernel.

The module keeps the name of its counterpart,
``ctagan_tpu/ops/pallas_kernels.py``, whose ``instance_norm_pallas`` is a
Pallas TPU kernel; here :func:`instance_norm_pallas` launches the CUDA kernel
``csrc/instance_norm.cu`` on the route :func:`k6_plan` chooses for the shape:
one read of the activation through a thread-block cluster where a (sample,
channel group) plane fits its shared memory, else a stats pass and a
normalize pass. What bounds it on the H100 is bytes. Its statistics are
summed in a fixed order, so two calls on one input give the same bits.

As in the JAX package it has no backward: the wrapper raises for an input
that requires grad while autograd records. ``models.layers.instance_norm``
runs it when ``models.layers.USE_PALLAS_INSTANCE_NORM`` is set.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`instance_norm_pallas_plain`, which is also the kernel's
oracle on the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops._common import check_input, stream_ptr

ACTIVATIONS = {None: 0, "relu": 1, "leaky_relu": 2}
MAX_CHANNELS = 4096  # the wrapper's limit since the first version

# k6_plan's constants (csrc/instance_norm.cu has the same thread counts)
K6_SMS = 132  # the H100 SXM's SMs: the two-read route aims at 2 blocks each
K6_CLUSTER_THREADS = 512
K6_TWO_READ_THREADS = 256
K6_BLOCK_BYTES = 128 * 1024  # a cluster block's band of the plane
K6_PORTABLE_CLUSTER = 8  # wider groups are taken only up to this size
K6_MAX_CLUSTER = 16  # non-portable, 32-byte groups only
K6_SMEM_LIMIT = 232_448  # 227 KB of shared memory per block
K6_MIN_BAND = 256  # pixels of a two-read block at least
K6_WIDTHS = (128, 64, 32)  # a cluster group's bytes, widest first
K6_TWO_READ_PER_SM = 2  # two-read blocks per SM


class K6Plan(NamedTuple):
    """How K6 covers an (N, H, W, C) input: ``vec`` channels per load (16
    bytes, or 1 where C or the data pointer is not 16-byte aligned),
    ``group`` channels per plane (``vec`` × a power of two slots, at most
    32), and either ``cluster`` blocks of ``band`` pixels each (route 1,
    one read; ``chunks`` = ``cluster``) or ``chunks`` blocks of ``band``
    pixels per plane (route 2, two reads; ``cluster`` = 0). ``threads``
    per block, ``smem`` the cluster block's dynamic shared memory."""
    route: str
    vec: int
    group: int
    cluster: int
    band: int
    chunks: int
    threads: int
    smem: int

    def groups(self, c: int) -> int:
        return -(-c // self.group)


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _group(c: int, vec: int, elem: int, width: int) -> int:
    """Channels of a group at most ``width`` bytes wide: ``vec`` × a power
    of two slots, at most 32 (one warp's lanes), no wider than C needs."""
    slots = min(_next_pow2(-(-c // vec)), max(1, width // (vec * elem)), 32)
    return slots * vec


def k6_cluster_smem(band: int, group: int, elem: int) -> int:
    """Route 1's dynamic shared memory: the band, then the warps' partials
    and three (2, G) f32 arrays (csrc/instance_norm.cu::cluster_smem)."""
    tile = (band * group * elem + 15) // 16 * 16
    return tile + ((K6_CLUSTER_THREADS // 32) * 2 * group + 6 * group) * 4


def k6_plan(n: int, h: int, w: int, c: int, elem: int,
            aligned: bool = True, one_read: bool = True) -> K6Plan:
    """The route for an (N, H, W, C) input of ``elem``-byte elements: one
    read where a plane of 32-byte groups fits a cluster of 16 blocks of
    ``K6_BLOCK_BYTES`` (wider groups, 128 or 64 bytes, where their plane
    fits 8 blocks), else two reads over 256-byte groups in about 2 blocks
    per SM. ``aligned``: the data pointer is 16-byte aligned; ``one_read``
    False forces route 2."""
    hw = h * w
    vec = 16 // elem if aligned and (c * elem) % 16 == 0 else 1
    if one_read:
        for width in K6_WIDTHS:
            g = _group(c, vec, elem, width)
            k = -(-hw * g * elem // K6_BLOCK_BYTES)
            if k <= K6_PORTABLE_CLUSTER or (width == K6_WIDTHS[-1]
                                            and k <= K6_MAX_CLUSTER):
                band = -(-hw // k)
                k = -(-hw // band)
                return K6Plan("cluster", vec, g, k, band, k,
                              K6_CLUSTER_THREADS,
                              k6_cluster_smem(band, g, elem))
    g = _group(c, vec, elem, 256)
    planes = n * -(-c // g)
    chunks = max(1, min(-(-K6_TWO_READ_PER_SM * K6_SMS // planes),
                        -(-hw // K6_MIN_BAND)))
    band = -(-hw // chunks)
    chunks = -(-hw // band)
    return K6Plan("two_read", vec, g, 0, band, chunks, K6_TWO_READ_THREADS, 0)


def k6_scratch_floats(n: int, c: int, plan: K6Plan) -> int:
    """Route 2's f32 scratch: (N, 2, C) mean and rstd, then the blocks'
    (N, groups, chunks, 2G) partials."""
    if plan.route == "cluster":
        return 0
    return n * 2 * c + n * plan.groups(c) * plan.chunks * 2 * plan.group


def _check_args(x, activation):
    check_input("instance_norm_pallas", x)
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {list(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("instance_norm_pallas has no backward (as in the "
                           "JAX package): its input must not require grad")


def instance_norm_pallas_plain(x: torch.Tensor, eps: float = 1e-5,
                               activation: Optional[str] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`instance_norm_pallas`: f32 one-pass
    statistics with the TPU kernel's unclamped variance
    ``s2 / hw − mean²`` (``models.layers.instance_norm`` clamps it at 0)."""
    _check_args(x, activation)
    n, h, w, c = x.shape
    hw = float(h * w)
    xf = x.float()
    mean = xf.sum(dim=(1, 2)) / hw
    var = (xf * xf).sum(dim=(1, 2)) / hw - mean * mean
    inv = torch.rsqrt(var + eps)
    out = (xf - mean[:, None, None, :]) * inv[:, None, None, :]
    if activation == "relu":
        out = torch.relu(out)
    elif activation == "leaky_relu":
        out = torch.where(out >= 0.0, out, 0.2 * out)
    return out.to(x.dtype)


# route 2's arrival counters, one zeroed buffer per (device, stream), grown
# as needed: each call's last block of a plane resets its counter
_COUNTERS: dict = {}
# cudaOccupancyMaxActiveClusters per (device, dtype, vec, group, cluster,
# band): route 1 where the card can run such a cluster, else route 2
_ACTIVE_CLUSTERS: dict = {}


def _counters(x: torch.Tensor, count: int) -> torch.Tensor:
    key = (x.device, stream_ptr(x))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 64), dtype=torch.int32, device=x.device)
        _COUNTERS[key] = buf
    return buf


def k6_active_clusters(x: torch.Tensor, plan: K6Plan) -> int:
    """How many of ``plan``'s clusters the card runs at once (cached)."""
    bf16 = int(x.dtype == torch.bfloat16)
    key = (x.device, bf16, plan.vec, plan.group, plan.cluster, plan.band)
    if key not in _ACTIVE_CLUSTERS:
        count = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            _build.launch("ctk_instance_norm_clusters", bf16, plan.vec,
                          plan.group, plan.cluster, plan.band,
                          ctypes.byref(count))
        _ACTIVE_CLUSTERS[key] = count.value
    return _ACTIVE_CLUSTERS[key]


def k6_plan_for(x: torch.Tensor) -> K6Plan:
    """:func:`k6_plan` for a CUDA tensor: its alignment, and route 2 where
    the card cannot run the plan's cluster."""
    n, h, w, c = x.shape
    plan = k6_plan(n, h, w, c, x.element_size(), x.data_ptr() % 16 == 0)
    if plan.route == "cluster" and plan.smem > K6_SMEM_LIMIT:
        raise ValueError(f"K6 plan {plan} exceeds the shared memory limit")
    if plan.route == "cluster" and k6_active_clusters(x, plan) < 1:
        plan = k6_plan(n, h, w, c, x.element_size(), plan.vec > 1,
                       one_read=False)
    return plan


def _k6_launch(x: torch.Tensor, out: torch.Tensor, plan: K6Plan,
               eps: float, activation: Optional[str]) -> None:
    """One launch of K6's route ``plan`` (no count, no checks)."""
    n, h, w, c = x.shape
    scratch = counters = None
    if plan.route == "two_read":
        scratch = torch.empty(k6_scratch_floats(n, c, plan),
                              dtype=torch.float32, device=x.device)
        counters = _counters(x, n * plan.groups(c))
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_instance_norm", x.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(), n, h, w, c,
            ACTIVATIONS[activation], int(x.dtype == torch.bfloat16),
            float(eps), plan.vec, plan.group, plan.cluster, plan.band,
            plan.chunks, stream_ptr(x),
        )


def instance_norm_pallas(x: torch.Tensor, eps: float = 1e-5,
                         activation: Optional[str] = None) -> torch.Tensor:
    """InstanceNorm(affine=False) over H, W of an NHWC f32 or bf16 tensor,
    with ``activation`` None, ``"relu"`` or ``"leaky_relu"`` (slope 0.2);
    f32 statistics, output in x's dtype."""
    if not x.is_cuda:
        return instance_norm_pallas_plain(x, eps, activation)
    _check_args(x, activation)
    n, h, w, c = x.shape
    if c > MAX_CHANNELS or h * w * c >= 2 ** 31:
        raise ValueError(f"instance_norm_pallas: the CUDA kernel needs C <= "
                         f"{MAX_CHANNELS} and H·W·C < 2^31, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    _k6_launch(x, out, k6_plan_for(x), eps, activation)
    instance_norm_pallas.launches += 1
    return out


instance_norm_pallas.launches = 0
