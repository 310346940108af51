"""The port's process group: the counterpart of ``jax.process_index`` and
``jax.process_count`` for the data-parallel plan (``parallel/mesh.py``).

A process joins a group only when a launcher has set torchrun's env
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): ``torchrun``, which ``python -m ctagan_tpu_torch --mode
train`` also starts itself on a host with several cards. Without that env
the process is world 1 and no group exists, and every helper here is the
identity. The backend is NCCL when the rank's device is
a CUDA device and gloo on the CPU; each rank's device is ``cuda:LOCAL_RANK``
unless the caller names one. An explicit ``backend="gloo"`` lets several
ranks share one card (NCCL refuses two ranks on one device). A group that
cannot form raises: a rank never carries on as world 1.

The data-parallel plan reaches ``all_reduce`` and ``broadcast``, which gloo
also runs on CUDA tensors. The fsdp plan (``parallel/fsdp.py``) adds
:func:`mesh_groups` (its fsdp blocks and dp columns) and two collectives on
flat buffers, :func:`all_gather_into` and :func:`reduce_scatter_mean`:
``all_gather_into_tensor`` and ``reduce_scatter_tensor``, which NCCL runs
on the card and gloo on the CPU alone, so under gloo a CUDA buffer goes
through the host. The path is chosen by the group's backend. The tp plan
(``parallel/tensor.py``) takes the same mesh, its tp blocks and dp
columns, and reduces, sums and gathers rows within a group
(:func:`all_reduce_mean_`, :func:`all_reduce_sum_`, :func:`gather_rows`
with ``group``); a rank's column index (:func:`column_rank`) says which
rows of the global batch it reads. The sp plan (``parallel/spatial.py``,
``parallel/halo.py``) takes the same mesh, its sp blocks and dp columns,
and adds :func:`neighbour_rows` (each rank's edge rows to the ranks above
and below it in its block: one ``all_gather_into_tensor`` of every rank's
edges), :class:`SumOverGroup` (a sum over the block that autograd
differentiates as a sum over the block) and the strips' gather
(:func:`gather_whole`, whose backward reduce-scatters), for the layers
that read a whole image; ``spatial.strip`` takes a rank's strip back (a
slice, whose gradient autograd writes into zeros with no communication).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# how long a collective waits for the other ranks before it raises
_TIMEOUT = timedelta(minutes=30)
# where the group's own small tensors live (set by init): the rank's card
# under NCCL, the CPU under gloo
_coll_device: Optional[torch.device] = None


def launched() -> bool:
    """True when a launcher set the env of a group to join."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device=None, backend: Optional[str] = None
         ) -> Optional[torch.device]:
    """Join the launcher's group, if its env names one, and return this
    rank's device: ``device`` as given, except that a CUDA device without an
    index becomes ``cuda:LOCAL_RANK``. Without the env nothing is joined and
    ``device`` comes back unchanged. ``backend``: NCCL for a CUDA device,
    gloo otherwise, unless named."""
    global _coll_device
    if not launched():
        return device
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a process group needs {', '.join(_ENV)}; "
                           f"{', '.join(missing)} unset")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        if (not torch.cuda.is_available()
                or dev.index >= torch.cuda.device_count()):
            raise RuntimeError(f"rank {rank}: no CUDA device {dev}")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not tdist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        tdist.init_process_group(backend, rank=rank, world_size=world,
                                 timeout=_TIMEOUT, **kw)
    _coll_device = dev if backend == "nccl" else torch.device("cpu")
    return dev


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if initialized() else 0


def world() -> int:
    return tdist.get_world_size() if initialized() else 1


def is_host0() -> bool:
    return rank() == 0


def shutdown() -> None:
    """Leave the group (every rank, at the end of its work)."""
    global _coll_device
    if initialized():
        tdist.destroy_process_group()
    _coll_device = None


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                     mean: bool = True) -> None:
    """Replace each tensor by its mean over the ranks of ``group`` (default:
    every rank), in place: one flat buffer per dtype, one ``all_reduce`` SUM
    each, divided by the group's size (with ``mean`` False: the sum). In a
    group of one the values come back bit for bit."""
    if not initialized():
        return
    n = tdist.get_world_size(group) if mean else 1
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for parts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in parts])
        tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
        flat.div_(n)
        for t, chunk in zip(parts, flat.split([t.numel() for t in parts])):
            t.copy_(chunk.view_as(t))


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch of ``x`` over the ranks of ``group`` (default: every
    rank), in their order: an ``all_reduce`` SUM of a zero-filled global
    buffer in which each rank fills its own rows, so each value is its
    rank's own. Without a process group, ``x`` itself."""
    if not initialized():
        return x
    n, r = x.shape[0], tdist.get_rank(group)
    buf = x.new_zeros((n * tdist.get_world_size(group), *x.shape[1:]))
    buf[r * n:(r + 1) * n] = x
    tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=group)
    return buf


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (default: every rank), in
    place (the identity without a process group)."""
    if initialized():
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    return t


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (picklable; ``obj`` itself without a
    group), for decisions that every rank must take alike."""
    if not initialized():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0, device=_coll_device)
    return box[0]


def barrier() -> None:
    """Wait for every rank: an ``all_reduce`` of one element."""
    if initialized():
        t = torch.zeros(1, device=_coll_device)
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
        t.item()  # waits for the collective



def mesh_groups(dp: int, fsdp: int) -> Tuple[object, Optional[object]]:
    """This rank's groups of a ``dp`` × ``fsdp`` mesh laid out as JAX's
    ``reshape(dp, fsdp)`` (``fsdp`` the fsdp or the tp extent): its block
    (``fsdp`` consecutive ranks) and its dp column (the ``dp`` ranks spaced
    by ``fsdp``; None when ``dp`` is 1). A block of the whole world is the
    default group. Every rank creates every group, in the same order, as
    ``new_group`` needs."""
    n, r = world(), rank()
    if dp * fsdp != n:
        raise ValueError(f"a {dp} x {fsdp} mesh needs {dp * fsdp} ranks, "
                         f"the group has {n}")
    if dp == 1:
        return tdist.group.WORLD, None
    block = column = None
    for d in range(dp):
        g = tdist.new_group(list(range(d * fsdp, (d + 1) * fsdp)))
        if r // fsdp == d:
            block = g
    for f in range(fsdp):
        g = tdist.new_group(list(range(f, n, fsdp)))
        if r % fsdp == f:
            column = g
    return block, column


def first_ranks(n: int):
    """A group of the first ``n`` ranks (``new_group``, which every rank
    calls, in the same order): the handle, or None for a group of one."""
    return tdist.new_group(list(range(n))) if n > 1 else None


def column_rank(n: int) -> int:
    """This rank's place in its dp column of a mesh of blocks of ``n``
    (:func:`mesh_groups`): which rows of the global batch it reads under
    tp, where the ``n`` ranks of a block read the same rows."""
    return rank() // n


def _through_host(t: torch.Tensor, group) -> bool:
    """gloo runs neither ``all_gather_into_tensor`` nor
    ``reduce_scatter_tensor`` on CUDA tensors."""
    return t.is_cuda and tdist.get_backend(group) == "gloo"


def all_gather_into(out: torch.Tensor, shard: torch.Tensor, group) -> None:
    """``out`` (the group's size × ``shard``'s elements, flat) ← every
    rank's ``shard`` of ``group``, in rank order."""
    if _through_host(shard, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        tdist.all_gather_into_tensor(host, shard.cpu(), group=group)
        out.copy_(host)
    else:
        tdist.all_gather_into_tensor(out, shard, group=group)


def reduce_scatter_sum(flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of ``flat`` (1 / the group's size of it) summed
    over the ranks of ``group``: a ``reduce_scatter_tensor`` SUM."""
    out = flat.new_empty(flat.numel() // tdist.get_world_size(group))
    if _through_host(flat, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        tdist.reduce_scatter_tensor(host, flat.cpu(), op=tdist.ReduceOp.SUM,
                                    group=group)
        out.copy_(host)
    else:
        tdist.reduce_scatter_tensor(out, flat, op=tdist.ReduceOp.SUM,
                                    group=group)
    return out


def reduce_scatter_mean(flat: torch.Tensor, group,
                        dp_group=None) -> torch.Tensor:
    """This rank's block of ``flat`` (1 / the group's size of it) averaged
    over every rank: a ``reduce_scatter_tensor`` SUM in ``group``, then
    with ``dp_group`` an ``all_reduce`` SUM of the block across it, then
    divided by the world, as :func:`all_reduce_mean_` divides."""
    out = reduce_scatter_sum(flat, group)
    if dp_group is not None:
        tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=dp_group)
    return out.div_(world())


class SumOverGroup(torch.autograd.Function):
    """``x`` summed over the ranks of ``group``; its gradient summed over
    them too. Each rank's loss is its part of one loss, the sum over the
    block; a sum that every part reads (the sp plan's norm statistics and
    pooled logits) takes its gradient from every part. The backward is the
    Function itself, so it differentiates twice (the R1 penalty)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(memory_format=torch.contiguous_format),
                               group)

    @staticmethod
    def backward(ctx, g):
        return SumOverGroup.apply(g, ctx.group), None


def _gather_strips(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (N, h, ...) strip of ``group`` joined along dim 1, in
    rank order: one ``all_gather_into_tensor``."""
    n = tdist.get_world_size(group)
    x = x.contiguous()
    flat = x.new_empty(n * x.numel())
    all_gather_into(flat, x.reshape(-1), group)
    parts = flat.view(n, *x.shape)
    return parts.movedim(0, 1).reshape(x.shape[0], n * x.shape[1],
                                       *x.shape[2:])


def _scatter_sum(g: torch.Tensor, group) -> torch.Tensor:
    """The adjoint of :func:`_gather_strips`: ``g`` (N, n·h, ...) summed
    over the ranks of ``group``, this rank's rows of the sum (one
    ``reduce_scatter_tensor``)."""
    n = tdist.get_world_size(group)
    h = g.shape[1] // n
    parts = g.reshape(g.shape[0], n, h, *g.shape[2:]).movedim(1, 0)
    out = reduce_scatter_sum(parts.contiguous().reshape(-1), group)
    return out.view(g.shape[0], h, *g.shape[2:])


class GatherWhole(torch.autograd.Function):
    """The whole tensor of which every rank of ``group`` holds a strip of
    equal rows (dim 1). Backward: :class:`ScatterSum`, each rank's rows of
    the gradient summed over the ranks that read them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_strips(x, group)

    @staticmethod
    def backward(ctx, g):
        return ScatterSum.apply(g, ctx.group), None


class ScatterSum(torch.autograd.Function):
    """``x`` (every rank's whole tensor) summed over ``group``, this rank's
    strip of the sum. Backward: :class:`GatherWhole`; so the pair
    differentiates any number of times."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return GatherWhole.apply(g, ctx.group), None


def gather_whole(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`GatherWhole` of ``x`` (``x`` itself without a group)."""
    return GatherWhole.apply(x, group) if initialized() else x


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`SumOverGroup` of ``x`` (the identity without a group)."""
    return SumOverGroup.apply(x, group) if initialized() else x


def neighbour_rows(up: torch.Tensor, down: torch.Tensor, group,
                   tag: Optional[torch.Tensor] = None):
    """Each rank of ``group`` sends ``up`` (its first rows) to the rank
    before it and ``down`` (its last rows) to the rank after it; returns
    (the ``down`` of the rank before, the ``up`` of the rank after, every
    rank's ``tag`` in rank order or None), the first two ``None`` at the end
    of the group that has no such rank. Every rank's ``up`` has one shape
    and every rank's ``down`` one shape: the two and the tag (one element
    of their dtype) are packed into one flat buffer and gathered from every
    rank at once (an ``all_gather_into_tensor``, through the host for a
    CUDA tensor under gloo)."""
    n, r = tdist.get_world_size(group), tdist.get_rank(group)
    extra = [] if tag is None else [tag.reshape(-1)]
    part = torch.cat([up.reshape(-1), down.reshape(-1), *extra])
    flat = part.new_empty(n * part.numel())
    all_gather_into(flat, part, group)
    parts = flat.view(n, part.numel())
    k, m = up.numel(), up.numel() + down.numel()
    above = parts[r - 1, k:m].view(down.shape) if r > 0 else None
    below = parts[r + 1, :k].view(up.shape) if r < n - 1 else None
    tags = None if tag is None else parts[:, m].tolist()
    return above, below, tags
