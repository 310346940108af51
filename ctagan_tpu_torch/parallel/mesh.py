"""The parallel plan of the port (``ctagan_tpu/parallel/mesh.py``): which
plan a config's ``mesh:`` (or ``data_parallel``) asks for, and how a rank
takes its rows of a global batch.

The data-parallel plan (``dp``): N ranks of one process group
(``parallel/dist.py``), one card each, the parameters replicated, each
rank's ``batchSize`` rows of a global batch of ``batchSize × N``, and the
gradients mean-reduced over the ranks in the train steps. The fsdp plan
(``{fsdp: N}``, or the hybrid ``{dp: M, fsdp: N}``): M × N ranks, the
state sharded over each block of N (``parallel/fsdp.py``), the batch over
all M × N, as JAX's ``P((data, fsdp))``. A rank's rows are the block that
device ``rank`` holds under JAX's sharding of the global batch. The tp
plan (``{tp: N}``, or ``{dp: M, tp: N}``): M × N ranks, each residual pair
split over each block of N (``parallel/tensor.py``), the batch over the M
dp columns alone, as JAX's ``P(data)`` replicates it over ``model``: the N
ranks of a block read the same rows. The sp plan (``{sp: N}``, or ``{dp:
M, sp: N}``): M × N ranks, the rows of every activation split over each
block of N (``parallel/spatial.py``), the batch over the M dp columns, as
JAX's ``P(data, spatial)`` replicates the batch's rows over ``spatial``:
the N ranks of a block read the same images and each trains on its strip.
The depth plan (``{depth: N}``, or ``{dp: M, depth: N}``): M × N ranks,
the D axis of every volume split over each block of N
(``parallel/volume.py``), the batch over the M dp columns, as JAX's
``P(data, depth)``; JAX's depth placement shards axis 1 of a 2-D
family's NHWC batch, its H, so the 2-D families take the sp plan's step
there. pp is validated as in JAX and raises naming its ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

MODEL_AXES = ("fsdp", "tp", "sp", "depth", "pp")
# the ROADMAP item of each model axis not ported yet
_ITEMS = {"pp": "M12e"}


@dataclass(frozen=True)
class MeshPlan:
    """``kind`` names the plan (``"dp"``, ``"fsdp"``, ``"tp"``, ``"sp"``
    or ``"depth"``); ``batch_scale`` is how many ways the global batch
    splits: the number of ranks, ``dp`` × ``fsdp``, or ``dp`` under tp, sp
    and depth."""

    kind: str
    batch_scale: int
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    depth: int = 1

    def batch_rank(self, rank: int) -> int:
        """Which of the ``batch_scale`` blocks of a global batch rank
        ``rank`` reads: its own, or under tp, sp and depth its dp
        column's."""
        return rank // (self.tp * self.sp * self.depth)

    def describe(self) -> str:
        """JAX's "mesh plan" line: the mesh's axes and extents; under tp,
        sp and depth also that its step runs no kernel."""
        model = {"fsdp": ("fsdp", self.fsdp), "tp": ("model", self.tp),
                 "sp": ("spatial", self.sp), "depth": ("depth", self.depth)}
        if self.kind == "dp":
            axes = {"data": self.dp}
        else:
            name, n = model[self.kind]
            axes = {name: n} if self.dp == 1 else {"data": self.dp, name: n}
        line = (f"mesh plan: {axes} (kind={self.kind}, "
                f"batch x{self.batch_scale})")
        if self.kind == "tp":
            line += ("; the split residual pairs run the layer route, so "
                     "the tp step launches no kernel (JAX's gate)")
        elif self.kind == "sp":
            line += ("; the strips run the layer route, so the sp step "
                     "launches no kernel (JAX's gate)")
        elif self.kind == "depth":
            line += ("; the slabs run cuDNN's 3-D convs (2-D families: the "
                     "sp step's strips, the layer route), so the depth step "
                     "launches no kernel (JAX's gate)")
        return line


def plan_from_spec(spec, world: int) -> MeshPlan:
    """A plan from a ``config.mesh`` dict (keys dp/fsdp/tp/sp/depth/pp, each
    an axis extent, default 1) for a group of ``world`` ranks, validated as
    JAX's: unknown axes, extents below 1 and more than one model axis above
    1 raise ValueError. pp above 1 then raises NotImplementedError naming
    its ROADMAP item, whatever the world. ``{dp: M}`` (or ``{}``, M = 1),
    ``{dp: M, fsdp: N}``, ``{dp: M, tp: N}``, ``{dp: M, sp: N}`` and ``{dp:
    M, depth: N}`` need exactly ``world`` = M × N ranks: more raise JAX's
    "needs M × N devices", fewer that the group is larger than the
    plan."""
    spec: Dict[str, int] = dict(spec or {})
    unknown = set(spec) - {"dp", *MODEL_AXES}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)} "
                         "(have dp, fsdp, tp, sp, depth, pp)")
    sizes = {k: int(spec.get(k, 1)) for k in ("dp", *MODEL_AXES)}
    if any(v < 1 for v in sizes.values()):
        raise ValueError(f"mesh axis extents must be >= 1, got {spec}")
    model_axes = [k for k in MODEL_AXES if sizes[k] > 1]
    if len(model_axes) > 1:
        raise ValueError(
            f"at most one of fsdp/tp/sp/depth/pp may exceed 1, got {spec} "
            "(dp composes with any single one)")
    if model_axes and model_axes[0] in _ITEMS:
        kind = model_axes[0]
        raise NotImplementedError(
            f"mesh {spec}: the {kind} plan is not ported yet (ROADMAP "
            f"{_ITEMS[kind]}); the port runs the dp, fsdp, tp, sp and "
            "depth plans")
    dp, fsdp, tp, sp = sizes["dp"], sizes["fsdp"], sizes["tp"], sizes["sp"]
    depth = sizes["depth"]
    total = dp * fsdp * tp * sp * depth
    if total > world:
        raise ValueError(f"mesh {spec} needs {total} devices, have {world}")
    if total < world:
        raise ValueError(
            f"mesh {spec} trains on {total} rank(s), but the process group "
            f"has {world}: launch {total} (torchrun --nproc-per-node "
            f"{total})")
    if tp > 1:
        return MeshPlan("tp", dp, dp, tp=tp)
    if sp > 1:
        return MeshPlan("sp", dp, dp, sp=sp)
    if depth > 1:
        return MeshPlan("depth", dp, dp, depth=depth)
    return MeshPlan("fsdp" if fsdp > 1 else "dp", total, dp, fsdp)


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n``: the ``rank``-th of
    ``world`` equal blocks."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    m = n // world
    return slice(rank * m, (rank + 1) * m)


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s rows of each entry (arrays, tensors, path lists) of a
    global batch dict."""
    return {k: v[shard_rows(len(v), rank, world)] for k, v in batch.items()}


def pad_batch_to(batch, target: int):
    """Pad the leading axis up to ``target`` (repeat last element) so a
    ragged final batch still shards evenly; returns (padded, valid_count)."""
    out = {}
    n = None
    for k, v in batch.items():
        if k.endswith("_path"):
            out[k] = v
            continue
        n = v.shape[0]
        if n < target:
            reps = np.concatenate([v] + [v[-1:]] * (target - n), axis=0)
            out[k] = reps
        else:
            out[k] = v
    return out, (n if n is not None else target)
