"""Tensor (channel) parallelism of the port (``ctagan_tpu/parallel/tensor.py``).

Under ``mesh: {tp: N}`` (or the hybrid ``{dp: M, tp: N}``) each residual
pair of the generator's body (``ResidualBlock``), and each of the ResUNet's
(``RegResnetBlock``: the one inside each ``down_i``, the bottleneck's three
and ``refine``'s), is split Megatron-style over the N ranks of a tp block:

- conv1 is column-parallel: a rank keeps 1/N of its output channels (the
  weight's rows and the bias);
- InstanceNorm and ReLU act per (sample, channel), so they run on the
  local channels alone;
- conv2 is row-parallel: a rank keeps the same 1/N of its input channels
  and computes a partial full-width output without the bias; one sum over
  the block completes it, then the bias and the InstanceNorm.

Everything else is replicated: the head, the downs, the ups, the tail, D,
the ResUNet's lone convs, the augmentation generator and the replay pools.
JAX gets this from GSPMD placement (``_spec_for``, ``_reg_spec_for``);
torch has no partitioner, so the port writes the split: :func:`copy_to_tp`
at conv1's input (the identity forward, a sum over the block backward) and
:func:`reduce_from_tp` after conv2's partial product (a sum forward, the
identity backward), Megatron's f and g. A block's forward and its backward
each sum one activation of the block's input shape. JAX's name rule decides
what splits: ``Generator3D``'s ``ResidualBlock3D_k`` does not match
``"ResidualBlock_"``, so the 3-D family trains fully replicated, here too.

A split module keeps its ``nn.Parameter`` objects, cut in place to the
rank's slices (:class:`TpResidualBlock`), so its optimizer, its state-dict
keys and the EMA update stay as they are. :func:`shard_state_tp` cuts the
nets of a ``P2pState``, ``RegState`` or ``CycState``, their Adam moments
alike and the EMA shadows, and keeps the mesh in ``state.tp`` for the rows
a rank reads. :func:`unsharded_state` gathers them back (every rank) for a
checkpoint or loaded weights, so every ``.pt`` is in the one-process
layout; :func:`gathered` does the same for an eval forward.

The gradients (``train/steps.py``): a split parameter's is the rank's own,
mean-reduced over its dp column alone. The replicated ones come out whole
and equal on the tp ranks of a column in exact arithmetic, and are
mean-reduced over every rank with the losses, as under dp: float atomics
in a backward (``grid_sample``'s on the card) would otherwise leave the
replicas apart in their last bits.
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ctagan_tpu_torch.models.layers import RegResnetBlock, ResidualBlock
from ctagan_tpu_torch.parallel import dist
# counts the slices a tp rank keeps as it counts an fsdp rank's shards
from ctagan_tpu_torch.parallel.fsdp import state_bytes_per_rank  # noqa: F401

COLUMN, ROW, REPLICATED = "column", "row", "replicated"
# the dimension of a torch weight (O, I, kh, kw) or bias (O,) each rule cuts
_DIM = {COLUMN: 0, ROW: 1}


@dataclass(frozen=True)
class TpMesh:
    """A rank's place in a ``dp`` × ``n`` mesh (``dist.mesh_groups``): the
    ``n`` ranks of its tp block (``group``) split each residual pair, and
    ``index`` is the slice it keeps; ``column`` is its place in its dp
    column (``dp_group``, None when ``dp`` is 1), the rows of the global
    batch it and its block read."""

    n: int
    index: int
    group: object
    dp: int = 1
    column: int = 0
    dp_group: Optional[object] = None

    def __deepcopy__(self, memo):  # process groups are handles, shared
        return self


def make_tp_mesh(dp: int, tp: int) -> TpMesh:
    """This rank's mesh in the process group; every rank calls it, in the
    same order."""
    group, column = dist.mesh_groups(dp, tp)
    return TpMesh(tp, dist.rank() % tp, group, dp, dist.column_rank(tp),
                  column)


# -- Megatron's f and g ------------------------------------------------------

class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same gradient to the skip path
        return dist.all_reduce_sum_(g.clone(memory_format=torch
                                            .contiguous_format),
                                    ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return dist.all_reduce_sum_(x.clone(memory_format=torch
                                            .contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``."""
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; its gradient passed on as it is."""
    return _ReduceFromTp.apply(x, group)


# -- the rules -----------------------------------------------------------------

_BLOCKS = (ResidualBlock, RegResnetBlock)


def _rules(module: nn.Module, kinds) -> Dict[str, str]:
    """Each state-dict key of ``module`` -> its rule: in each block of
    ``kinds`` conv1's weight and bias column-parallel, conv2's weight
    row-parallel and its bias (added after the sum) replicated; every
    other key replicated."""
    rules = dict.fromkeys(module.state_dict(), REPLICATED)
    for name, m in module.named_modules():
        if isinstance(m, kinds):
            p = f"{name}.conv_block."
            rules.update({p + "1.weight": COLUMN, p + "1.bias": COLUMN,
                          p + "5.weight": ROW})
    return rules


def tp_param_rules(module: nn.Module) -> Dict[str, str]:
    """G's rules (JAX's ``tp_param_specs``): the body's residual pairs, of
    a module not split yet."""
    return _rules(module, ResidualBlock)


def reg_param_rules(module: nn.Module) -> Dict[str, str]:
    """The ResUNet's rules (JAX's ``reg_param_specs``): its residual
    pairs, of a module not split yet."""
    return _rules(module, RegResnetBlock)


# -- the split block -------------------------------------------------------------

def _cut(t: torch.Tensor, dim: int, mesh: TpMesh) -> torch.Tensor:
    """Slice ``mesh.index`` of ``mesh.n`` of ``t`` along ``dim``."""
    size = t.shape[dim] // mesh.n
    return t.narrow(dim, mesh.index * size, size).clone()


def _join(t: torch.Tensor, dim: int, mesh: TpMesh) -> torch.Tensor:
    """Every rank's slice ``t`` of the block, joined along ``dim``."""
    part = t.detach().contiguous()
    flat = part.new_empty(mesh.n * part.numel())
    dist.all_gather_into(flat, part.reshape(-1), mesh.group)
    return torch.cat(flat.view(mesh.n, *part.shape).unbind(0), dim)


class TpResidualBlock(nn.Module):
    """A ``ResidualBlock`` or ``RegResnetBlock`` split over a tp block: its
    own ``conv_block`` (the same modules and parameters, so the same
    state-dict keys), conv1's weight and bias and conv2's weight cut in
    place to this rank's slices. Its forward: :func:`copy_to_tp` → pad →
    conv1 on the local out-channels → InstanceNorm → ReLU → pad → conv2 on
    the local in-channels, no bias → :func:`reduce_from_tp` → + bias →
    InstanceNorm → + x. ``whole`` (the weights gathered,
    :func:`unsharded_state`, :func:`gathered`) runs the block as one
    process does."""

    def __init__(self, block: nn.Module, mesh: TpMesh):
        super().__init__()
        width = block.conv_block[1].weight.shape[0]
        if width % mesh.n:
            raise ValueError(f"a residual pair of {width} channels does not "
                             f"split over {mesh.n} tp ranks")
        self.conv_block = block.conv_block
        self.mesh = mesh
        self.whole = True
        self.cut()

    def split(self) -> List[Tuple[nn.Parameter, int]]:
        """The parameters this rank holds a slice of, with the dimension
        cut."""
        conv1, conv2 = self.conv_block[1], self.conv_block[5]
        return [(conv1.weight, _DIM[COLUMN]), (conv1.bias, _DIM[COLUMN]),
                (conv2.weight, _DIM[ROW])]

    @torch.no_grad()
    def cut(self) -> None:
        if self.whole:
            for p, dim in self.split():
                p.data = _cut(p.data, dim, self.mesh)
            self.whole = False

    @torch.no_grad()
    def join(self) -> None:
        if not self.whole:
            for p, dim in self.split():
                p.data = _join(p.data, dim, self.mesh)
            self.whole = True

    def forward(self, x):
        cb = self.conv_block
        if self.whole:
            return x + cb(x)
        group = self.mesh.group
        h = cb[3](cb[2](cb[1](cb[0](copy_to_tp(x, group)))))
        conv2 = cb[5]
        h = F.conv2d(_cast(cb[4](h), conv2.dtype).permute(0, 3, 1, 2),
                     _cast(conv2.weight, conv2.dtype), None,
                     stride=conv2.stride, padding=conv2.padding)
        h = reduce_from_tp(h.permute(0, 2, 3, 1), group)
        return x + cb[6](h + _cast(conv2.bias, conv2.dtype))


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def _tp_blocks(module: nn.Module) -> List[TpResidualBlock]:
    return [m for m in module.modules() if isinstance(m, TpResidualBlock)]


def shard_module_tp(module: nn.Module, mesh: TpMesh) -> nn.Module:
    """Replace each ``ResidualBlock`` and ``RegResnetBlock`` of ``module``
    by a :class:`TpResidualBlock` holding this rank's slices, in place (and
    return ``module``). A module without such blocks (D, ``Generator3D``)
    stays as it is."""
    todo = [(name, m) for name, m in module.named_modules()
            if isinstance(m, _BLOCKS)]
    for name, block in todo:
        parent, _, child = name.rpartition(".")
        owner = module.get_submodule(parent) if parent else module
        setattr(owner, child, TpResidualBlock(block, mesh))
    return module


def split_params(module: nn.Module) -> List[nn.Parameter]:
    """The parameters of ``module`` that this rank holds a slice of (none
    when its blocks are whole or not split)."""
    return [p for b in _tp_blocks(module) if not b.whole
            for p, _ in b.split()]


def mesh_of(module: nn.Module) -> Optional[TpMesh]:
    """The mesh ``module``'s blocks are split over, or None."""
    blocks = _tp_blocks(module)
    return blocks[0].mesh if blocks else None


# -- the state -----------------------------------------------------------------

def _nets(state) -> List[Tuple[Optional[torch.optim.Optimizer], nn.Module]]:
    """(its optimizer or None, net) for every net and EMA shadow."""
    out = [(getattr(state, opt), getattr(state, n))
           for opt, names in state.OPT_NETS.items() for n in names]
    return out + [(None, getattr(state, e)) for e in state.EMA_NETS
                  if getattr(state, e) is not None]


def _moments(opt, block: TpResidualBlock, fn) -> None:
    """Each per-parameter moment of ``block``'s split parameters in
    ``opt`` replaced by ``fn(moment, dim, mesh)``, in a new dict: a
    ``state_dict()`` taken before holds the old one."""
    for p, dim in block.split():
        if p in opt.state:
            opt.state[p] = {
                k: fn(v, dim, block.mesh)
                if torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in opt.state[p].items()}


def is_sharded(state) -> bool:
    """True when a net of the state holds slices."""
    return any(split_params(m) for _, m in _nets(state))


def shard_state_tp(state, mesh: TpMesh):
    """Split a train state in place (and return it): the residual pairs of
    every net and EMA shadow (G's by G's rule, the ResUNet's by its own; D
    and ``Generator3D`` have none), each optimizer's moments of the split
    parameters cut alike, and ``state.tp`` the mesh."""
    for opt, net in _nets(state):
        shard_module_tp(net, mesh)
        for b in _tp_blocks(net):
            if opt is not None:
                _moments(opt, b, _cut)
    state.tp = mesh
    return state


def _set_whole(state, whole: bool) -> None:
    for opt, net in _nets(state):
        for b in _tp_blocks(net):
            if b.whole == whole:
                continue
            if opt is not None:
                _moments(opt, b, _join if whole else _cut)
            b.join() if whole else b.cut()


@contextlib.contextmanager
def unsharded_state(state) -> Iterator[None]:
    """The state in the one-process layout for the block (every rank of a
    tp block gathers), cut again after it, from what the block left (loaded
    weights and moments); nothing happens to a state that is not split."""
    if not is_sharded(state):
        yield
        return
    _set_whole(state, True)
    try:
        yield
    finally:
        _set_whole(state, False)


@contextlib.contextmanager
def gathered(*modules: nn.Module) -> Iterator[None]:
    """The modules' split weights gathered for the block (an eval forward
    of the whole net), cut again after it."""
    todo = [b for m in modules for b in _tp_blocks(m) if not b.whole]
    for b in todo:
        b.join()
    try:
        yield
    finally:
        for b in todo:
            b.cut()


@torch.no_grad()
def infer_tensor_sharded(g: nn.Module, x: torch.Tensor, mesh: TpMesh,
                         data_parallel: bool = False) -> torch.Tensor:
    """The generator forward with its body split over ``mesh``'s tp block
    (a copy of ``g``, which every rank holds whole, is split): ``x``
    replicated, or with ``data_parallel`` each dp column's rows of it; the
    output whole on every rank."""
    sharded = shard_module_tp(copy.deepcopy(g), mesh)
    if data_parallel and mesh.dp > 1:
        n = x.shape[0] // mesh.dp
        x = x[mesh.column * n:(mesh.column + 1) * n]
    out = sharded(x)
    if data_parallel and mesh.dp > 1:
        out = dist.gather_rows(out, mesh.dp_group)
    return out
