"""FSDP (ZeRO-3) state sharding of the port (``ctagan_tpu/parallel/fsdp.py``).

Under ``mesh: {fsdp: N}`` (or the hybrid ``{dp: M, fsdp: N}``) every net's
parameters, their Adam moments and the EMA shadows live 1/N a rank, and the
training math stays the data-parallel step's. JAX gets this from GSPMD
placement alone: it shards each leaf on its trailing-most dimension that N
divides (``_spec_for``) and XLA inserts the gathers and reduce-scatters.
That per-leaf rule places arrays for a partitioner, which torch has no
counterpart of; the port keeps FSDP1's flat-parameter layout instead and
moves the bytes itself:

- **Layout.** Each net's parameters, in ``named_parameters()`` order, make
  one flat buffer, zero-padded to a multiple of N; a rank keeps its
  contiguous 1/N of it as the ``nn.Parameter`` its optimizer steps
  (:class:`FlatShard`). At rest the module's own parameters hold no
  storage; :func:`unshard` all-gathers them (views of one gathered buffer)
  for a step or an eval forward and :func:`reshard` releases them. Module
  code and state-dict keys stay as they are.
- **The step** (``train/steps.py``) gathers a net whole each time it reads
  it (again after its update, where it reads it again), reduce-scatters
  each net's flat gradient (mean over every rank: inside the fsdp block,
  then across the dp column), and steps Adam and the EMA on the shards.
- **The state.** :func:`shard_state_fsdp` shards the nets, the optimizers
  and the EMA shadows of a ``P2pState`` (P2p, P3d), ``RegState`` or
  ``CycState``; the ``torch.Generator`` and CycleGAN's replay pools stay
  whole on every rank (JAX replicates its rng key). :func:`unsharded_state`
  puts the state back in the one-process layout for a while (a checkpoint
  written or read, loaded weights), so every ``.pt`` holds the canonical
  state that any plan reads.

Left to GSPMD's schedule in JAX and not done here: re-gathering a layer at
a time in the backward, and overlapping the collectives with compute. The
placement differs, the results do not.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ctagan_tpu_torch.parallel import dist

_ATTR = "_fsdp_flat"  # a sharded module's FlatShard


@dataclass(frozen=True)
class FsdpMesh:
    """A rank's place in a ``dp`` × ``fsdp`` mesh: ``n`` ranks share each
    net (its fsdp block, ``group``), ``index`` is its place in the block,
    ``dp_group`` its dp column (None when dp is 1)."""

    n: int
    index: int
    group: object
    dp_group: Optional[object] = None


def make_fsdp_mesh(dp: int, fsdp: int) -> FsdpMesh:
    """This rank's mesh in the process group (``dist.mesh_groups``); every
    rank calls it, in the same order."""
    group, column = dist.mesh_groups(dp, fsdp)
    return FsdpMesh(fsdp, dist.rank() % fsdp, group, column)


class FlatShard:
    """One module's parameters as one flat buffer of ``padded`` elements, of
    which this rank keeps block ``mesh.index`` as ``shard``."""

    def __init__(self, module: nn.Module, mesh: FsdpMesh):
        self.params = list(module.parameters())
        kinds = {(p.dtype, p.device) for p in self.params}
        if len(kinds) != 1:
            raise ValueError(f"fsdp shards one dtype and device a net, got "
                             f"{sorted(map(str, kinds))}")
        self.mesh = mesh
        self.shapes = [p.shape for p in self.params]
        self.numels = [p.numel() for p in self.params]
        total = sum(self.numels)
        self.padded = -(-total // mesh.n) * mesh.n
        size = self.padded // mesh.n
        full = self.flatten([p.detach() for p in self.params])
        self.shard = nn.Parameter(
            full[mesh.index * size:(mesh.index + 1) * size].clone(),
            requires_grad=self.params[0].requires_grad)
        self.gathered = False
        self.release()

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-parameter tensors as one flat, zero-padded buffer."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return F.pad(flat, (0, self.padded - flat.numel()))

    def split(self, full: torch.Tensor) -> List[torch.Tensor]:
        """A flat buffer as per-parameter views."""
        parts = full.split(self.numels + [self.padded - sum(self.numels)])
        return [t.view(s) for t, s in zip(parts, self.shapes)]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's ``block`` of the fsdp group, as one flat buffer."""
        full = block.new_empty(self.padded)
        dist.all_gather_into(full, block.detach(), self.mesh.group)
        return full

    def unshard(self) -> None:
        if not self.gathered:
            with torch.no_grad():
                for p, t in zip(self.params, self.split(self.gather(
                        self.shard))):
                    p.data = t
            self.gathered = True

    def release(self) -> None:
        empty = self.shard.detach().new_empty(0)
        for p in self.params:
            p.data = empty
        self.gathered = False

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's block of the flat gradient, averaged over every
        rank."""
        return dist.reduce_scatter_mean(self.flatten(grads), self.mesh.group,
                                        self.mesh.dp_group)


def flat_of(module: nn.Module) -> Optional[FlatShard]:
    """The module's :class:`FlatShard`, or None when it is not sharded."""
    return getattr(module, _ATTR, None)


def local_params(module: nn.Module) -> List[nn.Parameter]:
    """The parameters this rank keeps and steps: the shard under fsdp,
    else the module's own."""
    flat = flat_of(module)
    return [flat.shard] if flat is not None else list(module.parameters())


def unshard(*modules: nn.Module) -> None:
    """Gather each sharded module's weights (a collective every rank of
    its block reaches); a gathered or unsharded one stays as it is."""
    for m in modules:
        if flat_of(m) is not None:
            flat_of(m).unshard()


def reshard(*modules: nn.Module) -> None:
    """Release each sharded module's gathered weights (after an update
    they are stale)."""
    for m in modules:
        if flat_of(m) is not None:
            flat_of(m).release()


@contextlib.contextmanager
def gathered(*modules: nn.Module) -> Iterator[None]:
    """The modules' weights gathered for the block, released after it
    (those this call gathered)."""
    todo = [m for m in modules
            if flat_of(m) is not None and not flat_of(m).gathered]
    unshard(*todo)
    try:
        yield
    finally:
        reshard(*todo)


def _moments(opt: torch.optim.Optimizer, param) -> dict:
    return opt.state.get(param, {})


def _rebuilt(opt: torch.optim.Optimizer, params) -> torch.optim.Optimizer:
    """An optimizer of ``opt``'s type and settings over ``params``."""
    settings = {k: v for k, v in opt.param_groups[0].items() if k != "params"}
    return type(opt)(params, **settings)


def _shard_opt(opt, flats):
    """``opt`` (over the flats' modules' parameters, in order) rebuilt over
    their shards, each per-parameter moment flattened and cut as the
    weights are; the step count is every parameter's."""
    new = _rebuilt(opt, [f.shard for f in flats])
    for f in flats:
        states = [_moments(opt, p) for p in f.params]
        if not states[0]:
            continue
        size, lo = f.padded // f.mesh.n, f.mesh.index * f.padded // f.mesh.n
        st = {}
        for key, v in states[0].items():
            if torch.is_tensor(v) and v.dim() > 0:
                flat = f.flatten([s[key] for s in states])
                st[key] = flat[lo:lo + size].clone()
            else:
                st[key] = v.clone() if torch.is_tensor(v) else v
        new.state[f.shard] = st
    return new


def _unshard_opt(opt, flats):
    """The inverse of :func:`_shard_opt`: ``opt`` over the modules' own
    (gathered) parameters with per-parameter moments."""
    params = [p for f in flats for p in f.params]
    new = _rebuilt(opt, params)
    for f in flats:
        st = _moments(opt, f.shard)
        for key, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                parts = f.split(f.gather(v))
            else:
                parts = [v] * len(f.params)
            for p, t in zip(f.params, parts):
                new.state.setdefault(p, {})[key] = (
                    t.clone() if torch.is_tensor(t) else t)
    return new


def _shard_module(module: nn.Module, mesh: FsdpMesh) -> FlatShard:
    flat = FlatShard(module, mesh)
    setattr(module, _ATTR, flat)
    return flat


def _unshard_module(module: nn.Module) -> None:
    """Gather the module's weights into storage of its own and drop its
    shard."""
    flat = flat_of(module)
    flat.unshard()
    with torch.no_grad():
        for p in flat.params:
            p.data = p.data.clone()
    delattr(module, _ATTR)


def _emas(state) -> List[nn.Module]:
    return [m for m in (getattr(state, name) for name in state.EMA_NETS)
            if m is not None]


def is_sharded(state) -> bool:
    """True when the state's nets are sharded."""
    first = next(iter(state.OPT_NETS.values()))[0]
    return flat_of(getattr(state, first)) is not None


def shard_state_fsdp(state, mesh: FsdpMesh):
    """Shard a train state in place (and return it): every net of its
    optimizers (``state.OPT_NETS``), the optimizers over the shards with
    their moments cut alike, and the EMA shadows (``state.EMA_NETS``).
    The generator and replay pools stay whole."""
    for name, nets in state.OPT_NETS.items():
        flats = [_shard_module(getattr(state, n), mesh) for n in nets]
        setattr(state, name, _shard_opt(getattr(state, name), flats))
    for ema in _emas(state):
        _shard_module(ema, mesh)
    return state


def unshard_state(state) -> FsdpMesh:
    """The inverse of :func:`shard_state_fsdp`, in place: the one-process
    layout, the state that a checkpoint holds. Returns the mesh it was
    sharded over."""
    mesh = None
    for name, nets in state.OPT_NETS.items():
        modules = [getattr(state, n) for n in nets]
        flats = [flat_of(m) for m in modules]
        mesh = flats[0].mesh
        new = _unshard_opt(getattr(state, name), flats)
        for m in modules:
            _unshard_module(m)
        setattr(state, name, new)
    for ema in _emas(state):
        _unshard_module(ema)
    return mesh


@contextlib.contextmanager
def unsharded_state(state) -> Iterator[None]:
    """The state in the one-process layout for the block (gathered by
    every rank), sharded again after it; nothing happens to a state that
    is not sharded."""
    if not is_sharded(state):
        yield
        return
    mesh = unshard_state(state)
    try:
        yield
    finally:
        shard_state_fsdp(state, mesh)


def state_bytes_per_rank(state) -> int:
    """The bytes of the resting state this rank holds (JAX's
    ``state_bytes_per_device``): the parameters it keeps (the shards under
    fsdp), its optimizers' moments and the EMA shadows. The step counts,
    the generator and the replay pools (whole on every rank) are left
    out."""
    total = 0
    for name, nets in state.OPT_NETS.items():
        opt = getattr(state, name)
        for n in nets:
            for p in local_params(getattr(state, n)):
                total += p.numel() * p.element_size()
                total += sum(v.numel() * v.element_size()
                             for v in _moments(opt, p).values()
                             if torch.is_tensor(v) and v.dim() > 0)
    for ema in _emas(state):
        total += sum(p.numel() * p.element_size() for p in local_params(ema))
    return total
