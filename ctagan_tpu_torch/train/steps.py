"""The train steps of the port (``ctagan_tpu/train/steps.py``), one per
trainer family, each on PyTorch modules updated in place.

:func:`reg_train_step` is RegGAN (``dual_window_mode=False``: G's input is
the augmented A, R registers to the augmented B, ``Adv_lamda`` and
``Corr_lamda``) and HD (``dual_window_mode=True``: A2 in, B2 the target, B1
the stage-2 mask source, ``Adv_lamda1`` and ``Corr_lamda1``): G and R take
one Adam step on the joint loss (flow smoothness + L1 correlation of the
warped fake + adversarial term, D frozen), then D takes one on its loss over
a fresh, no-grad G forward with the updated weights (``d_refwd``, the
reference's order) and the real target. Stage 1 and RegGAN score a scalar D
with LSGAN. ``stage2=True`` takes a multi-scale D (a list over scales of
feature lists) with the weighted ``GANLoss``, halves D's loss, adds the
window-masked ``SR_loss2`` on the B1 body mask, and with ``FM_lamda > 0``
feature matching against D's features of the real target.

:func:`p2p_train_step` is pix2pix: ``P2P_lamda``·L1 + ``Adv_lamda``·LSGAN
of a conditional D on [A, fake], then D on a fresh no-grad forward of the
updated G. :func:`p3d_train_step` is the 3-D family (P3d): the pix2pix
recipe on NDHWC depth windows, with paired random H/W flips for
augmentation, D's predictions unscaled and D updated at G's lr.
:func:`cyc_train_step` is CycleGAN: one Adam over both
generators (the reference's ``itertools.chain``), two LSGAN and two
``Cyc_lamda``·L1 cycle terms with both Ds frozen, then each D on the real
images and the pre-update fakes through its replay pool.

Adam(0.5, 0.999, eps 1e-8) with the learning rate set on the param groups
each step. Augmentation draws come from the state's ``torch.Generator``.

Knobs: ``grad_accum`` K > 1 splits the augmented batch into K equal
microbatches and averages their losses and gradients (the G and D phases
alike; D re-forwards G per microbatch). ``ema_decay`` keeps an EMA of G
whose decay ramps as min(decay, (1 + t)/(10 + t)), t the G optimizer's
count after the update. ``warp_max_disp`` > 0 warps with the flow clipped
to [−R, R] (``ops/warp.py::warp2d_local``); ``reg_downsample`` > 1 runs R at
1/ds resolution and upsamples its flow, times ds; ``r1_gamma`` > 0 adds the
R1 penalty 0.5·γ·E‖∇ₓ D(real)‖² to D's loss (and returns it as
``R1_loss``). ``pipeline_1f1b`` is not ported yet and raises.

Data parallelism (``parallel/mesh.py``): in a process group each rank's
batch is its rows of the global batch. JAX's losses are global-batch means
and XLA derives the gradient all-reduce; here every gradient is
mean-reduced over the ranks where :func:`_value_and_grad` returns it, with
the loss and its terms, so the logged losses are global-batch means too.
The augmentation draws the global batch's parameters from the state's
generator, which every rank keeps alike, and takes the rank's rows;
CycleGAN's replay pools take the global fakes, so each rank holds the one
pool of one process. Without a group every step is as on one process.

The fsdp plan (``parallel/fsdp.py``): with the state sharded, a step
gathers each net it reads (:func:`fsdp.unshard`), and again after that
net's update where it reads it again (D's fresh forward of the updated G;
:func:`_apply` releases an updated net), reduce-scatters each net's
gradient into its shard in :func:`_value_and_grad`, and steps Adam and the
EMA on the shards; every net is released by the step's end.

The tp plan (``parallel/tensor.py``): the split residual pairs run on the
layer route (``Generator.forward``'s gate), a split parameter's gradient is
mean-reduced over the rank's dp column alone and every other over every
rank (:func:`_value_and_grad`); the tp ranks of a dp column read its rows
and draw its augmentation (:func:`_batch_ranks`), as JAX replicates its
rng key over the model axis.

The sp plan (``parallel/spatial.py``; P2p, CycleGAN, RegGAN and HD): the
ranks of an sp block read their dp column's rows, warp the whole images
with the column's draws (a rotation mixes rows) and keep their strips
(:func:`_augment`); the step runs under the layers' sp context, on the
layer route, and each rank's losses and parameter gradients are its
rows' part: :func:`_value_and_grad` sums them over the block and averages
them over the dp column, so the replicated state stays alike everywhere.
R's resizes, the warp and the flow smoothness read across the strips'
seams through the context (``ops/resize.py``, ``ops/warp.py``); the R1
penalty's score is pooled over the whole image (:func:`_r1_score`); the
CycleGAN pools hold the whole fakes of one process (:func:`_pool`).

The depth plan (``parallel/volume.py``; P3d, under ``{depth: N}`` and,
as JAX's sp placement splits a volume's axis 1, under ``{sp: N}``): the
ranks of a block flip their dp column's volumes alike and keep their
slabs of D; the step runs under the 3-D layers' depth context, and
:func:`_value_and_grad` sums each rank's part over the block and averages
it over the dp column, as under sp.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import (Callable, ClassVar, Dict, List, Optional, Sequence,
                    Tuple)

import torch

from ctagan_tpu_torch.models.layers import global_avg_pool_logit
from ctagan_tpu_torch.ops.augment import affine_warp, sample_affine_params
from ctagan_tpu_torch.ops.losses import (
    feature_matching_loss,
    gan_loss_multiscale,
    l1,
    masked_correlation_loss,
    mse,
)
from ctagan_tpu_torch.ops.resize import interpolate_bilinear
from ctagan_tpu_torch.ops.warp import smoothing_loss, warp2d, warp2d_local
from ctagan_tpu_torch.parallel import dist, fsdp, spatial, tensor, volume
from ctagan_tpu_torch.parallel.mesh import shard_rows
from ctagan_tpu_torch.train.replay_buffer import ReplayBuffer, push_and_pop


def make_optimizer(params: Sequence[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam(b1=0.5, b2=0.999, eps=1e-8); the step sets the lr each call."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.999), eps=1e-8)


def _apply(opt: torch.optim.Adam, nets: Sequence[torch.nn.Module],
           grads: Sequence[Sequence[torch.Tensor]], lr: float) -> None:
    """One step of ``opt`` over the nets' parameters (their shards under
    fsdp) with ``grads`` by net (:func:`_value_and_grad`); a sharded net's
    gathered weights are stale after it, and are released."""
    for group in opt.param_groups:
        group["lr"] = float(lr)
    params = [p for net in nets for p in fsdp.local_params(net)]
    for p, g in zip(params, [g for gs in grads for g in gs]):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)
    fsdp.reshard(*nets)


def _count(opt: torch.optim.Adam) -> int:
    """The optimizer's step count (every param steps together)."""
    first = opt.param_groups[0]["params"][0]
    return int(opt.state[first]["step"]) if first in opt.state else 0


def make_ema(model: torch.nn.Module) -> torch.nn.Module:
    """The EMA shadow of ``model``: a frozen copy of its current weights."""
    return copy.deepcopy(model).requires_grad_(False)


def ema_decay_at(decay: float, count: int) -> Tuple[float, float]:
    """(d, 1 − d) with d = min(decay, (1 + t)/(10 + t)), t = ``count``, in
    f32 arithmetic as JAX's ``_ema_update`` computes them."""
    t = torch.tensor(float(count), dtype=torch.float32)
    d = torch.minimum(torch.tensor(decay, dtype=torch.float32),
                      (1.0 + t) / (10.0 + t))
    return float(d), float(1.0 - d)


@torch.no_grad()
def _ema_update(ema: Optional[torch.nn.Module], model: torch.nn.Module,
                decay: float, count: int) -> None:
    """ema ← ema·d + params·(1 − d), the decay ramped by the G optimizer's
    post-update ``count`` (:func:`ema_decay_at`); under fsdp on the
    shards."""
    if ema is None:
        return
    d, one_minus = ema_decay_at(decay, count)
    shadow = fsdp.local_params(ema)
    torch._foreach_mul_(shadow, d)
    torch._foreach_add_(shadow, torch._foreach_mul(
        [p.detach() for p in fsdp.local_params(model)], one_minus))


LossFn = Callable[[Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _value_and_grad(loss_fn: LossFn, nets: Sequence[torch.nn.Module],
                    batches: Dict[str, torch.Tensor], n: int = 1,
                    sp: Optional[spatial.SpMesh] = None):
    """(loss, aux, grads) of ``loss_fn(mb) -> (loss, aux)`` by the
    parameters of ``nets``: with ``n`` > 1 the means over ``n`` equal
    microbatches of the batch's leading axis (summed in microbatch order,
    then scaled by 1/n, as JAX's ``_grad_accum_scan``), holding one
    microbatch's graph at a time. ``grads`` by net, each what its optimizer
    steps (:func:`_apply`). In a process group all three are then
    mean-reduced over the ranks, outside autograd: in one collective per
    dtype, or under fsdp the losses so and each net's gradients by a
    reduce-scatter into its shard; under tp the gradients of split
    parameters over the rank's dp column alone (they differ between the
    ranks of a tp block); under ``sp`` (the rank's sp mesh, or P3d's
    depth mesh) all three, each the part of this rank's rows, are summed
    over the sp block, then averaged over the dp column."""
    per_net = [list(net.parameters()) for net in nets]
    params = [p for ps in per_net for p in ps]
    lead = next(iter(batches.values())).shape[0]
    assert lead % n == 0, f"grad_accum={n} must divide the batch ({lead})"
    m = lead // n
    loss = aux = grads = None
    for i in range(n):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batches.items()}
        l_i, a_i = loss_fn(mb)
        g_i = torch.autograd.grad(l_i, params)
        a_i = {k: v.detach() for k, v in a_i.items()}
        if loss is None:
            loss, aux, grads = l_i.detach(), a_i, list(g_i)
        else:
            loss = loss + l_i.detach()
            aux = {k: aux[k] + a_i[k] for k in aux}
            grads = [g + h for g, h in zip(grads, g_i)]
    if n > 1:
        inv = 1.0 / n
        loss = loss * inv
        aux = {k: v * inv for k, v in aux.items()}
        grads = [g * inv for g in grads]
    by_net, i = [], 0
    for ps in per_net:
        by_net.append(grads[i:i + len(ps)])
        i += len(ps)
    if sp is not None:
        parts = [loss, *aux.values(), *grads]
        dist.all_reduce_mean_(parts, sp.group, mean=False)
        if sp.dp > 1:
            dist.all_reduce_mean_(parts, sp.dp_group)
        return loss, aux, by_net
    if fsdp.flat_of(nets[0]) is not None:
        dist.all_reduce_mean_([loss, *aux.values()])
        return loss, aux, [[fsdp.flat_of(net).reduce_grads(g)]
                           for net, g in zip(nets, by_net)]
    split = {p for net in nets for p in tensor.split_params(net)}
    dist.all_reduce_mean_([loss, *aux.values(), *(
        g for p, g in zip(params, grads) if p not in split)])
    mesh = next(filter(None, map(tensor.mesh_of, nets)), None)
    if split and mesh.dp > 1:
        dist.all_reduce_mean_([g for p, g in zip(params, grads)
                               if p in split], mesh.dp_group)
    return loss, aux, by_net


def _batch_ranks(state) -> Tuple[int, int, Optional[object]]:
    """(this rank's place, their count, their group) among the ranks that
    split the global batch: every rank (the default group), or under tp
    and sp the rank's dp column; the tp and sp ranks of a column read its
    rows."""
    mesh = state.tp or getattr(state, "sp", None)
    if mesh is None:
        return dist.rank(), dist.world(), None
    return mesh.column, mesh.dp, mesh.dp_group


def _rank_rows(state, n: int) -> slice:
    """This rank's rows of the global batch of every such rank's ``n``
    rows (:func:`_batch_ranks`)."""
    index, count, _ = _batch_ranks(state)
    return shard_rows(n * count, index, count)


def _global_rows(state, x: torch.Tensor) -> torch.Tensor:
    """The global batch whose rows of this rank are ``x``."""
    _, count, group = _batch_ranks(state)
    return x if count == 1 else dist.gather_rows(x, group)


def _augment(state, cfg, a: torch.Tensor, b: torch.Tensor):
    """A and B through independent affine draws (one shared draw with
    ``aligned_aug``): the global batch's draws, this rank's rows of them;
    under sp the whole images warped, then this rank's strips of them."""
    n, h, w, _ = a.shape
    noise, rows = cfg["noise_level"], _rank_rows(state, n)
    count = n * _batch_ranks(state)[1]  # the global batch's rows

    def draw():
        return tuple(p[rows] for p in sample_affine_params(
            state.gen, count, noise, h, w))

    params_a = draw()
    params_b = params_a if cfg.get("aligned_aug", False) else draw()
    a, b = affine_warp(a, *params_a), affine_warp(b, *params_b)
    sp = getattr(state, "sp", None)
    if sp is not None:
        a, b = spatial.strip(a, sp), spatial.strip(b, sp)
    return a, b


# ===========================================================================
# pix2pix
# ===========================================================================

@dataclass
class P2pState:
    g_model: torch.nn.Module
    d_model: torch.nn.Module
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    gen: torch.Generator  # augmentation draws
    g_ema: Optional[torch.nn.Module] = None
    tp: Optional[tensor.TpMesh] = None  # set by tensor.shard_state_tp
    sp: Optional[spatial.SpMesh] = None  # set by spatial.shard_state_sp
    # P3d's, set by volume.shard_p3d_state_depth
    depth: Optional[spatial.SpMesh] = None
    # each optimizer's nets, in its parameter order, and the EMA shadows
    OPT_NETS: ClassVar = {"g_opt": ("g_model",), "d_opt": ("d_model",)}
    EMA_NETS: ClassVar = ("g_ema",)


def init_p2p_state(g_model, d_model, seed: int = 0,
                   ema: bool = False) -> P2pState:
    return P2pState(
        g_model, d_model, make_optimizer(list(g_model.parameters())),
        make_optimizer(list(d_model.parameters())),
        torch.Generator().manual_seed(seed),
        make_ema(g_model) if ema else None)


def p2p_train_step(state: P2pState, cfg: Dict,
                   batch: Dict[str, torch.Tensor], lr: float
                   ) -> Dict[str, torch.Tensor]:
    """One pix2pix step on ``batch`` {A, B} (NHWC, [−1, 1]; A may hold
    ``context_slices`` channels). D is conditional on [A, ·]; its
    predictions are scaled by ``Adv_lamda`` before the MSE, as the
    reference does. Under sp (``state.sp``) on this rank's strips."""
    with spatial.training_scope(state.sp):
        return _p2p_step(state, cfg, batch, lr)


def _p2p_step(state: P2pState, cfg: Dict, batch: Dict[str, torch.Tensor],
              lr: float) -> Dict[str, torch.Tensor]:
    g_model, d_model = state.g_model, state.d_model
    a, b = _augment(state, cfg, batch["A"], batch["B"])
    n_accum = int(cfg.get("grad_accum", 1))
    adv_w, l1_w = cfg["Adv_lamda"], cfg["P2P_lamda"]

    def g_loss(mb):
        fake = g_model(mb["a"])
        loss_l1 = l1(fake, mb["b"]) * l1_w
        pred = d_model(torch.cat([mb["a"], fake], dim=-1))
        loss_adv = mse(pred, 1.0) * adv_w
        return loss_l1 + loss_adv, {"loss_L1": loss_l1,
                                    "loss_GAN_A2B": loss_adv}

    ab = {"a": a, "b": b}
    fsdp.unshard(g_model, d_model)
    g_loss_v, g_aux, g_grads = _value_and_grad(g_loss, [g_model], ab,
                                               n_accum, state.sp)
    _apply(state.g_opt, [g_model], g_grads, lr)

    def d_loss(mb):
        with torch.no_grad():
            fake2 = g_model(mb["a"])
        pf = d_model(torch.cat([mb["a"], fake2], dim=-1)) * adv_w
        pr = d_model(torch.cat([mb["a"], mb["b"]], dim=-1)) * adv_w
        return mse(pf, 0.0) + mse(pr, 1.0), {}

    fsdp.unshard(g_model)  # the updated G
    d_loss_v, _, d_grads = _value_and_grad(d_loss, [d_model], ab, n_accum,
                                           state.sp)
    _apply(state.d_opt, [d_model], d_grads, lr)
    fsdp.reshard(g_model)
    _ema_update(state.g_ema, g_model, cfg.get("ema_decay", 0.999),
                _count(state.g_opt))
    return {"loss_G": g_loss_v, **g_aux, "loss_D_B": d_loss_v}


# ===========================================================================
# 3-D volumetric pix2pix (P3d)
# ===========================================================================

def init_p3d_state(g_model, d_model, seed: int = 0,
                   ema: bool = False) -> P2pState:
    """A ``P2pState`` over the 3-D nets: their Adams, the flip generator
    seeded from ``seed`` and with ``ema`` G's EMA."""
    return init_p2p_state(g_model, d_model, seed, ema=ema)


def p3d_flips(gen: torch.Generator) -> Tuple[bool, bool]:
    """The step's (flip H, flip W) draws, each with probability 0.5."""
    fh, fw = torch.randint(0, 2, (2,), generator=gen).tolist()
    return bool(fh), bool(fw)


def p3d_train_step(state: P2pState, cfg: Dict,
                   batch: Dict[str, torch.Tensor], lr: float,
                   flips: Optional[Tuple[bool, bool]] = None
                   ) -> Dict[str, torch.Tensor]:
    """One P3d step on ``batch`` {A, B} ((N, D, H, W, 1), [−1, 1]): A and B
    flipped together along H and W by ``flips`` (default: drawn from the
    state's generator; JAX draws them from its key), then G on
    ``P2P_lamda``·L1 + ``Adv_lamda``·LSGAN of the conditional D on [A,
    fake], then D on ``mse(D[A, G'(A)], 0) + mse(D[A, B], 1)`` (neither
    scaled nor halved) with G' the updated G, re-forwarded without grad;
    both at ``lr``. ``grad_accum`` K > 1 averages over K microbatches, as
    JAX's ``_grad_accum_scan``. Under the depth plan (``state.depth``) on
    this rank's slabs of the flipped volumes."""
    with volume.training_scope(state.depth):
        return _p3d_step(state, cfg, batch, lr, flips)


def _p3d_step(state: P2pState, cfg: Dict, batch: Dict[str, torch.Tensor],
              lr: float, flips: Optional[Tuple[bool, bool]]
              ) -> Dict[str, torch.Tensor]:
    g_model, d_model = state.g_model, state.d_model
    fh, fw = p3d_flips(state.gen) if flips is None else flips
    a, b = batch["A"], batch["B"]
    dims = [d for d, f in ((2, fh), (3, fw)) if f]
    if dims:
        a, b = torch.flip(a, dims), torch.flip(b, dims)
    if state.depth is not None:
        ab = volume.shard_batch_depth({"A": a, "B": b}, state.depth)
        a, b = ab["A"], ab["B"]
    n_accum = int(cfg.get("grad_accum", 1))
    adv_w, l1_w = cfg["Adv_lamda"], cfg["P2P_lamda"]

    def g_loss(mb):
        fake = g_model(mb["a"])
        loss_l1 = l1(fake, mb["b"]) * l1_w
        pred = d_model(torch.cat([mb["a"], fake.to(mb["a"].dtype)], dim=-1))
        loss_adv = mse(pred, 1.0) * adv_w
        return loss_l1 + loss_adv, {"loss_L1": loss_l1,
                                    "loss_GAN_A2B": loss_adv}

    ab = {"a": a, "b": b}
    fsdp.unshard(g_model, d_model)
    g_loss_v, g_aux, g_grads = _value_and_grad(g_loss, [g_model], ab,
                                               n_accum, state.depth)
    _apply(state.g_opt, [g_model], g_grads, lr)

    def d_loss(mb):
        with torch.no_grad():
            fake2 = g_model(mb["a"]).to(mb["a"].dtype)
        pf = d_model(torch.cat([mb["a"], fake2], dim=-1))
        pr = d_model(torch.cat([mb["a"], mb["b"]], dim=-1))
        return mse(pf, 0.0) + mse(pr, 1.0), {}

    fsdp.unshard(g_model)  # the updated G
    d_loss_v, _, d_grads = _value_and_grad(d_loss, [d_model], ab, n_accum,
                                           state.depth)
    _apply(state.d_opt, [d_model], d_grads, lr)
    fsdp.reshard(g_model)
    _ema_update(state.g_ema, g_model, cfg.get("ema_decay", 0.999),
                _count(state.g_opt))
    return {"loss_G": g_loss_v, **g_aux, "loss_D_B": d_loss_v}


# ===========================================================================
# CycleGAN
# ===========================================================================

@dataclass
class CycState:
    g_a2b: torch.nn.Module
    g_b2a: torch.nn.Module
    d_a: torch.nn.Module
    d_b: torch.nn.Module
    g_opt: torch.optim.Adam  # over both generators
    d_a_opt: torch.optim.Adam
    d_b_opt: torch.optim.Adam
    fake_a_buffer: ReplayBuffer
    fake_b_buffer: ReplayBuffer
    gen: torch.Generator  # augmentation and replay-pool draws
    g_ema: Optional[torch.nn.Module] = None  # of G_A2B, the eval model
    g_ema_b2a: Optional[torch.nn.Module] = None
    tp: Optional[tensor.TpMesh] = None
    sp: Optional[spatial.SpMesh] = None  # set by spatial.shard_state_sp
    OPT_NETS: ClassVar = {"g_opt": ("g_a2b", "g_b2a"), "d_a_opt": ("d_a",),
                          "d_b_opt": ("d_b",)}
    EMA_NETS: ClassVar = ("g_ema", "g_ema_b2a")


def init_cyc_state(g_a2b, g_b2a, d_a, d_b, size: int, input_nc: int = 1,
                   seed: int = 0, buffer_size: int = 50,
                   ema: bool = False) -> CycState:
    first = next(g_a2b.parameters())
    pool = dict(dtype=first.dtype, device=first.device)
    return CycState(
        g_a2b, g_b2a, d_a, d_b,
        make_optimizer(list(g_a2b.parameters()) + list(g_b2a.parameters())),
        make_optimizer(list(d_a.parameters())),
        make_optimizer(list(d_b.parameters())),
        ReplayBuffer.create(buffer_size, (size, size, input_nc), **pool),
        ReplayBuffer.create(buffer_size, (size, size, input_nc), **pool),
        torch.Generator().manual_seed(seed),
        make_ema(g_a2b) if ema else None,
        make_ema(g_b2a) if ema else None)


def _pool(state, buf: ReplayBuffer, fake: torch.Tensor) -> torch.Tensor:
    """D's fakes through the history pool ``buf``: the global batch's
    whole fakes (under sp the block's strips gathered, then the dp
    column's rows) offered to the one pool of one process, with the draws
    every rank makes alike from ``state.gen``; this rank's rows, and
    strip, of what it passes on."""
    sp = state.sp
    if sp is not None and sp.n > 1:
        fake = dist.gather_whole(fake, sp.group)
    out = push_and_pop(buf, _global_rows(state, fake), state.gen)[
        _rank_rows(state, fake.shape[0])]
    return out if sp is None else spatial.strip(out, sp)


def cyc_train_step(state: CycState, cfg: Dict,
                   batch: Dict[str, torch.Tensor], lr: float
                   ) -> Dict[str, torch.Tensor]:
    """One CycleGAN step on ``batch`` {A, B}. Under ``grad_accum`` the
    pools' fakes come from one extra no-grad forward of both generators
    over the whole batch at the pre-update weights. Under sp
    (``state.sp``) on this rank's strips."""
    with spatial.training_scope(state.sp):
        return _cyc_step(state, cfg, batch, lr)


def _cyc_step(state: CycState, cfg: Dict, batch: Dict[str, torch.Tensor],
              lr: float) -> Dict[str, torch.Tensor]:
    ga, gb, da, db = state.g_a2b, state.g_b2a, state.d_a, state.d_b
    real_a, real_b = _augment(state, cfg, batch["A"], batch["B"])
    adv_w, cyc_w = cfg["Adv_lamda"], cfg["Cyc_lamda"]
    n_accum = int(cfg.get("grad_accum", 1))
    fakes: Dict[str, torch.Tensor] = {}

    def g_loss(mb):
        fake_b = ga(mb["a"])
        loss_gan_a2b = adv_w * mse(db(fake_b), 1.0)
        fake_a = gb(mb["b"])
        loss_gan_b2a = adv_w * mse(da(fake_a), 1.0)
        loss_cyc_aba = cyc_w * l1(gb(fake_b), mb["a"])
        loss_cyc_bab = cyc_w * l1(ga(fake_a), mb["b"])
        if n_accum == 1:
            fakes.update(a=fake_a.detach(), b=fake_b.detach())
        total = loss_gan_a2b + loss_gan_b2a + loss_cyc_aba + loss_cyc_bab
        return total, {"loss_GAN_A2B": loss_gan_a2b,
                       "loss_cycle_ABA": loss_cyc_aba}

    # the Ds' steps read neither G again
    fsdp.unshard(ga, gb, da, db)
    g_loss_v, g_aux, g_grads = _value_and_grad(
        g_loss, [ga, gb], {"a": real_a, "b": real_b}, n_accum, state.sp)
    if n_accum > 1:
        with torch.no_grad():
            fakes.update(b=ga(real_a), a=gb(real_b))
    _apply(state.g_opt, [ga, gb], g_grads, lr)

    # the Ds train on the pre-update fakes, through the history pools
    fake_a_d = _pool(state, state.fake_a_buffer, fakes["a"])
    fake_b_d = _pool(state, state.fake_b_buffer, fakes["b"])

    def d_update(d_model, opt, real, fake):
        def d_loss(mb):
            loss_real = adv_w * mse(d_model(mb["real"]), 1.0)
            loss_fake = adv_w * mse(d_model(mb["fake"]), 0.0)
            return loss_real + loss_fake, {}

        loss, _, grads = _value_and_grad(
            d_loss, [d_model], {"real": real, "fake": fake}, n_accum,
            state.sp)
        _apply(opt, [d_model], grads, lr)
        return loss

    d_a_loss = d_update(da, state.d_a_opt, real_a, fake_a_d)
    d_b_loss = d_update(db, state.d_b_opt, real_b, fake_b_d)
    decay, count = cfg.get("ema_decay", 0.999), _count(state.g_opt)
    _ema_update(state.g_ema, ga, decay, count)
    _ema_update(state.g_ema_b2a, gb, decay, count)
    return {"loss_G": g_loss_v, **g_aux, "loss_D_A": d_a_loss,
            "loss_D_B": d_b_loss}


# ===========================================================================
# RegGAN and HD stage 1 / stage 2
# ===========================================================================

@dataclass
class RegState:
    g_model: torch.nn.Module
    r_model: torch.nn.Module
    d_model: torch.nn.Module
    g_opt: torch.optim.Adam
    r_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    gen: torch.Generator  # augmentation draws
    g_ema: Optional[torch.nn.Module] = None
    tp: Optional[tensor.TpMesh] = None
    sp: Optional[spatial.SpMesh] = None  # set by spatial.shard_state_sp
    OPT_NETS: ClassVar = {"g_opt": ("g_model",), "r_opt": ("r_model",),
                          "d_opt": ("d_model",)}
    EMA_NETS: ClassVar = ("g_ema",)


def init_reg_state(g_model, r_model, d_model, seed: int = 0,
                   ema: bool = False) -> RegState:
    """Optimizers for the three nets (their weights as they are), the
    augmentation generator seeded from ``seed`` and with ``ema`` G's EMA."""
    return RegState(
        g_model, r_model, d_model,
        make_optimizer(list(g_model.parameters())),
        make_optimizer(list(r_model.parameters())),
        make_optimizer(list(d_model.parameters())),
        torch.Generator().manual_seed(seed),
        make_ema(g_model) if ema else None,
    )

def _predict_flow(r_model, moving, fixed, ds: int) -> torch.Tensor:
    """R's flow; with ``ds`` > 1 at (h // ds, w // ds), bilinearly upsampled
    and its displacements scaled by ds."""
    if ds <= 1:
        return r_model(moving, fixed)
    h, w = moving.shape[1], moving.shape[2]
    small = (h // ds, w // ds)
    flow = r_model(interpolate_bilinear(moving, small),
                   interpolate_bilinear(fixed, small))
    return interpolate_bilinear(flow, (h, w)) * float(ds)


def _r1_score(out, stage2: bool,
              sp: Optional[spatial.SpMesh] = None) -> torch.Tensor:
    """Σ over the batch of D's f32 score: the mean of each scale's last map,
    summed over scales (stage 2), or the mean logit. Under sp this rank's
    part of it: each map pooled over the whole image (every rank holds the
    score), over the block's size, so that the parts' gradients sum to the
    score's."""
    if sp is None:
        maps = [feats[-1] for feats in out] if stage2 else [out]
        return sum(m.float().mean(dim=tuple(range(1, m.dim())))
                   for m in maps).sum()
    maps = ([global_avg_pool_logit(feats[-1].float()) for feats in out]
            if stage2 else [out.float()])
    return sum(m.mean(dim=1) for m in maps).sum() / sp.n


def reg_train_step(state: RegState, cfg: Dict, batch: Dict[str, torch.Tensor],
                   lr: float, lr_d: Optional[float] = None,
                   dual_window_mode: bool = False, stage2: bool = False,
                   pipeline_1f1b=None) -> Dict[str, torch.Tensor]:
    """One RegGAN step on ``batch`` {A, B}, or with ``dual_window_mode`` one
    HD step on {A1, A2, B1, B2} (NHWC, [−1, 1]): stage 1, or stage 2 with
    ``stage2``. Updates the state's nets and optimizers in place; returns
    the detached losses under the JAX step's keys and in its order
    (``toal_loss`` as spelled there). Under sp (``state.sp``) on this
    rank's strips."""
    if pipeline_1f1b is not None:
        raise NotImplementedError(
            "reg_train_step: pipeline_1f1b is not ported yet (ROADMAP M12e)")
    with spatial.training_scope(state.sp):
        return _reg_step(state, cfg, batch, lr, lr_d, dual_window_mode,
                         stage2)


def _reg_step(state: RegState, cfg: Dict, batch: Dict[str, torch.Tensor],
              lr: float, lr_d: Optional[float], dual_window_mode: bool,
              stage2: bool) -> Dict[str, torch.Tensor]:
    g_model, r_model, d_model = state.g_model, state.r_model, state.d_model
    if dual_window_mode:
        # B2 and B1 warp as channels of one gather with the same parameters
        b2 = batch["B2"]
        real_a, warped_b = _augment(state, cfg, batch["A2"],
                                    torch.cat([b2, batch["B1"]], dim=-1))
        c2 = b2.shape[-1]
        real_b, real_b1 = warped_b[..., :c2], warped_b[..., c2:]
        adv_w, corr_w = cfg["Adv_lamda1"], cfg["Corr_lamda1"]
    else:
        real_a, real_b = _augment(state, cfg, batch["A"], batch["B"])
        real_b1 = None
        adv_w, corr_w = cfg["Adv_lamda"], cfg["Corr_lamda"]
    smooth_w = cfg["Smooth_lamda"]
    warp_r = int(cfg.get("warp_max_disp", 0))
    reg_ds = int(cfg.get("reg_downsample", 1))
    r1_w = float(cfg.get("r1_gamma", 0.0))
    n_accum = int(cfg.get("grad_accum", 1))
    if lr_d is None:
        lr_d = lr

    fakes: List[torch.Tensor] = []

    def gr_loss(mb):
        rb = mb["b"]
        fake_b = g_model(mb["a"])
        if n_accum == 1:
            fakes.append(fake_b.detach())
        flow = _predict_flow(r_model, fake_b, rb, reg_ds)
        warped = (warp2d_local(fake_b, flow, warp_r) if warp_r > 0
                  else warp2d(fake_b, flow))
        sm = smooth_w * smoothing_loss(flow)
        sr = corr_w * l1(warped, rb)
        d_out = d_model(fake_b)
        if stage2:
            adv = adv_w * gan_loss_multiscale(d_out, True)
        else:
            adv = adv_w * mse(d_out, 1.0)
        total = sm + adv + sr
        aux = {"SM_loss": sm, "SR_loss": sr, "adv_loss": adv}
        if stage2 and cfg.get("FM_lamda", 0.0) > 0.0:
            fm = cfg["FM_lamda"] * feature_matching_loss(
                d_out, d_model(rb), num_d=len(d_out))
            total = total + fm
            aux["FM_loss"] = fm
        if stage2:
            sr2 = cfg["Corr_lamda2"] * masked_correlation_loss(warped, rb,
                                                               mb["b1"])
            total = total + sr2
            aux["SR_loss2"] = sr2
        return total, aux

    mbs = {"a": real_a, "b": real_b}
    if real_b1 is not None:
        mbs["b1"] = real_b1
    fsdp.unshard(g_model, r_model, d_model)
    total, aux, grads = _value_and_grad(gr_loss, [g_model, r_model], mbs,
                                        n_accum, state.sp)
    _apply(state.g_opt, [g_model], grads[:1], lr)
    _apply(state.r_opt, [r_model], grads[1:], lr)

    def d_loss(mb):
        if "fake2" in mb:
            fake2 = mb["fake2"]
        else:
            with torch.no_grad():
                fake2 = g_model(mb["a"])
        # the R1 penalty differentiates D's score of the real target by its
        # input
        real_d = mb["b"].detach().requires_grad_(r1_w > 0.0)
        pf, pr = d_model(fake2), d_model(real_d)
        if stage2:
            loss = adv_w * (gan_loss_multiscale(pf, False)
                            + gan_loss_multiscale(pr, True)) / 2.0
        else:
            loss = adv_w * mse(pf, 0.0) + adv_w * mse(pr, 1.0)
        if r1_w <= 0.0:
            return loss, {}
        (gx,) = torch.autograd.grad(_r1_score(pr, stage2, state.sp),
                                    real_d, create_graph=True)
        gx = gx.float()
        r1 = 0.5 * r1_w * (gx * gx).sum(dim=tuple(range(1, gx.dim()))).mean()
        return loss + r1.to(loss.dtype), {"R1_loss": r1}

    # d_refwd off reuses the G phase's fake (one step stale); under
    # grad_accum D re-forwards per microbatch either way, as in JAX
    d_batch = {"a": real_a, "b": real_b}
    if not cfg.get("d_refwd", True) and fakes:
        d_batch["fake2"] = fakes[0]
    else:
        fsdp.unshard(g_model)  # D's fresh forward of the updated G
    d_loss_v, d_aux, d_grads = _value_and_grad(d_loss, [d_model], d_batch,
                                               n_accum, state.sp)
    _apply(state.d_opt, [d_model], d_grads, lr_d)
    fsdp.reshard(g_model)
    _ema_update(state.g_ema, g_model, cfg.get("ema_decay", 0.999),
                _count(state.g_opt))
    out = {"toal_loss": total, "loss_D_B": d_loss_v, **d_aux}
    out.update(aux)
    return out
