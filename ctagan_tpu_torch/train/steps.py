"""The HD train step of the port (``ctagan_tpu/train/steps.py``).

:func:`reg_train_step` with ``dual_window_mode=True`` is the JAX step of the
same name on PyTorch modules: G and R take one Adam step on the joint loss
(flow smoothness + L1 correlation of the warped fake + adversarial term, D
frozen), then D takes one on its loss over a fresh, no-grad G forward with
the updated weights (``d_refwd``, the reference's order) and the real
target. Adam(0.5, 0.999, eps 1e-8) with the learning rate set on the param
groups each step, a separate ``lr_d`` for D. Augmentation draws come from
the state's ``torch.Generator``.

Stage 1 scores a scalar D with LSGAN. ``stage2=True`` takes a multi-scale D
(a list over scales of feature lists) with the weighted ``GANLoss``, halves
D's loss, adds the window-masked ``SR_loss2`` on the B1 body mask, and with
``FM_lamda > 0`` feature matching against D's features of the real target.
Both stages weight their adversarial terms with ``Adv_lamda1``, as JAX does.

Knobs: ``warp_max_disp`` > 0 warps with the flow clipped to [−R, R]
(``ops/warp.py::warp2d_local``); ``reg_downsample`` > 1 runs R at 1/ds
resolution and upsamples its flow, times ds; ``r1_gamma`` > 0 adds the R1
penalty 0.5·γ·E‖∇ₓ D(real)‖² to D's loss (and returns it as ``R1_loss``).
The knobs not ported yet raise ``NotImplementedError`` naming their ROADMAP
item instead of being ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

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

# knob -> (value that the port runs, the ROADMAP item that ports the rest)
_UNPORTED = {
    "grad_accum": (1, "M8 (grad_accum)"),
    "ema_decay": (0.0, "M5 (ema_decay)"),
}


def make_optimizer(params: Sequence[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam(b1=0.5, b2=0.999, eps=1e-8); the step sets the lr each call."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.999), eps=1e-8)


def _apply(opt: torch.optim.Adam, params, grads, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


@dataclass
class RegState:
    g_model: torch.nn.Module
    r_model: torch.nn.Module
    d_model: torch.nn.Module
    g_opt: torch.optim.Adam
    r_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    gen: torch.Generator  # augmentation draws


def init_reg_state(g_model, r_model, d_model, seed: int = 0) -> RegState:
    """Optimizers for the three nets (their weights as they are) and the
    augmentation generator seeded from ``seed``."""
    return RegState(
        g_model, r_model, d_model,
        make_optimizer(list(g_model.parameters())),
        make_optimizer(list(r_model.parameters())),
        make_optimizer(list(d_model.parameters())),
        torch.Generator().manual_seed(seed),
    )


def _check_supported(cfg, dual_window_mode, pipeline_1f1b):
    if not dual_window_mode:
        raise NotImplementedError(
            "reg_train_step: the RegGAN family (dual_window_mode=False) is "
            "not ported yet (ROADMAP M8)")
    if pipeline_1f1b is not None:
        raise NotImplementedError(
            "reg_train_step: pipeline_1f1b is not ported yet (ROADMAP M12)")
    for key, (default, item) in _UNPORTED.items():
        if cfg.get(key, default) != default:
            raise NotImplementedError(
                f"reg_train_step: {key}={cfg[key]!r} is not ported yet "
                f"(ROADMAP {item}); the port runs {key}={default!r}")


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


def _r1_score(out, stage2: bool) -> torch.Tensor:
    """Σ over the batch of D's f32 score: the mean of each scale's last map,
    summed over scales (stage 2), or the mean logit."""
    maps = [feats[-1] for feats in out] if stage2 else [out]
    return sum(m.float().mean(dim=tuple(range(1, m.dim()))) for m in maps
               ).sum()


def reg_train_step(state: RegState, cfg: Dict, batch: Dict[str, torch.Tensor],
                   lr: float, lr_d: Optional[float] = None,
                   dual_window_mode: bool = False, stage2: bool = False,
                   pipeline_1f1b=None) -> Dict[str, torch.Tensor]:
    """One HD step on ``batch`` {A1, A2, B1, B2} (NHWC, [−1, 1]): stage 1, or
    stage 2 with ``stage2``. Updates the state's nets and optimizers in
    place; returns the detached losses under the JAX step's keys and in its
    order (``toal_loss`` as spelled there)."""
    _check_supported(cfg, dual_window_mode, pipeline_1f1b)
    g_model, r_model, d_model = state.g_model, state.r_model, state.d_model
    a2, b2, b1 = batch["A2"], batch["B2"], batch["B1"]
    n, h, w, _ = a2.shape
    noise = cfg["noise_level"]
    params_a = sample_affine_params(state.gen, n, noise, h, w)
    # aligned_aug: both sides share one draw (the JAX step's k2 = k1)
    params_b = (params_a if cfg.get("aligned_aug", False)
                else sample_affine_params(state.gen, n, noise, h, w))
    real_a = affine_warp(a2, *params_a)
    # B2 and B1 warp as channels of one gather with the same parameters
    c2 = b2.shape[-1]
    warped_b = affine_warp(torch.cat([b2, b1], dim=-1), *params_b)
    real_b, real_b1 = warped_b[..., :c2], warped_b[..., c2:]
    adv_w, corr_w = cfg["Adv_lamda1"], cfg["Corr_lamda1"]
    smooth_w = cfg["Smooth_lamda"]
    warp_r = int(cfg.get("warp_max_disp", 0))
    reg_ds = int(cfg.get("reg_downsample", 1))
    r1_w = float(cfg.get("r1_gamma", 0.0))
    if lr_d is None:
        lr_d = lr

    g_params = list(g_model.parameters())
    r_params = list(r_model.parameters())
    fake_b = g_model(real_a)
    flow = _predict_flow(r_model, fake_b, real_b, reg_ds)
    warped = (warp2d_local(fake_b, flow, warp_r) if warp_r > 0
              else warp2d(fake_b, flow))
    sm = smooth_w * smoothing_loss(flow)
    sr = corr_w * l1(warped, real_b)
    d_out = d_model(fake_b)
    if stage2:
        adv = adv_w * gan_loss_multiscale(d_out, True)
    else:
        adv = adv_w * mse(d_out, 1.0)
    total = sm + adv + sr
    aux = {"SM_loss": sm, "SR_loss": sr, "adv_loss": adv}
    if stage2 and cfg.get("FM_lamda", 0.0) > 0.0:
        fm = cfg["FM_lamda"] * feature_matching_loss(
            d_out, d_model(real_b), num_d=len(d_out))
        total = total + fm
        aux["FM_loss"] = fm
    if stage2:
        sr2 = cfg["Corr_lamda2"] * masked_correlation_loss(warped, real_b,
                                                           real_b1)
        total = total + sr2
        aux["SR_loss2"] = sr2
    grads = torch.autograd.grad(total, g_params + r_params)
    _apply(state.g_opt, g_params, grads[: len(g_params)], lr)
    _apply(state.r_opt, r_params, grads[len(g_params):], lr)

    if cfg.get("d_refwd", True):
        with torch.no_grad():
            fake2 = g_model(real_a)
    else:
        fake2 = fake_b.detach()
    d_params = list(d_model.parameters())
    # the R1 penalty differentiates D's score of the real target by its input
    real_d = real_b.detach().requires_grad_(r1_w > 0.0)
    pf, pr = d_model(fake2), d_model(real_d)
    if stage2:
        d_loss = adv_w * (gan_loss_multiscale(pf, False)
                          + gan_loss_multiscale(pr, True)) / 2.0
    else:
        d_loss = adv_w * mse(pf, 0.0) + adv_w * mse(pr, 1.0)
    out = {"toal_loss": total.detach()}
    if r1_w > 0.0:
        (gx,) = torch.autograd.grad(_r1_score(pr, stage2), real_d,
                                    create_graph=True)
        gx = gx.float()
        r1 = 0.5 * r1_w * (gx * gx).sum(dim=tuple(range(1, gx.dim()))).mean()
        d_loss = d_loss + r1.to(d_loss.dtype)
    _apply(state.d_opt, d_params, torch.autograd.grad(d_loss, d_params), lr_d)
    out["loss_D_B"] = d_loss.detach()
    if r1_w > 0.0:
        out["R1_loss"] = r1.detach()
    out.update((k, v.detach()) for k, v in aux.items())
    return out
