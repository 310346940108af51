"""The HD stage-1 train step of the port (``ctagan_tpu/train/steps.py``).

:func:`reg_train_step` with ``dual_window_mode=True`` is the JAX step of the
same name on PyTorch modules: G and R take one Adam step on the joint loss
(flow smoothness + L1 correlation of the warped fake + LSGAN adversarial
term, D frozen), then D takes one on the LSGAN loss of a fresh, no-grad G
forward with the updated weights (``d_refwd``, the reference's order) and of
the real target. Adam(0.5, 0.999, eps 1e-8) with the learning rate set on
the param groups each step, a separate ``lr_d`` for D. Augmentation draws
come from the state's ``torch.Generator``.

The step's semantic knobs that this slice does not port raise
``NotImplementedError`` naming their ROADMAP item instead of being ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from ctagan_tpu_torch.ops.augment import affine_warp, sample_affine_params
from ctagan_tpu_torch.ops.losses import l1, mse
from ctagan_tpu_torch.ops.warp import smoothing_loss, warp2d

# knob -> (value that this slice runs, the ROADMAP item that ports the rest)
_UNPORTED = {
    "grad_accum": (1, "M8 (grad_accum)"),
    "ema_decay": (0.0, "M5 (ema_decay)"),
    "r1_gamma": (0.0, "M5 (r1_gamma)"),
    "warp_max_disp": (0, "M4 (warp_max_disp flow clamp)"),
    "reg_downsample": (1, "M5 (reg_downsample)"),
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


def _check_supported(cfg, dual_window_mode, stage2, pipeline_1f1b):
    if not dual_window_mode:
        raise NotImplementedError(
            "reg_train_step: the RegGAN family (dual_window_mode=False) is "
            "not ported yet (ROADMAP M8)")
    if stage2:
        raise NotImplementedError(
            "reg_train_step: HD stage 2 is not ported yet (ROADMAP M7)")
    if pipeline_1f1b is not None:
        raise NotImplementedError(
            "reg_train_step: pipeline_1f1b is not ported yet (ROADMAP M12)")
    for key, (default, item) in _UNPORTED.items():
        if cfg.get(key, default) != default:
            raise NotImplementedError(
                f"reg_train_step: {key}={cfg[key]!r} is not ported yet "
                f"(ROADMAP {item}); this slice runs {key}={default!r}")


def reg_train_step(state: RegState, cfg: Dict, batch: Dict[str, torch.Tensor],
                   lr: float, lr_d: Optional[float] = None,
                   dual_window_mode: bool = False, stage2: bool = False,
                   pipeline_1f1b=None) -> Dict[str, torch.Tensor]:
    """One HD stage-1 step on ``batch`` {A1, A2, B1, B2} (NHWC, [−1, 1]).
    Updates the state's nets and optimizers in place; returns the detached
    losses under the JAX step's keys (``toal_loss`` as spelled there)."""
    _check_supported(cfg, dual_window_mode, stage2, pipeline_1f1b)
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
    warped_b = affine_warp(torch.cat([b2, b1], dim=-1), *params_b)
    real_b = warped_b[..., : b2.shape[-1]]
    adv_w, corr_w = cfg["Adv_lamda1"], cfg["Corr_lamda1"]
    smooth_w = cfg["Smooth_lamda"]
    if lr_d is None:
        lr_d = lr

    g_params = list(g_model.parameters())
    r_params = list(r_model.parameters())
    fake_b = g_model(real_a)
    flow = r_model(fake_b, real_b)
    warped = warp2d(fake_b, flow)
    sm = smooth_w * smoothing_loss(flow)
    sr = corr_w * l1(warped, real_b)
    adv = adv_w * mse(d_model(fake_b), 1.0)
    total = sm + adv + sr
    grads = torch.autograd.grad(total, g_params + r_params)
    _apply(state.g_opt, g_params, grads[: len(g_params)], lr)
    _apply(state.r_opt, r_params, grads[len(g_params):], lr)

    if cfg.get("d_refwd", True):
        with torch.no_grad():
            fake2 = g_model(real_a)
    else:
        fake2 = fake_b.detach()
    d_params = list(d_model.parameters())
    d_loss = (adv_w * mse(d_model(fake2), 0.0)
              + adv_w * mse(d_model(real_b), 1.0))
    _apply(state.d_opt, d_params, torch.autograd.grad(d_loss, d_params), lr_d)
    return {"toal_loss": total.detach(), "loss_D_B": d_loss.detach(),
            "SM_loss": sm.detach(), "SR_loss": sr.detach(),
            "adv_loss": adv.detach()}
