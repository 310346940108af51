"""Losses of the port's HD steps (``ctagan_tpu/ops/losses.py``; the flow
smoothness term is ``ops/warp.py::smoothing_loss``): LSGAN on scalar logits
(stage 1), and for stage 2 the multi-scale GAN loss with per-scale weights
[1.8, 0.2] on globally pooled logits, pix2pixHD feature matching and the
window-masked second correlation loss (SR_loss2).

Under sp training (``parallel/spatial.py``: the context of
``models/layers.py::sp_scope``) each rank's :func:`mse` and :func:`l1` are
its part of the loss: of an NHWC strip, the sum over its rows divided by
the whole image's element count; of a tensor every rank holds alike (the
pooled logits), the mean divided by the block's size. The parts sum over
the block to the loss of one process."""
from __future__ import annotations

from typing import Sequence

import torch

from ctagan_tpu_torch.models.layers import global_avg_pool_logit, sp_context
from ctagan_tpu_torch.ops.windowing import body_mask, mask_background_to_air

# Per-scale weights of the multi-scale GAN loss (the reference's HdGan.py)
MULTISCALE_WEIGHTS = (1.8, 0.2)


def _mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t``, or under sp training this rank's part of it."""
    sp = sp_context()
    return t.mean() if sp is None or not sp.exchanges else sp.mean(t)


def mse(pred: torch.Tensor, target) -> torch.Tensor:
    return _mean((pred - target) ** 2)


def l1(pred: torch.Tensor, target) -> torch.Tensor:
    return _mean((pred - target).abs())


def lsgan_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """MSE of the discriminator's output against 1 (real) or 0 (fake)."""
    return mse(pred, 1.0 if target_is_real else 0.0)


def _pool_logit(feat: torch.Tensor) -> torch.Tensor:
    """Global-average-pool a (N, H, W, 1) map to (N, 1) logits (under sp
    training over the whole image: ``global_avg_pool_logit``)."""
    return global_avg_pool_logit(feat)


def gan_loss_multiscale(scale_features: Sequence[Sequence[torch.Tensor]],
                        target_is_real: bool,
                        weights=MULTISCALE_WEIGHTS) -> torch.Tensor:
    """The HD ``GANLoss`` on a multi-scale discriminator's output: the last
    map of each scale pooled to a logit, LSGAN, weighted per scale. The
    reference has weights for two scales; more raise (the JAX package
    fails there with an IndexError)."""
    if len(scale_features) > len(weights):
        raise ValueError(
            f"gan_loss_multiscale: {len(scale_features)} scales but weights "
            f"for {len(weights)} ({weights}): num_d must be <= "
            f"{len(weights)}")
    loss = 0.0
    for feats, w in zip(scale_features, weights):
        loss = loss + lsgan_loss(_pool_logit(feats[-1]), target_is_real) * w
    return loss


def gan_loss_single(features: Sequence[torch.Tensor],
                    target_is_real: bool) -> torch.Tensor:
    """The HD ``GANLoss`` on one scale's feature list."""
    return lsgan_loss(_pool_logit(features[-1]), target_is_real)


def feature_matching_loss(fake_feats, real_feats, n_layers: int = 3,
                          num_d: int = 1) -> torch.Tensor:
    """pix2pixHD feature matching: L1 between every intermediate map (all
    but each scale's last) of the fake and the detached real features,
    weighted 4 / (n_layers + 1) / num_d."""
    loss = 0.0
    weight = (1.0 / num_d) * (4.0 / (n_layers + 1))
    for scale_f, scale_r in zip(fake_feats, real_feats):
        for f, r in zip(scale_f[:-1], scale_r[:-1]):
            loss = loss + weight * l1(f, r.detach())
    return loss


def masked_correlation_loss(pred: torch.Tensor, target: torch.Tensor,
                            window_target: torch.Tensor,
                            threshold: float = 0.3) -> torch.Tensor:
    """SR_loss2: L1 between ``pred`` and ``target`` inside the body mask of
    the windowed target (``window_target >= 0.3``), both with the
    background, and any exact 0 inside the mask, set to −1 (the reference's
    ``x*mask; x[x==0] = -1``). In f32, as the JAX package's mask helpers
    cast."""
    mask = body_mask(window_target, threshold)
    return l1(mask_background_to_air(pred, mask),
              mask_background_to_air(target, mask))
