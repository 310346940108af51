"""Evaluation metrics of the port (``ctagan_tpu/ops/metrics.py``): masked
MAE and PSNR, SSIM and UQI, with the reference's eps terms, its 100 dB PSNR
cap and skimage's classic SSIM defaults.

Each takes one (H, W) image pair or a batch (N, H, W) and returns a 0-d
tensor or an (N,) tensor, one value per slice, as JAX's ``vmap`` of the
per-slice function does. Images are single-channel in [−1, 1]; "masked"
metrics exclude the background, the pixels where ``real == −1``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_HW = (-2, -1)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def masked_psnr(fake, real) -> torch.Tensor:
    """Background-excluded PSNR: MSE over ``real != −1`` of the images mapped
    to [0, 1], the global MSE + 1e-10 when there is no foreground;
    20·log10(1 / (√mse + 1e-10)), 100 where mse < 1e-10."""
    fake, real = _f32(fake), _f32(real)
    mask = (real != -1.0).to(torch.float32)
    n_fg = mask.sum(_HW)
    diff2 = ((fake + 1.0) / 2.0 - (real + 1.0) / 2.0) ** 2
    mse_fg = (diff2 * mask).sum(_HW) / torch.clamp(n_fg, min=1.0)
    mse_all = diff2.mean(_HW) + 1e-10
    mse = torch.where(n_fg > 0, mse_fg, mse_all)
    psnr = 20.0 * torch.log10(1.0 / (torch.sqrt(mse) + 1e-10))
    return torch.where(mse < 1e-10, 100.0, psnr)


def masked_mae(fake, real) -> torch.Tensor:
    """Background-excluded mean |fake − real| / 2 (the global mean + 1e-10
    when there is no foreground)."""
    fake, real = _f32(fake), _f32(real)
    mask = (real != -1.0).to(torch.float32)
    n_fg = mask.sum(_HW)
    ad = torch.abs(fake - real)
    mae_fg = (ad * mask).sum(_HW) / torch.clamp(n_fg, min=1.0)
    mae_all = ad.mean(_HW) + 1e-10
    return torch.where(n_fg > 0, mae_fg, mae_all) / 2.0


def uqi(fake, real) -> torch.Tensor:
    """Universal Quality Index over the whole slice, with the reference's
    (m − 1) sample normalisation and its 1e-10."""
    fake, real = _f32(fake), _f32(real)
    m = fake.shape[-2] * fake.shape[-1]
    mean_f = fake.mean(_HW, keepdim=True)
    mean_r = real.mean(_HW, keepdim=True)
    var_f = torch.sqrt(((fake - mean_f) ** 2).sum(_HW) / (m - 1))
    var_r = torch.sqrt(((real - mean_r) ** 2).sum(_HW) / (m - 1))
    cov = ((fake - mean_f) * (real - mean_r)).sum(_HW) / (m - 1)
    mean_f, mean_r = mean_f[..., 0, 0], mean_r[..., 0, 0]
    return (4.0 * mean_f * mean_r * cov
            / ((mean_f ** 2 + mean_r ** 2) * (var_f ** 2 + var_r ** 2)
               + 1e-10))


def _uniform_filter(x, win: int) -> torch.Tensor:
    """Mean over a win × win box, 'valid' region only: each window summed
    in f32 adds, divided once.

    Deliberately not a convolution. On the TPU the box filter lowered
    through the MXU with bf16 multiplies, and SSIM's variances
    (uxx − ux²) cancelled at that precision: validation SSIM reached 1.054.
    On a GPU a ``conv2d`` goes through cuDNN, whose TF32 is on by default
    in torch. ``avg_pool2d`` adds in f32 on every device and no TF32
    setting reaches it."""
    x = _f32(x)
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), win, stride=1)
    return y.reshape(*lead, *y.shape[-2:])


def ssim(im1, im2, data_range: float = 2.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity as classic skimage ``compare_ssim`` computes it
    for float images in [−1, 1]: 7 × 7 uniform window, sample covariances
    (N/(N−1)), data_range 2, mean over the valid region."""
    im1, im2 = _f32(im1), _f32(im2)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)

    ux = _uniform_filter(im1, win_size)
    uy = _uniform_filter(im2, win_size)
    uxx = _uniform_filter(im1 * im1, win_size)
    uyy = _uniform_filter(im2 * im2, win_size)
    uxy = _uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    return ((a1 * a2) / (b1 * b2)).mean(_HW)
