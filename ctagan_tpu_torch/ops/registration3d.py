"""Multi-scale diffeomorphic demons of the port
(``ctagan_tpu/ops/registration3d.py``): the deformable registrar of the
offline corpus stage, which aligns each patient's CTA volume onto the NCCT
(``data/registration.py::align_patient``).

The algorithm is the JAX package's, step for step: a windowed
least-squares force with symmetric gradients (a damped 3×3 solve per
voxel), a trust-region step cap, updates composed through the group
exponential (scaling and squaring), Gaussian smoothing of the composed
field, and a trilinear pyramid coarse to fine. JAX computes it in plain XLA
ops (no Pallas kernel); here it is plain PyTorch on the tensors' device,
one Python loop per pyramid level in place of ``lax.fori_loop``.

Volumes are (D, H, W), fields (D, H, W, C) with the flow's channels
(dz, dy, dx), in voxels, as in JAX. Every function takes f32 or float64
tensors; ``demons_register`` computes in f32, as JAX's does, on the card
unless ``device`` names another. Points where a plain translation of the
JAX code goes wrong, each kept here on purpose:

- ``jax.image.resize(method="linear")`` antialiases when it downsamples
  (its triangle kernel widens by 1/scale); ``F.interpolate`` does not.
  ``_resize`` builds JAX's weight matrices and applies them axis by axis.
- Edge padding may be wider than the axis (a radius of 9 on a 5-slice
  axis): the padding repeats the end samples, which equals
  ``jnp.pad(mode="edge")`` at any width.
- ``jnp.std`` is the population std; ``torch.std`` divides by n − 1
  unless told otherwise.
- ``warp3d`` gathers explicitly with JAX's clamps (sample point into
  [0, n−1], base index at most n−2, no z step at D = 1); ``grid_sample``'s
  coordinate normalisation rounds differently.
- cuDNN's convolutions use TF32 by default on Hopper: the smoothing calls
  cuDNN with TF32 off, whatever the process's flags say.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _device(device) -> torch.device:
    """The card unless the caller names another device: no quiet CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: the registrar "
                               "runs on the card; pass device='cpu' to run "
                               "it on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    return dev


# ---------------------------------------------------------------------------
# Separable Gaussian smoothing
# ---------------------------------------------------------------------------

def gaussian_kernel1d(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps with radius ceil(3·sigma), f32 as
    JAX's (a float64 caller gets these values widened)."""
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid 1-D correlation of each row of ``rows`` (N, 1, L) with ``k``
    (1, 1, K). On the card cuDNN is called with TF32 off (and its
    deterministic algorithms), so the sums are f32 whatever
    ``torch.backends.cudnn.allow_tf32`` says."""
    if rows.is_cuda:
        return torch.cudnn_convolution(
            rows.unsqueeze(2), k.unsqueeze(2), [0, 0], [1, 1], [1, 1], 1,
            False, True, False).squeeze(2)
    return F.conv1d(rows, k)


def _conv_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """1-D convolution along ``axis`` with edge padding (no border
    dimming), the padding as wide as the taps need even past the axis."""
    r = (len(taps) - 1) // 2
    xm = torch.movedim(x, axis, -1)
    shape = xm.shape
    n = shape[-1]
    rows = xm.reshape(-1, 1, n)
    # edge padding: the first and last sample repeated r times, which is
    # jnp.pad(mode="edge") at any r, also past the axis' length
    m = rows.shape[0]
    padded = torch.cat([rows[..., :1].expand(m, 1, r), rows,
                        rows[..., -1:].expand(m, 1, r)], -1)
    k = torch.as_tensor(taps, device=x.device).to(x.dtype).view(1, 1, -1)
    y = _conv1d(padded, k)
    return torch.movedim(y.reshape(shape), -1, axis)


def smooth3d(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian over the three spatial axes of a (D, H, W) volume
    or a (D, H, W, C) field (channels smoothed independently)."""
    if sigma <= 0:
        return x
    taps = gaussian_kernel1d(sigma)
    for ax in range(3):
        x = _conv_axis(x, taps, ax)
    return x.contiguous()


# ---------------------------------------------------------------------------
# Trilinear warp + displacement-field algebra
# ---------------------------------------------------------------------------

def _trilinear_taps(shape: Tuple[int, int, int], disp: torch.Tensor):
    """JAX's border-clamped trilinear sample points of x + disp(x): the
    flat index of each point's (z0, y0, x0) corner, the z step to its
    (z1, ·, ·) corners and the fractions (fz, fy, fx)."""
    D, H, W = shape
    dt, dev = disp.dtype, disp.device
    z = (torch.arange(D, dtype=dt, device=dev).view(D, 1, 1)
         + disp[..., 0]).clamp_(0.0, D - 1)
    y = (torch.arange(H, dtype=dt, device=dev).view(1, H, 1)
         + disp[..., 1]).clamp_(0.0, H - 1)
    x = (torch.arange(W, dtype=dt, device=dev).view(1, 1, W)
         + disp[..., 2]).clamp_(0.0, W - 1)
    if D > 1:
        z0 = z.floor().clamp_(0, D - 2)
        fz, step_z = z - z0, H * W
    else:  # one slice: z0 = z1 = 0
        z0, fz, step_z = torch.zeros_like(z), torch.zeros_like(z), 0
    y0 = y.floor().clamp_(0, H - 2)
    x0 = x.floor().clamp_(0, W - 2)
    fy, fx = y - y0, x - x0
    base = (z0.long() * H + y0.long()) * W + x0.long()
    return base, step_z, W, fz, fy, fx


def _sample(vol: torch.Tensor, taps) -> torch.Tensor:
    """Trilinear blend of ``vol``'s eight corners, in JAX's order (x, then
    y, then z)."""
    base, sz, sy, fz, fy, fx = taps

    def at(off):
        return torch.take(vol, base + off if off else base)

    c00 = at(0) * (1 - fx) + at(1) * fx
    c01 = at(sy) * (1 - fx) + at(sy + 1) * fx
    c10 = at(sz) * (1 - fx) + at(sz + 1) * fx
    c11 = at(sz + sy) * (1 - fx) + at(sz + sy + 1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def warp3d(vol: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Sample ``vol`` (D, H, W) at ``x + disp(x)``; ``disp`` is (D, H, W, 3)
    voxel displacements (dz, dy, dx). Border-clamped trilinear."""
    return _sample(vol, _trilinear_taps(tuple(vol.shape), disp))


def warp_field(field: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Warp each channel of a (D, H, W, C) field by ``disp`` (the sample
    points computed once for all channels)."""
    taps = _trilinear_taps(tuple(field.shape[:3]), disp)
    channels = torch.movedim(field, -1, 0).contiguous()
    return torch.stack([_sample(ch, taps) for ch in channels], -1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Displacement of ``a ∘ b``: (a∘b)(x) = b(x) + a(x + b(x))."""
    return b + warp_field(a, b)


def exp_field(u: torch.Tensor, n_squarings: int = 4) -> torch.Tensor:
    """Group exponential of a stationary velocity field by scaling and
    squaring — invertible for bounded ``u`` (diffeomorphic demons)."""
    d = u / (2.0 ** n_squarings)
    for _ in range(n_squarings):
        d = compose(d, d)
    return d


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` at unit spacing: one-sided at the ends, central
    (x[i+1] − x[i−1]) · 0.5 inside."""
    n = x.shape[dim]
    lo = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    hi = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([lo, inner, hi], dim)


def _grad3d(vol: torch.Tensor) -> torch.Tensor:
    """Central-difference spatial gradient, (D, H, W, 3); zero along z for
    a single slice."""
    gz = _gradient(vol, 0) if vol.shape[0] > 1 else torch.zeros_like(vol)
    return torch.stack([gz, _gradient(vol, 1), _gradient(vol, 2)], -1)


# ---------------------------------------------------------------------------
# Multi-scale diffeomorphic demons
# ---------------------------------------------------------------------------

def _resize_weights(m: int, n: int) -> np.ndarray:
    """(m, n) weights of ``jax.image.resize(method="linear")`` along an
    axis of m samples resized to n: the triangle kernel, widened by 1/scale
    when downsampling (antialiasing), each output's weights normalized, an
    output whose sample point lies outside the input zeroed."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n) + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(m)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _resize(vol: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.image.resize(vol, shape, "linear")``: JAX's weight matrix
    applied along each axis whose length changes."""
    for d, n in enumerate(shape):
        m = vol.shape[d]
        if m == n:
            continue
        w = torch.as_tensor(_resize_weights(m, n), dtype=vol.dtype,
                            device=vol.device)
        vol = torch.movedim(torch.tensordot(vol, w, dims=([d], [0])), -1, d)
    return vol.contiguous()


def _solve3x3(T: torch.Tensor, b: torch.Tensor,
              damp: torch.Tensor) -> torch.Tensor:
    """Solve the damped 3×3 symmetric system per voxel via the adjugate.
    ``T`` is (..., 6) packed [zz, zy, zx, yy, yx, xx]; ``b`` is (..., 3)."""
    a, ab, ac = T[..., 0] + damp, T[..., 1], T[..., 2]
    d, e = T[..., 3] + damp, T[..., 4]
    f = T[..., 5] + damp
    A = d * f - e * e
    B = ac * e - ab * f
    C = ab * e - ac * d
    det = a * A + ab * B + ac * C
    D = a * f - ac * ac
    E = ab * ac - a * e
    F_ = a * d - ab * ab
    inv_det = 1.0 / torch.clamp(det, min=1e-20)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    u0 = (A * b0 + B * b1 + C * b2) * inv_det
    u1 = (B * b0 + D * b1 + E * b2) * inv_det
    u2 = (C * b0 + E * b1 + F_ * b2) * inv_det
    return torch.stack([u0, u1, u2], -1)


def _demons_level(fixed: torch.Tensor, moving: torch.Tensor,
                  phi: torch.Tensor, iters: int, sigma_w: float,
                  sigma_diff: float, lam_rel: float, lam_abs: float,
                  step_cap: float, n_squarings: int) -> torch.Tensor:
    """``iters`` windowed-least-squares demons iterations at one pyramid
    level (JAX's ``lax.fori_loop`` body, as a Python loop)."""
    grad_f = _grad3d(fixed)
    for _ in range(iters):
        warped = warp3d(moving, phi)
        J = 0.5 * (grad_f + _grad3d(warped))  # symmetric (ESM) gradient
        diff = fixed - warped
        del warped
        J0, J1, J2 = J[..., 0], J[..., 1], J[..., 2]
        T = torch.stack([J0 * J0, J0 * J1, J0 * J2, J1 * J1, J1 * J2,
                         J2 * J2], -1)
        b = J * diff[..., None]
        del J, J0, J1, J2, diff
        Ts = smooth3d(T, sigma_w)
        del T
        bs = smooth3d(b, sigma_w)
        del b
        tr = Ts[..., 0] + Ts[..., 3] + Ts[..., 5]
        damp = lam_rel * tr + lam_abs * torch.mean(tr)
        u = _solve3x3(Ts, bs, damp)
        del Ts, bs, tr, damp
        norm = torch.sqrt(torch.sum(u * u, -1, keepdim=True))
        u = u * torch.clamp(step_cap / torch.clamp(norm, min=1e-9), max=1.0)
        phi = smooth3d(compose(phi, exp_field(u, n_squarings)), sigma_diff)
    return phi


def _level_shapes(shape: Tuple[int, int, int],
                  levels: int) -> list:
    """The pyramid's (D, H, W) shapes, coarsest first: H and W halve per
    level down to 4; the depth is divided only while the result stays ≥ 8,
    else kept whole, so it need not fall monotonically (16 slices: 16, 8,
    then 16 at the coarsest)."""
    D, H, W = shape
    shapes = []
    for lv in range(levels):  # finest -> coarsest
        f = 2 ** lv
        shapes.append((max(D // f if D // f >= 8 else D, 1),
                       max(H // f, 4), max(W // f, 4)))
    return shapes[::-1]


def _lap(times: Optional[dict], key: str, t0: float,
         dev: torch.device) -> float:
    """Record the seconds since ``t0`` under ``key`` (after the card's
    queue drains) when the caller asked for times; the new start."""
    if times is None:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    times[key] = now - t0
    return now


def _zscore(vol: torch.Tensor) -> torch.Tensor:
    """(vol − mean) / max(std, 1e-6) with the population std (jnp.std's;
    ``torch.std`` divides by n − 1 by default). Each volume is normalized
    on its own, so an intensity offset or gain between the pair (CTA
    contrast against NCCT) is not explained by deformation."""
    return (vol - vol.mean()) / torch.clamp(vol.std(correction=0), min=1e-6)


def _register(fixed: torch.Tensor, moving: torch.Tensor, levels: int,
              iters: Sequence[int], sigma_w: float, sigma_diff: float,
              lam_rel: float, lam_abs: float, step_cap: float,
              n_squarings: int, times: Optional[dict] = None
              ) -> torch.Tensor:
    """The registrar in the inputs' dtype and on their device:
    ``demons_register`` after its conversion."""
    t0 = time.perf_counter()
    fixed, moving = _zscore(fixed), _zscore(moving)
    shapes = _level_shapes(tuple(fixed.shape), levels)
    its = list(iters)
    if len(its) < levels:
        its = its + [its[-1]] * (levels - len(its))
    its = its[-levels:]
    t0 = _lap(times, "z-score", t0, fixed.device)

    phi = torch.zeros(shapes[0] + (3,), dtype=fixed.dtype,
                      device=fixed.device)
    for lv, shp in enumerate(shapes):
        f_l = _resize(fixed, shp)
        m_l = _resize(moving, shp)
        if tuple(phi.shape[:3]) != shp:
            prev = phi.shape[:3]
            # an f32 ratio, as JAX's, whatever the field's dtype
            ratio = torch.tensor([shp[i] / prev[i] for i in range(3)],
                                 dtype=torch.float32).to(phi)
            phi = _resize(phi, shp + (3,)) * ratio
        phi = _demons_level(f_l, m_l, phi, iters=int(its[lv]),
                            sigma_w=sigma_w, sigma_diff=sigma_diff,
                            lam_rel=lam_rel, lam_abs=lam_abs,
                            step_cap=step_cap, n_squarings=n_squarings)
        del f_l, m_l
        t0 = _lap(times, f"level {lv} {'x'.join(map(str, shp))} "
                  f"{int(its[lv])} iterations", t0, fixed.device)
    return phi


@torch.no_grad()
def demons_register(
    fixed,
    moving,
    levels: int = 3,
    iters: Sequence[int] = (30, 40, 60),
    sigma_w: float = 3.0,
    sigma_diff: float = 1.0,
    lam_rel: float = 0.02,
    lam_abs: float = 0.02,
    step_cap: float = 0.5,
    n_squarings: int = 4,
    device=None,
    times: Optional[dict] = None,
) -> torch.Tensor:
    """Register ``moving`` onto ``fixed`` (both (D, H, W) numpy volumes, any
    intensity scale) in f32 on ``device`` (default the card; with no card
    and no ``device`` it raises). Returns the (D, H, W, 3) voxel
    displacement field φ on that device such that ``warp3d(moving, φ) ≈
    fixed``. Coarse to fine over ``levels`` trilinear pyramid levels
    (factor 2 in H and W; the depth only while it stays ≥ 8 slices).
    ``times``, if given, receives the seconds of the z-score and of each
    level."""
    dev = _device(device)
    fixed = torch.as_tensor(np.asarray(fixed, np.float32), device=dev)
    moving = torch.as_tensor(np.asarray(moving, np.float32), device=dev)
    return _register(fixed, moving, levels, iters, sigma_w, sigma_diff,
                     lam_rel, lam_abs, step_cap, n_squarings, times)
