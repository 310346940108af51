"""Backward of the fused residual body: K4 (input grad) and K5 (weight grad).

Replaces ``ctagan_tpu/ops/fused_resblock_grad.py``, whose two Pallas kernels
become the CUDA kernels of ``csrc/fused_resblock_grad.cuh``:

- :func:`conv3x3_input_grad` (K4, ``_corr3x3_zero``): dL/dx of the reflect-
  padded 3×3 conv. The interior is a zero-halo correlation of g with the
  flipped, transposed kernel (``_flip_pack``), run by the K1 implicit GEMM in
  its ``ZERO_S1`` mode; the reflect-pad adjoint then folds the four padded
  border lines and the corners back inside in plain tensor ops, as the JAX
  package does them in XLA outside its kernel.
- :func:`conv3x3_weight_grad` (K5, ``_wgrad_kernel``): dL/dW as a reduction
  over every pixel, with K1's norm → ReLU → round → +skip prologue applied as
  the input tile is staged, so relu(IN(h1)) is never stored. Blocks split the
  pixel axis and add f32 partials with ``atomicAdd``.

What bounds them on the H100: ~19.3 GFLOP each at the main path's
(1, 128, 128, 256) × 256, far above the ops-per-byte ridge, so arithmetic;
like K1 they run f32 CUDA-core FMAs (no tensor cores yet), so their speed is
K1's (13-20 TFLOP/s on an H100 80GB HBM3 at 700 W). ``wgmma`` and TMA are
later work.

:class:`FusedChainFunction` is ``fused_chain_vjp_make``'s custom VJP as a
``torch.autograd.Function``: its forward runs the K1 chain and keeps
(x_i, h1, n1, h2, n2) per block, its backward runs 2 K4 and 2 K5 launches
per block. On a CUDA tensor each wrapper launches its kernel or raises; on a
CPU tensor it runs its plain PyTorch version, which is also the kernel's
oracle on the card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ctagan_tpu_torch.models.layers import reflect_pad
from ctagan_tpu_torch.ops import _build
from ctagan_tpu_torch.ops._common import (
    DTYPES,
    PLAIN_DTYPES,
    acc_dtype,
    apply_norm,
    check_input,
    same_device,
    stream_ptr,
)
from ctagan_tpu_torch.ops.fused_resblock import (
    _stats_to_norm,
    conv3x3_reflect_stats,
)

# ---------------------------------------------------------------------------
# K4: input gradient = zero-halo correlation + reflect folds
# ---------------------------------------------------------------------------


def _flip_pack(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Cout) conv kernel -> the adjoint's (3, 3, Cout, C) kernel:
    flip kh/kw, swap in/out (the JAX package's (3, 3·Cout, C) packing,
    unpacked to the kernels' (kh, kw, I, O) layout)."""
    return torch.flip(w, (0, 1)).transpose(2, 3).contiguous()


def _check_input_grad(g, w, dtypes=PLAIN_DTYPES):
    check_input("conv3x3_input_grad", g, dtypes=dtypes)
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[3] != g.shape[3]:
        raise ValueError(f"w must be (3, 3, C, {g.shape[3]}), got "
                         f"{tuple(w.shape)}")
    if g.shape[1] < 2 or g.shape[2] < 2:
        raise ValueError(f"reflect pad needs H, W >= 2, got {g.shape[1:3]}")


def _corr3x3_zero_plain(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3×3 correlation of g with v (3, 3, Cout, C) in f32 (f64
    for f64) of the dtype-rounded operands, rounded to g.dtype."""
    ad = acc_dtype(g.dtype)
    y = torch.nn.functional.conv2d(
        g.to(ad).permute(0, 3, 1, 2), v.to(g.dtype).to(ad).permute(3, 2, 0, 1),
        padding=1)
    return y.permute(0, 2, 3, 1).to(g.dtype).contiguous()


def _corr3x3_zero_kernel(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    n, h, wd, c = g.shape
    cout = v.shape[3]
    if c % 16 or cout % 64:
        raise ValueError("conv3x3_input_grad: the CUDA kernel needs the "
                         "forward conv's C % 64 == 0 and Cout % 16 == 0, got "
                         f"C={cout}, Cout={c}")
    vk = v.to(g.dtype).contiguous()
    out = torch.empty((n, h, wd, cout), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        _build.launch("ctk_conv3x3_zero_corr", g.data_ptr(), vk.data_ptr(),
                      out.data_ptr(), n, h, wd, c, cout,
                      int(g.dtype == torch.bfloat16), stream_ptr(g))
    conv3x3_input_grad.launches += 1
    return out


def _reflect_folds(dx: torch.Tensor, g: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Add the reflect-pad adjoint's border terms to the f32 (f64) interior
    ``dx`` in place (``ctagan_tpu/ops/fused_resblock_grad.py:156-206``):
    rows -1 and H fold to rows 1 and H-2, then the four corners, then
    columns -1 and W fold to columns 1 and W-2."""
    h, wd = g.shape[1], g.shape[2]
    wf = w.to(dx.dtype)
    gf = g.to(dx.dtype)

    def corr_line(line, wline):
        # line (N, L, Co), wline (3, C, Co): zero-padded 1-D correlation,
        # out[., j] = sum_k wline[k] @ line[., j + 1 - k], as one conv1d
        out = torch.nn.functional.conv1d(
            line.transpose(1, 2), wline.flip(0).permute(1, 2, 0), padding=1)
        return out.transpose(1, 2)

    dx[:, 1] += corr_line(gf[:, 0], wf[0])           # padded row -1
    dx[:, h - 2] += corr_line(gf[:, h - 1], wf[2])   # padded row H
    lcol = corr_line(gf[:, :, 0], wf[:, 0])          # padded col -1
    rcol = corr_line(gf[:, :, wd - 1], wf[:, 2])     # padded col W
    for (gr, gc), (kh, kw), (tr, tc) in (
        ((0, 0), (0, 0), (1, 1)),
        ((0, wd - 1), (0, 2), (1, wd - 2)),
        ((h - 1, 0), (2, 0), (h - 2, 1)),
        ((h - 1, wd - 1), (2, 2), (h - 2, wd - 2)),
    ):
        dx[:, tr, tc] += torch.einsum("no,co->nc", gf[:, gr, gc], wf[kh, kw])
    dx[:, :, 1] += lcol
    dx[:, :, wd - 2] += rcol
    return dx


def conv3x3_input_grad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3_input_grad`."""
    _check_input_grad(g, w)
    dx = _corr3x3_zero_plain(g, _flip_pack(w)).to(acc_dtype(g.dtype))
    return _reflect_folds(dx, g, w).to(g.dtype)


def conv3x3_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx of y = conv3x3(reflect_pad(x), w) given g = dL/dy.

    g: (N, H, W, Cout) f32 or bf16, contiguous; w: (3, 3, C, Cout). Returns
    (N, H, W, C) in g.dtype: the interior (K4 on a CUDA tensor) rounded to
    the dtype, plus the f32 reflect folds, rounded again.
    """
    if not g.is_cuda:
        return conv3x3_input_grad_plain(g, w)
    _check_input_grad(g, w, DTYPES)
    same_device("conv3x3_input_grad", g, w)
    dx = _corr3x3_zero_kernel(g, _flip_pack(w)).float()
    return _reflect_folds(dx, g, w).to(g.dtype)


conv3x3_input_grad.launches = 0

# ---------------------------------------------------------------------------
# K5: weight gradient with the streaming norm / ReLU / skip prologue
# ---------------------------------------------------------------------------


def _check_weight_grad(x, g, norm, skip, dtypes=PLAIN_DTYPES):
    check_input("conv3x3_weight_grad", x, dtypes=dtypes)
    check_input("conv3x3_weight_grad g", g, dtypes=dtypes)
    if tuple(g.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(f"g {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(f"reflect pad needs H, W >= 2, got {x.shape[1:3]}")
    if norm is not None and tuple(norm.shape) != (x.shape[0], 2, x.shape[3]):
        raise ValueError(f"norm must be (N, 2, C), got {tuple(norm.shape)}")
    if skip is not None:
        if norm is None:
            raise ValueError("skip requires norm")
        if skip.shape != x.shape:
            raise ValueError("skip must match x's shape")


def conv3x3_weight_grad_plain(
    x: torch.Tensor, g: torch.Tensor, norm: Optional[torch.Tensor] = None,
    relu: bool = False, skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3_weight_grad`: the same
    prologue, then nine f32 (f64 for f64) (C, P) × (P, Cout) products of the
    dtype-rounded operands."""
    _check_weight_grad(x, g, norm, skip)
    dt = x.dtype
    ad = acc_dtype(dt)
    xs = apply_norm(x, norm, relu)
    if skip is not None:
        xs = skip.to(dt) + xs  # normalize, cast, then add (JAX order)
    xp = reflect_pad(xs, 1).to(ad)
    gf = g.to(dt).to(ad)
    h, wd = x.shape[1], x.shape[2]
    taps = [torch.einsum("nhwc,nhwo->co", xp[:, kh:kh + h, kw:kw + wd], gf)
            for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, x.shape[3], g.shape[3])


def conv3x3_weight_grad(
    x: torch.Tensor, g: torch.Tensor, norm: Optional[torch.Tensor] = None,
    relu: bool = False, skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dL/dW of y = conv3x3(reflect_pad(f(x)), W) given g = dL/dy.

    x: (N, H, W, C), g: (N, H, W, Cout), both f32 or bf16 (g is cast to
    x.dtype); f is the optional prologue ``norm`` (N, 2, C) [mean, rstd]
    (+ ``relu``) (+ ``skip``, which requires norm). Returns (3, 3, C, Cout)
    f32. The bias gradient is a plain sum of g, outside this function.
    """
    if not x.is_cuda:
        return conv3x3_weight_grad_plain(x, g, norm, relu, skip)
    _check_weight_grad(x, g, norm, skip, DTYPES)
    same_device("conv3x3_weight_grad", x, g, norm, skip)
    n, h, wd, c = x.shape
    cout = g.shape[3]
    if c % 64 or cout % 64:
        raise ValueError("conv3x3_weight_grad: the CUDA kernel needs C % 64 "
                         f"== 0 and Cout % 64 == 0, got C={c}, Cout={cout}")
    dt = x.dtype
    gk = g.to(dt).contiguous()
    sk = skip.to(dt).contiguous() if skip is not None else None
    nk = norm.float().contiguous() if norm is not None else None
    dw = torch.zeros((3, 3, c, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "ctk_conv3x3_weight_grad", x.data_ptr(),
            sk.data_ptr() if sk is not None else None, gk.data_ptr(),
            nk.data_ptr() if nk is not None else None, dw.data_ptr(),
            n, h, wd, c, cout, int(bool(relu and norm is not None)),
            int(dt == torch.bfloat16), stream_ptr(x))
    conv3x3_weight_grad.launches += 1
    return dw


conv3x3_weight_grad.launches = 0

# ---------------------------------------------------------------------------
# instance-norm backward and the chain's custom VJP
# ---------------------------------------------------------------------------


def _in_bwd(g: torch.Tensor, h: torch.Tensor,
            norm: torch.Tensor) -> torch.Tensor:
    """dL/dh of y = (h − mean)·rstd given g = dL/dy and the forward
    (N, 2, C) [mean, rstd]: rstd·(g − mean(g) − x̂·mean(g·x̂)), f32 (f64
    for f64)."""
    ad = acc_dtype(torch.promote_types(g.dtype, h.dtype))
    mean = norm[:, 0, None, None, :]
    rstd = norm[:, 1, None, None, :]
    gf = g.to(ad)
    xhat = (h.to(ad) - mean) * rstd
    gm = gf.mean(dim=(1, 2), keepdim=True)
    gxm = (gf * xhat).mean(dim=(1, 2), keepdim=True)
    return rstd * (gf - gm - xhat * gxm)


Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _chain_fwd_collect(x: torch.Tensor, block_params: Sequence[Block],
                       eps: float):
    """The K1 chain (``fused_residual_chain`` without ``in_norm``) that also
    returns the per-block residuals (x_i, h1, n1, h2, n2)."""
    hw = float(x.shape[1] * x.shape[2])
    res: List[tuple] = []
    h2 = s2 = None
    for i, (k1, b1, k2, b2) in enumerate(block_params):
        if i == 0:
            h1, s1 = conv3x3_reflect_stats(x, k1, b1)
        else:
            n2 = _stats_to_norm(s2, hw, eps)
            res[-1] = res[-1] + (n2,)
            h1, s1, x = conv3x3_reflect_stats(h2, k1, b1, norm=n2, skip=x)
        n1 = _stats_to_norm(s1, hw, eps)
        h2, s2 = conv3x3_reflect_stats(h1, k2, b2, norm=n1, relu=True)
        res.append((x, h1, n1, h2))
    n2 = _stats_to_norm(s2, hw, eps)
    res[-1] = res[-1] + (n2,)
    return x + apply_norm(h2, n2), res


def _block_bwd(g_out, x, h1, n1, h2, n2, k1, k2):
    """Reverse one residual block x + IN2(conv2(relu(IN1(conv1(x))))) given
    g_out = dL/d(block output) in f32 (f64). Returns (dx, dk1, db1, dk2,
    db2)."""
    ad = g_out.dtype
    dh2 = _in_bwd(g_out, h2, n2)
    dh2c = dh2.to(h2.dtype)
    db2 = dh2.sum(dim=(0, 1, 2))
    da1 = conv3x3_input_grad(dh2c, k2)
    dk2 = conv3x3_weight_grad(h1, dh2c, norm=n1, relu=True)
    # ReLU backward: a1 > 0 <=> h1 > mean1 (rstd > 0), strictly
    dh1n = torch.where(h1.to(ad) > n1[:, 0, None, None, :], da1.to(ad),
                       torch.zeros((), dtype=ad, device=h1.device))
    dh1 = _in_bwd(dh1n, h1, n1)
    dh1c = dh1.to(h1.dtype)
    db1 = dh1.sum(dim=(0, 1, 2))
    dx = conv3x3_input_grad(dh1c, k1)
    dk1 = conv3x3_weight_grad(x, dh1c)
    return g_out + dx.to(ad), dk1, db1, dk2, db2


class FusedChainFunction(torch.autograd.Function):
    """The residual body with the JAX package's custom VJP
    (``fused_chain_vjp_make``). ``apply(x, eps, k1, b1, k2, b2, ...)``: the
    kernels in the (3, 3, C, Cout) layout (``ConvTorch.hwio()`` views, so
    autograd carries their gradients back to the (O, I, kh, kw)
    parameters)."""

    @staticmethod
    def forward(ctx, x, eps, *flat):
        blocks = [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]
        out, res = _chain_fwd_collect(x, blocks, eps)
        saved = [t for r in res for t in r]
        ctx.save_for_backward(*saved, *flat)
        ctx.n_blocks = len(blocks)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        nb = ctx.n_blocks
        res = [saved[5 * i: 5 * i + 5] for i in range(nb)]
        flat = saved[5 * nb:]
        gf = g.to(acc_dtype(g.dtype))
        grads: List[torch.Tensor] = []
        for i in range(nb - 1, -1, -1):
            x_i, h1, n1, h2, n2 = res[i]
            k1, b1, k2, b2 = flat[4 * i: 4 * i + 4]
            gf, dk1, db1, dk2, db2 = _block_bwd(gf, x_i, h1, n1, h2, n2, k1,
                                                k2)
            grads[:0] = [dk1.to(k1.dtype), db1.to(b1.dtype),
                         dk2.to(k2.dtype), db2.to(b2.dtype)]
        return (gf.to(res[0][0].dtype), None, *grads)


def fused_chain(x: torch.Tensor, block_params: Sequence[Block],
                eps: float = 1e-5) -> torch.Tensor:
    """Differentiable residual body: ``block_params`` is a list of
    (k1, b1, k2, b2) with the kernels in (3, 3, C, Cout)."""
    flat = [t for blk in block_params for t in blk]
    return FusedChainFunction.apply(x, eps, *flat)
