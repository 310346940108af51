"""Int8 serving path for the ResNet generator (``ctagan_tpu/ops/quantize.py``).

Post-training quantization for inference: symmetric per-output-channel int8
weights and per-tensor dynamic int8 activations, convolutions accumulating
exactly in int32. The 7×7 head and tail convs stay f32. The parameter tree
keeps the JAX package's structure and layouts (HWIO kernels; the up path's
transposed kernels turned into regular kernels of an input-dilated conv), so
the tests compare it leaf for leaf with JAX's.

The residual body runs through the fused int8 chain
(``ops/fused_s8.py``, kernel K7) where ``s8_chain_ok`` admits its shape,
else through the per-conv loop below, as JAX decides with its A/B switch
``FUSED_S8_BODY`` at its default (on). The downs and ups (and that loop)
are ``_conv_i8``: an im2col of the int8 input and one exact int8 × int8 →
int32 product (``torch._int_mm``), which is what XLA's s8 conv computes.
The InstanceNorms outside the body are ``models.layers.instance_norm``, K6
when its switch is on. As in JAX, the forward pads by reflection whatever the generator's
``pad_mode`` and computes in f32 whatever its ``dtype``.

Quality: every int8 conv is followed by an InstanceNorm, which absorbs the
per-channel weight scales, so the noise is the activation rounding; the
forward is held to > 30 dB PSNR against the f32 route over [-1, 1], JAX's
own contract (``tests/test_quantize.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ctagan_tpu_torch.models import layers
from ctagan_tpu_torch.models.layers import reflect_pad
from ctagan_tpu_torch.ops.fused_s8 import (
    fused_residual_chain_s8,
    im2col,
    int8_matmul,
    s8_chain_ok,
)

EPS = 1e-5


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def quantize_weight_per_channel(w: torch.Tensor, out_axis: int = 3):
    """Symmetric per-output-channel int8 quantization of a conv kernel.

    Returns (q int8, scale f32 (out,)) with w ≈ q · scale."""
    w = w.detach().float()
    reduce_axes = tuple(a for a in range(w.dim()) if a != out_axis)
    amax = w.abs().amax(dim=reduce_axes)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    shape = [1] * w.dim()
    shape[out_axis] = -1
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def _quantize_act(x: torch.Tensor):
    """Per-tensor dynamic symmetric int8 activation quantization."""
    amax = torch.clamp_min(x.abs().amax(), 1e-8)
    inv = 127.0 / amax
    q = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    return q, inv


# ---------------------------------------------------------------------------
# Parameter-tree transformation
# ---------------------------------------------------------------------------

def _qconv(kernel: torch.Tensor, bias: torch.Tensor, exact: bool = False):
    if exact:  # f32 weights, scale 1: the plumbing check of the tests
        w = kernel.detach().float()
        return {"q": w, "scale": torch.ones(w.shape[3], device=w.device),
                "bias": bias.detach().float()}
    q, scale = quantize_weight_per_channel(kernel, out_axis=3)
    return {"q": q, "scale": scale, "bias": bias.detach().float()}


def _transpose_to_regular(weight: torch.Tensor) -> torch.Tensor:
    """ConvTransposeTorch weight (I, O, kh, kw) -> the HWIO kernel of the
    equivalent input-dilated regular conv: spatially flipped (kh, kw, I, O)."""
    return weight.detach().float().permute(2, 3, 0, 1).flip(0, 1)


def quantize_generator(generator, exact: bool = False) -> Dict[str, Any]:
    """The int8 inference tree of a port ``Generator``, in JAX's structure:
    ``head``/``tail`` {kernel (HWIO f32), bias}, ``down`` and ``up`` lists and
    ``res`` [[conv1, conv2], ...] of {q (HWIO int8), scale, bias}.
    ``exact=True`` keeps f32 weights with scale 1 (a plumbing check)."""
    head, tail = generator.model_head, generator.model_tail

    def f32(conv):
        return {"kernel": conv.hwio().detach().float(),
                "bias": conv.bias.detach().float()}

    with torch.no_grad():
        return {
            "head": f32(head[1]),
            "down": [_qconv(conv.hwio(), conv.bias, exact)
                     for conv in (head[4], head[7])],
            "res": [[_qconv(blk.conv_block[j].hwio(), blk.conv_block[j].bias,
                            exact) for j in (1, 5)]
                    for blk in generator.model_body],
            "up": [_qconv(_transpose_to_regular(up.weight), up.bias, exact)
                   for up in (tail[0], tail[3])],
            "tail": f32(tail[7]),
        }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantized_size_bytes(qp) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(qp))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv_f32(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 stride=stride)
    return (y.permute(0, 2, 3, 1) + bias).contiguous()


def _pad_dilate(x: torch.Tensor, padding: Tuple[int, int],
                lhs_dilation: Optional[Tuple[int, int]]) -> torch.Tensor:
    """XLA's conv input geometry on NHWC: zeros between the pixels
    (``lhs_dilation``), then the (lo, hi) zero padding of H and W."""
    if lhs_dilation:
        n, h, w, c = x.shape
        dy, dx = lhs_dilation
        xd = x.new_zeros((n, (h - 1) * dy + 1, (w - 1) * dx + 1, c))
        xd[:, ::dy, ::dx] = x
        x = xd
    lo, hi = padding
    return F.pad(x, (0, 0, lo, hi, lo, hi))


def _conv_i8(x: torch.Tensor, c, stride: int = 1,
             padding: Tuple[int, int] = (0, 0),
             lhs_dilation: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Dynamic-int8 3×3 conv: quantize x per tensor, int8 × int8 → exact
    int32 (im2col + ``int8_matmul``), dequantize with the combined
    activation/weight scales, add the bias."""
    xq, x_inv = _quantize_act(x)
    xp = _pad_dilate(xq, padding, lhs_dilation)
    n, hp, wp, cin = xp.shape
    ho, wo = (hp - 3) // stride + 1, (wp - 3) // stride + 1
    q = c["q"]
    y = int8_matmul(im2col(xp, stride, ho, wo),
                    q.reshape(9 * cin, q.shape[3]))
    y = y.reshape(n, ho, wo, q.shape[3])
    return y.float() * (c["scale"] / x_inv) + c["bias"]


def _norm(h: torch.Tensor, activation: Optional[str] = "relu"):
    """activation(instance_norm(h)): K6 when its switch and JAX's gate
    admit h."""
    return layers.instance_norm(h, EPS, activation=activation)


def generator_int8_forward(qp, x: torch.Tensor) -> torch.Tensor:
    """Int8 counterpart of ``Generator.forward`` (NHWC in [-1, 1] -> tanh
    output): head and tail f32, body int8."""
    x = x.float()
    h = _conv_f32(reflect_pad(x, 3), qp["head"]["kernel"], qp["head"]["bias"])
    h = _norm(h)
    for c in qp["down"]:
        h = _conv_i8(h, c, stride=2, padding=(1, 1))
        h = _norm(h)
    if (qp["res"] and s8_chain_ok(h.shape)
            and qp["res"][0][0]["q"].dtype == torch.int8):
        qb = [(c1["q"], c1["scale"], c1["bias"].reshape(-1),
               c2["q"], c2["scale"], c2["bias"].reshape(-1))
              for c1, c2 in qp["res"]]
        h = fused_residual_chain_s8(h, qb, eps=EPS)
    else:
        for c1, c2 in qp["res"]:
            r = _norm(_conv_i8(reflect_pad(h, 1), c1))
            r = _conv_i8(reflect_pad(r, 1), c2)
            h = h + _norm(r, activation=None)
    # ConvTranspose(k3, s2, p1, op1) == input-dilated conv with padding
    # (1, 2) and the flipped, transposed kernel
    for c in qp["up"]:
        h = _conv_i8(h, c, stride=1, padding=(1, 2), lhs_dilation=(2, 2))
        h = _norm(h)
    h = _conv_f32(reflect_pad(h, 3), qp["tail"]["kernel"], qp["tail"]["bias"])
    return torch.tanh(h)


def generator_dequant_forward(qp, x: torch.Tensor) -> torch.Tensor:
    """The same graph with dequantized f32 weights and f32 convs: the
    plumbing check of the tests (matches ``Generator`` to float tolerance)."""

    def deq(c):
        return c["q"].float() * c["scale"], c["bias"]

    def conv(h, kernel, bias, stride=1, padding=(0, 0), lhs_dilation=None):
        hp = _pad_dilate(h, padding, lhs_dilation)
        return _conv_f32(hp, kernel, bias, stride)

    x = x.float()
    h = _conv_f32(reflect_pad(x, 3), qp["head"]["kernel"], qp["head"]["bias"])
    h = layers.instance_norm(h, EPS, activation="relu")
    for c in qp["down"]:
        h = conv(h, *deq(c), stride=2, padding=(1, 1))
        h = layers.instance_norm(h, EPS, activation="relu")
    for c1, c2 in qp["res"]:
        r = conv(reflect_pad(h, 1), *deq(c1))
        r = layers.instance_norm(r, EPS, activation="relu")
        r = conv(reflect_pad(r, 1), *deq(c2))
        h = h + layers.instance_norm(r, EPS)
    for c in qp["up"]:
        h = conv(h, *deq(c), padding=(1, 2), lhs_dilation=(2, 2))
        h = layers.instance_norm(h, EPS, activation="relu")
    h = _conv_f32(reflect_pad(h, 3), qp["tail"]["kernel"], qp["tail"]["bias"])
    return torch.tanh(h)
