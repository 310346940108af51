"""ResNet generator of the port (``ctagan_tpu/models/generator.py``).

c7s1-64 head, two stride-2 downsampling convs (64 → 128 → 256),
``n_residual_blocks`` residual blocks at 256 channels, two transposed-conv
upsampling stages and a reflect-padded 7×7 output conv + tanh, on NHWC
tensors. The submodules carry the reference's ``nn.Sequential`` key names
(``model_head.{1,4,7}``, ``model_body.{i}.conv_block.{1,5}``,
``model_tail.{0,3,7}``), so a reference ``.pth`` loads with ``strict=True``.

``fused_body=True`` (the serving route) runs the JAX package's
``fused_body`` forward: the two downs through K3, the residual body through
the K1 chain and the two ups through K2, each with the previous
InstanceNorm folded into its input read. On a CUDA tensor those are the
CUDA kernels at every batch size (a shape a kernel cannot take raises); on a
CPU tensor they are their plain versions. ``fused_body=False`` runs the
plain layer-by-layer path, and so does ``pad_mode='zero'`` on any device
(JAX's ``chain_ok`` leaves zero pad out of the fused body too).

``fused_body_grad`` (the training route, JAX's ``fused_body_grad``) runs
the head, the two downs, the two ups and the tail as plain layers and the
residual body through :class:`~ctagan_tpu_torch.ops.fused_resblock_grad.
FusedChainFunction`: K1 launches forward, K4 and K5 launches backward.
``'auto'`` turns it on for a CUDA tensor (JAX: on a TPU); ``True`` also runs
it on a CPU tensor, through the kernels' plain versions.

``remat`` (JAX's ``remat``, config ``remat``): on the layer route, while
grad is enabled, each ``ResidualBlock`` runs under
``torch.utils.checkpoint`` (``use_reentrant=False``), so its activations
are recomputed in the backward instead of kept. On the kernel route
(``fused_body_grad``) it does nothing, exactly as in JAX, whose fused-grad
body never builds the rematerialized block: ``FusedChainFunction`` already
saves only what its backward needs (each block's input, its two raw conv
outputs and their norm statistics).

A body split over tensor-parallel ranks (``parallel/tensor.py``: its blocks
hold slices) runs the layer route whatever the flags say, as JAX gates its
kernels off under a model-sharded plan; gathered whole again (an eval
forward), it takes the route the flags pick. So does a forward under the
sp plan's context (``models/layers.py::sp_scope``: ``parallel/halo.py``'s
sharded inference, ``parallel/spatial.py``'s sharded step), as JAX's gate
leaves its kernels off under ``spatial_axis``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ctagan_tpu_torch.models.layers import (
    ConvTorch,
    ConvTransposeTorch,
    InstanceNorm,
    ReflectPad,
    ResidualBlock,
    channel_stats,
    reflect_pad,
    sp_context,
)
from ctagan_tpu_torch.ops._common import apply_norm
from ctagan_tpu_torch.ops.fused_convt import convt2x_stats
from ctagan_tpu_torch.ops.fused_down import conv3x3_s2_zero_stats
from ctagan_tpu_torch.ops.fused_resblock import (
    _stats_to_norm,
    fused_residual_chain,
)
from ctagan_tpu_torch.ops.fused_resblock_grad import fused_chain

EPS = 1e-5


class Generator(nn.Module):
    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 n_residual_blocks: int = 9, base_features: int = 64,
                 dtype: Optional[torch.dtype] = None,
                 pad_mode: str = "reflect", fused_body: bool = True,
                 fused_body_grad: Union[bool, str] = False,
                 remat: bool = False):
        super().__init__()
        if pad_mode not in ("reflect", "zero"):
            raise ValueError("pad_mode must be 'reflect' or 'zero'")
        if fused_body_grad not in (True, False, "auto"):
            raise ValueError("fused_body_grad must be True, False or 'auto'")
        f = base_features
        self.dtype, self.pad_mode, self.fused_body = dtype, pad_mode, fused_body
        self.fused_body_grad = fused_body_grad
        self.remat = remat
        zero = pad_mode == "zero"

        def pad(p):  # zero mode: the pad folds into the conv instead
            return nn.Identity() if zero else ReflectPad(p)

        head_pad = 3 if zero else 0
        self.model_head = nn.Sequential(
            pad(3), ConvTorch(input_nc, f, 7, padding=head_pad, dtype=dtype),
            InstanceNorm(), nn.ReLU(),
            ConvTorch(f, 2 * f, 3, stride=2, padding=1, dtype=dtype),
            InstanceNorm(), nn.ReLU(),
            ConvTorch(2 * f, 4 * f, 3, stride=2, padding=1, dtype=dtype),
            InstanceNorm(), nn.ReLU(),
        )
        self.model_body = nn.Sequential(*[
            ResidualBlock(4 * f, dtype=dtype, pad_mode=pad_mode)
            for _ in range(n_residual_blocks)
        ])
        self.model_tail = nn.Sequential(
            ConvTransposeTorch(4 * f, 2 * f, dtype=dtype), InstanceNorm(),
            nn.ReLU(),
            ConvTransposeTorch(2 * f, f, dtype=dtype), InstanceNorm(),
            nn.ReLU(),
            pad(3), ConvTorch(f, output_nc, 7, padding=head_pad, dtype=dtype),
            nn.Tanh(),
        )

    def reset_parameters(self, seed: int) -> "Generator":
        """Seeded PyTorch-default init of every conv, in module order."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (ConvTorch, ConvTransposeTorch)):
                m.reset_parameters(gen)
        return self

    def forward(self, x: torch.Tensor,
                fused_body: Optional[bool] = None) -> torch.Tensor:
        """x: (N, H, W, input_nc) -> (N, H, W, output_nc) in [-1, 1].
        ``fused_body`` picks the route for this call (default: the
        module's), on the same parameters: the trainer's eval forward."""
        if not all(getattr(blk, "whole", True) for blk in self.model_body):
            return self._forward_layers(x)  # split over tp ranks
        if sp_context() is not None:
            return self._forward_layers(x)  # a strip of sp ranks
        if self.fused_body if fused_body is None else fused_body:
            if self.pad_mode == "zero":
                # the model's layer route, on every device: JAX's chain_ok
                # leaves zero pad out of its fused body in the same way (the
                # kernels pad by reflection). Not a kernel's plain version
                # standing in for it: no kernel is asked for
                return self._forward_layers(x)
            return self._forward_fused(x)
        grad_route = (x.is_cuda if self.fused_body_grad == "auto"
                      else self.fused_body_grad)
        if grad_route and self.pad_mode == "reflect" and len(self.model_body):
            return self._forward_body_grad(x)
        return self._forward_layers(x)

    def _forward_layers(self, x):
        h = self.model_head(x)
        if self.remat and torch.is_grad_enabled():
            for blk in self.model_body:
                h = checkpoint(blk, h, use_reentrant=False)
        else:
            h = self.model_body(h)
        return self.model_tail(h)

    def _forward_body_grad(self, x):
        # plain head/downs and ups/tail, as JAX keeps them in XLA on the
        # training path; the body's custom VJP runs the K1/K4/K5 kernels
        h = self.model_head(x).to(self.dtype or x.dtype)
        params = [(blk.conv_block[1].hwio(), blk.conv_block[1].bias,
                   blk.conv_block[5].hwio(), blk.conv_block[5].bias)
                  for blk in self.model_body]
        return self.model_tail(fused_chain(h, params, eps=EPS))

    def _forward_fused(self, x):
        head, tail = self.model_head, self.model_tail

        def norm_of(stats, t):  # [sum, sum²] over t's H·W -> [mean, rstd]
            return _stats_to_norm(stats, float(t.shape[1] * t.shape[2]), EPS)

        # head conv, then its IN stats by one reduction over the raw output;
        # the normalize folds into down1's input read
        h = head[1](reflect_pad(x, 3)).to(self.dtype or x.dtype)
        norm = norm_of(channel_stats(h), h)
        for conv in (head[4], head[7]):
            h, s = conv3x3_s2_zero_stats(h, conv.hwio(), conv.bias,
                                         norm=norm, relu=True)
            norm = norm_of(s, h)
        params = [(blk.conv_block[1].hwio(), blk.conv_block[1].bias,
                   blk.conv_block[5].hwio(), blk.conv_block[5].bias)
                  for blk in self.model_body]
        h = fused_residual_chain(h, params, eps=EPS, in_norm=norm,
                                 in_relu=True)
        up1, up2 = tail[0], tail[3]
        h, s = convt2x_stats(h, up1.weight, up1.bias)
        h, s = convt2x_stats(h, up2.weight, up2.bias, norm=norm_of(s, h),
                             relu=True)
        h = apply_norm(h, norm_of(s, h), relu=True)
        return torch.tanh(tail[7](reflect_pad(h, 3)))
