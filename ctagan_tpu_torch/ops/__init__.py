"""The port's kernels and plain ops. Each kernel module holds its CUDA
kernels' wrappers, their plain PyTorch versions and launch counters
(``fused_resblock`` K1, ``fused_convt`` K2, ``fused_down`` K3,
``fused_resblock_grad`` K4 and K5, ``pallas_kernels`` K6, ``fused_s8`` K7);
``_build`` compiles and loads ``csrc/``. ``quantize`` is the int8 serving
forward; ``warp``, ``augment``, ``losses``, ``resize`` and ``windowing`` are
the training step's plain tensor ops; ``registration3d`` is the offline
corpus stage's 3-D demons registrar, in plain PyTorch (JAX computes it
outside Pallas)."""
from ctagan_tpu_torch.ops.registration3d import (
    compose,
    demons_register,
    exp_field,
    smooth3d,
    warp3d,
)
