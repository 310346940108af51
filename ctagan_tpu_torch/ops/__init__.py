"""The port's kernels and plain ops. Each kernel module holds its CUDA
kernels' wrappers, their plain PyTorch versions and launch counters
(``fused_resblock`` K1, ``fused_convt`` K2, ``fused_down`` K3,
``fused_resblock_grad`` K4 and K5); ``_build`` compiles and loads
``csrc/``. ``warp``, ``augment``, ``losses``, ``resize`` and ``windowing``
are the training step's plain tensor ops."""
