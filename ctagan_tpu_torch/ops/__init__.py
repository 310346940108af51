"""The port's kernels: each module holds one CUDA kernel's wrapper, its
plain PyTorch version and its launch counter (``fused_resblock`` K1,
``fused_convt`` K2, ``fused_down`` K3); ``_build`` compiles and loads
``csrc/``."""
