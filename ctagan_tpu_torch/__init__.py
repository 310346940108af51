"""ctagan_tpu_torch — the PyTorch + CUDA port of ``ctagan_tpu``.

A second package beside the JAX reference, for NVIDIA Hopper GPUs. It keeps
the JAX package's NHWC layout and function names at its public functions,
and replaces each Pallas TPU kernel with a hand-written CUDA kernel
(``csrc/``, built by ``ops/_build.py``) that has a plain PyTorch version
beside it. It imports ``torch`` and numpy, and nothing of JAX or of the JAX
package.

- ``ctagan_tpu_torch.data``    — the DICOM codec, host preprocessing, the
  dual-window dataset and the prefetching loader.
- ``ctagan_tpu_torch.models``  — ``Generator``, ``RegNet``,
  ``Discriminator``, their NHWC layers and the JAX-param converters.
- ``ctagan_tpu_torch.ops``     — the fused conv kernels K1-K3, the residual
  body's backward kernels K4-K5, and the plain ops of the training step and
  the eval path (warp, augmentation, losses, resize, windowing, metrics,
  LPIPS).
- ``ctagan_tpu_torch.parallel`` — whole-series inference (an SE0 series in,
  an SE2 series out) and the data-parallel plan (its process group, the
  plan a config asks for).
- ``ctagan_tpu_torch.serving`` — the HTTP synthesis service and the
  exported generator artifact.
- ``ctagan_tpu_torch.train``   — the HD stage-1 step and trainer (train,
  validate, checkpoints, resume, test() with the SE2 DICOM writeback).
- ``ctagan_tpu_torch.utils``   — the config reader, the checkpoints (the
  port's, and the JAX package's flax msgpack files through a pure-Python
  decoder) and the PNG figures.
"""

__version__ = "0.1.0"
