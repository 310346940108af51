"""ctagan_tpu_torch — the PyTorch + CUDA port of ``ctagan_tpu``.

A second package beside the JAX reference, for NVIDIA Hopper GPUs. It keeps
the JAX package's NHWC layout and function names at its public functions,
and replaces each Pallas TPU kernel with a hand-written CUDA kernel
(``csrc/``, built by ``ops/_build.py``) that has a plain PyTorch version
beside it. It imports ``torch`` and numpy, and nothing of JAX or of the JAX
package.

- ``ctagan_tpu_torch.data``    — the DICOM codec and host preprocessing.
- ``ctagan_tpu_torch.models``  — ``Generator`` and its NHWC layers, the
  JAX-param converter.
- ``ctagan_tpu_torch.ops``     — the fused conv kernels K1-K3.
- ``ctagan_tpu_torch.serving`` — the HTTP synthesis service.
- ``ctagan_tpu_torch.utils``   — the config reader.
"""

__version__ = "0.1.0"
