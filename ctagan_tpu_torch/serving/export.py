"""Deployable generator artifacts of the port (``ctagan_tpu/serving/
export.py``): the generator without its model code.

The JAX package writes one file (a JSON header, the ``jax.export``-lowered
generator and its params). The port writes the same header and a
``torch.export`` program of the generator, its weights inside, under a
magic of its own::

    b"CTPT1\\n" | u64 len | JSON header | u64 len | torch.export.save bytes

The header holds ``size``, ``channels``, ``batch`` (null: the batch axis is
symbolic and one artifact serves any batch), ``platforms`` (the device type
the program was exported on, which is where it loads), ``fingerprint`` (the
model's class) and ``torch``, the exporting version. :func:`load_exported`
needs only ``torch``: it imports no module of the port.

The program is the generator's plain layer route: ``fused_body`` and
``fused_body_grad`` are turned off before export, as JAX turns its fused
paths off (their kernels are one platform's and gate on the batch, which is
symbolic here). So no hand-written kernel is in the artifact; the kernels
serve the series-inference, test and HTTP paths.
"""
from __future__ import annotations

import io
import json
import struct
from typing import Callable, Dict, Optional, Tuple

import torch

HEADER_MAGIC = b"CTPT1\n"
JAX_MAGIC = b"CTAX1\n"  # the JAX package's artifact: a jax.export program


def export_generator(model: torch.nn.Module, path: str, size: int = 512,
                     channels: int = 1, batch: Optional[int] = None) -> str:
    """``torch.export`` the generator's plain route for (batch, size, size,
    channels) f32 NHWC input on the model's device and write the artifact
    to ``path``. ``batch=None`` exports a symbolic batch; an int pins
    it."""
    import copy

    m = copy.deepcopy(model)
    for flag in ("fused_body", "fused_body_grad"):
        if hasattr(m, flag):
            setattr(m, flag, False)
    m = m.eval().requires_grad_(False)
    dev = next(m.parameters()).device
    # an example batch of 2: torch.export specializes a dimension of 1
    example = torch.zeros((2 if batch is None else batch, size, size,
                           channels), dtype=torch.float32, device=dev)
    dynamic = None
    if batch is None:
        dynamic = ({0: torch.export.Dim("batch", min=1, max=4096)},)
    with torch.no_grad():
        prog = torch.export.export(m, (example,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(prog, buf)
    header = json.dumps({
        "size": size, "channels": channels, "batch": batch,
        "platforms": [dev.type], "fingerprint": type(model).__name__,
        "torch": torch.__version__}).encode()
    with open(path, "wb") as f:
        f.write(HEADER_MAGIC)
        for part in (header, buf.getvalue()):
            f.write(struct.pack("<Q", len(part)))
            f.write(part)
    return path


def load_exported(path: str) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                                      Dict]:
    """An artifact -> (callable(x) -> y on NHWC tensors, header dict). A
    JAX ``.ctax`` artifact is refused: its program is StableHLO for the JAX
    package's loader."""
    with open(path, "rb") as f:
        magic = f.read(len(HEADER_MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path} is the JAX package's artifact (a jax.export "
                "StableHLO program and flax params): load it with "
                "ctagan_tpu.serving.export.load_exported; export the port's "
                "with `python -m ctagan_tpu_torch --mode export`")
        if magic != HEADER_MAGIC:
            raise ValueError(f"{path}: not a generator artifact")
        parts = []
        for _ in range(2):
            (n,) = struct.unpack("<Q", f.read(8))
            parts.append(f.read(n))
    header = json.loads(parts[0].decode())
    prog = torch.export.load(io.BytesIO(parts[1]))
    module = prog.module()

    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(x)

    return fn, header
