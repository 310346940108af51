"""CycleGAN's history pool of the port (``ctagan_tpu/train/replay_buffer.py``).

The reference's ``ReplayBuffer`` keeps 50 earlier fakes: until the pool is
full each new fake is stored and passed on; once it is full, a coin draw
> 0.5 swaps the new fake with a uniformly drawn stored one and passes the old
one on, else the new one passes through. Here the pool is a tensor on the
state's device and the draws come from an explicit ``torch.Generator``: the
policy is JAX's, the numbers are not (JAX draws from threefry keys).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ReplayBuffer:
    data: torch.Tensor  # (max_size, H, W, C)
    size: int = 0

    @staticmethod
    def create(max_size: int, shape, dtype=torch.float32,
               device=None) -> "ReplayBuffer":
        return ReplayBuffer(torch.zeros((max_size, *shape), dtype=dtype,
                                        device=device))


def push_and_pop(buf: ReplayBuffer, items: torch.Tensor,
                 gen: torch.Generator) -> torch.Tensor:
    """Offer each of ``items`` (B, H, W, C) to the pool in order, updating
    ``buf`` in place; returns the (B, H, W, C) batch D trains on. Every
    element takes one coin draw and one slot draw from ``gen``, whether or
    not the pool is full, as JAX's scan draws both per element."""
    max_size = buf.data.shape[0]
    out = []
    for item in items:
        coin = float(torch.rand((), generator=gen)) > 0.5
        idx = int(torch.randint(0, max_size, (), generator=gen))
        if buf.size < max_size:
            buf.data[buf.size] = item
            buf.size += 1
            out.append(item)
        elif coin:
            out.append(buf.data[idx].to(items.dtype, copy=True))
            buf.data[idx] = item
        else:
            out.append(item)
    return torch.stack(out)
