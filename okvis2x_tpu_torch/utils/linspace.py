"""Evenly spaced values as the JAX package's compiled programs compute them.

XLA folds ``jnp.linspace(a, b, n)`` inside a jitted program to
``a * (1 - s) + b * s`` with ``s = i * (1 / (n - 1))`` in the working
precision, the last value ``b`` itself.  ``torch.linspace`` steps from both
ends instead, and in float32 the two differ in the last bit for a third of
the entries: enough to move a ray sample across a voxel boundary.
"""

from __future__ import annotations

import torch


def linspace(start: float, stop: float, num: int, dtype=torch.float32, device=None):
    """`num` values from `start` to `stop` inclusive."""
    if num == 1:
        return torch.tensor([start], dtype=dtype, device=device)
    r = torch.tensor(1.0 / (num - 1), dtype=dtype, device=device)
    s = torch.arange(num - 1, dtype=dtype, device=device) * r
    a = torch.tensor(start, dtype=dtype, device=device)
    b = torch.tensor(stop, dtype=dtype, device=device)
    return torch.cat([a * (1 - s) + b * s, b[None]])
