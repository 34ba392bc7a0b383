"""One lock for every ``torch.func`` transform of the port, and `lift`.

The levels of forward-mode AD (``jacfwd``, ``jvp``) are process-wide state
in PyTorch: two threads inside a transform at once release each other's
levels ("Trying to access a forward AD level with an invalid index").  The
frame thread's window solve and the background pose-graph solve
(``graph/fullgraph.py``) both linearise through ``jacfwd``, so every
transform call holds `LOCK` and the two take turns, one linearisation at a
time.
"""

import threading

import torch

LOCK = threading.RLock()

# Under forward-mode AD (PyTorch 2.11 and 2.13) a binary arithmetic op between a
# tensor that carries a tangent and an operand that carries none (a tensor
# from outside the transform, one computed from such tensors only, or a
# Python number) runs through Python reference implementations
# (``torch._refs``), many times slower than the op itself; the host-bound
# linearisations are full of such ops (constant poses, camera parameters,
# literals).  `lift` gives such an operand a zero tangent first, so the ops
# that follow stay in C++; the values are the same bit for bit.
_FALSE = {}


def _false(device):
    if device not in _FALSE:
        _FALSE[device] = torch.zeros((), dtype=torch.bool, device=device)
    return _FALSE[device]


def lift(x, like: torch.Tensor):
    """`x` (a tensor or a number) with a zero tangent at the transform level
    of `like` when `like` is inside a ``torch.func`` transform (`x` keeps its
    tangent if it has one); else `x` itself.  Keeps `x`'s dtype (a number
    takes `like`'s)."""
    if torch._C._functorch.maybe_get_level(like) < 0 or like.numel() == 0:
        return x
    like0 = like.reshape(-1)[0]
    if torch.is_tensor(x) and x.dtype != like0.dtype:
        like0 = like0.to(x.dtype)
    return torch.where(_false(like.device), like0, x)
