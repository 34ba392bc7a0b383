"""One lock for every ``torch.func`` transform of the port.

The levels of forward-mode AD (``jacfwd``, ``jvp``) are process-wide state
in PyTorch: two threads inside a transform at once release each other's
levels ("Trying to access a forward AD level with an invalid index").  The
frame thread's window solve and the background pose-graph solve
(``graph/fullgraph.py``) both linearise through ``jacfwd``, so every
transform call holds `LOCK` and the two take turns, one linearisation at a
time.
"""

import threading

LOCK = threading.RLock()
