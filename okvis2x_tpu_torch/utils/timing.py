"""Named hierarchical accumulating timers.

Replaces the reference's `okvis::timing::Timer/Timing` (okvis_timing/include/
okvis/timing/Timer.hpp:62-120): named accumulators with total/mean/min/max
and a rolling mean over the last 50 samples, printed as an indented tree.
Stage names use the reference's "N Stage" numbering convention so profiles
are comparable.  A process-wide kill switch (`enabled`) mirrors DO_TIMING.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

enabled = True


class _Acc:
    __slots__ = ("n", "total", "mn", "mx", "recent")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.mn = float("inf")
        self.mx = 0.0
        self.recent = collections.deque(maxlen=50)

    def add(self, dt: float):
        self.n += 1
        self.total += dt
        self.mn = min(self.mn, dt)
        self.mx = max(self.mx, dt)
        self.recent.append(dt)


_registry: Dict[str, _Acc] = {}


def add_sample(name: str, dt: float):
    """Record an externally measured duration under `name` (e.g. from a
    background thread that can't scope a Timer around its region)."""
    if not enabled:
        return
    if name not in _registry:
        _registry[name] = _Acc()
    _registry[name].add(dt)


class Timer:
    """Context manager / manual start-stop timer."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        if name not in _registry:
            _registry[name] = _Acc()

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None and enabled:
            _registry[self.name].add(time.perf_counter() - self._t0)
            self._t0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def report() -> str:
    lines = ["timing (name: n, total[s], mean[ms], min[ms], max[ms], roll50[ms])"]
    for name in sorted(_registry):
        a = _registry[name]
        if a.n == 0:
            continue
        roll = sum(a.recent) / len(a.recent) if a.recent else 0.0
        lines.append(
            f"  {name}: {a.n}, {a.total:.3f}, {a.total / a.n * 1e3:.2f}, "
            f"{a.mn * 1e3:.2f}, {a.mx * 1e3:.2f}, {roll * 1e3:.2f}"
        )
    return "\n".join(lines)


def reset():
    _registry.clear()


def mean_ms(name: str) -> float:
    a = _registry.get(name)
    return (a.total / a.n * 1e3) if a and a.n else 0.0
