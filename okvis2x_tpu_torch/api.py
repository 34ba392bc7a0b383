"""Public estimator API types (the subset the VIO slice publishes)."""

from __future__ import annotations

import enum


class TrackingQuality(enum.Enum):
    GOOD = 0
    MARGINAL = 1
    LOST = 2
