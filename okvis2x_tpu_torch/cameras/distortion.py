"""Lens distortion models (torch).

Counterpart of ``okvis2x_tpu/cameras/distortion.py``: each model is a pair of
functions on normalised image coordinates,

    distort(params, xy)   -> distorted xy
    undistort(params, xy) -> undistorted xy   (fixed-count Newton solve)

Parameter layouts (trailing axis of `params`):
    radtan      : [k1, k2, p1, p2]
    radtan8     : [k1, k2, p1, p2, k3, k4, k5, k6]
    equidistant : [k1, k2, k3, k4]
    none        : []
"""

from __future__ import annotations

import torch

from okvis2x_tpu_torch.utils import forward_ad

RADTAN = "radtan"
RADTAN8 = "radtan8"
EQUIDISTANT = "equidistant"
NONE = "none"

NUM_PARAMS = {RADTAN: 4, RADTAN8: 8, EQUIDISTANT: 4, NONE: 0}

_UNDISTORT_ITERS = 7


def _distort_radtan(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def _distort_radtan8(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k3, k4, k5, k6 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def _distort_equidistant(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    k1, k2, k3, k4 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-24))
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = torch.where(r > 1e-8, theta_d / r, torch.ones_like(r))
    return xy * scale[..., None]


def _distort_none(params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    del params
    return xy


_DISTORT = {
    RADTAN: _distort_radtan,
    RADTAN8: _distort_radtan8,
    EQUIDISTANT: _distort_equidistant,
    NONE: _distort_none,
}


def distort(model: str, params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply the distortion model to normalised coordinates, shape (..., 2)."""
    return _DISTORT[model](params, xy)


def undistort(model: str, params: torch.Tensor, xy_d: torch.Tensor) -> torch.Tensor:
    """Invert `distort` by a fixed count of per-point 2x2 Newton steps; the
    Jacobian columns come from forward-mode derivatives along x and y."""
    if model == NONE:
        return xy_d
    fwd = _DISTORT[model]
    f = lambda p: fwd(params, p)  # noqa: E731
    xy = xy_d
    for _ in range(_UNDISTORT_ITERS):
        e0 = torch.zeros_like(xy)
        e0[..., 0] = 1.0
        e1 = torch.zeros_like(xy)
        e1[..., 1] = 1.0
        with forward_ad.LOCK:
            val, Jc0 = torch.func.jvp(f, (xy,), (e0,))
            _, Jc1 = torch.func.jvp(f, (xy,), (e1,))
        r = val - xy_d
        a, b = Jc0[..., 0], Jc1[..., 0]
        c, d = Jc0[..., 1], Jc1[..., 1]
        det = a * d - b * c
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        dx = (d * r[..., 0] - b * r[..., 1]) / det
        dy = (-c * r[..., 0] + a * r[..., 1]) / det
        xy = xy - torch.stack([dx, dy], dim=-1)
    return xy
