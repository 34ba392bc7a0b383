"""Pinhole camera model with pluggable distortion (torch).

Counterpart of ``okvis2x_tpu/cameras/pinhole.py``:

    project(cam, p_C)       -> (uv, valid)   camera-frame points -> pixels
    back_project(cam, uv)   -> (ray, valid)  pixels -> rays with z = 1

A `Camera` carries intrinsics [fx, fy, cx, cy], distortion parameters,
image size and the model name: a distortion model of ``distortion.py``, or
``"eucm"`` (extended unified camera model, dist_params = [alpha, beta]).
Invalid projections still give finite values; callers mask with `valid`.
"""

from __future__ import annotations

import dataclasses

import torch

from okvis2x_tpu_torch.cameras import distortion as dist
from okvis2x_tpu_torch.utils import forward_ad

EUCM = "eucm"


@dataclasses.dataclass(frozen=True)
class Camera:
    """fxfycxcy: (..., 4); dist_params: (..., P)."""

    fxfycxcy: torch.Tensor
    dist_params: torch.Tensor
    width: int
    height: int
    model: str = dist.RADTAN  # distortion model name or "eucm"

    def to(self, device=None, dtype=None) -> "Camera":
        return dataclasses.replace(
            self,
            fxfycxcy=self.fxfycxcy.to(device=device, dtype=dtype),
            dist_params=self.dist_params.to(device=device, dtype=dtype),
        )


def make_pinhole(
    fx, fy, cx, cy, width, height, model=dist.RADTAN, dist_params=(),
    dtype=torch.float64, device=None,
) -> Camera:
    if model not in dist.NUM_PARAMS and model != EUCM:
        raise ValueError(f"unknown camera model {model!r}")
    p = torch.as_tensor(list(dist_params), dtype=dtype, device=device)
    if p.numel() == 0:
        p = torch.zeros((dist.NUM_PARAMS.get(model, 0),), dtype=dtype, device=device)
    return Camera(
        fxfycxcy=torch.tensor([fx, fy, cx, cy], dtype=dtype, device=device),
        dist_params=p,
        width=int(width),
        height=int(height),
        model=model,
    )


def _eucm_project_normalized(dist_params, p):
    alpha, beta = dist_params[..., 0], dist_params[..., 1]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = torch.sqrt(torch.clamp(beta * (x * x + y * y) + z * z, min=1e-24))
    denom = alpha * d + (1.0 - alpha) * z
    safe = denom.abs() > 1e-12
    denom = torch.where(safe, denom, torch.full_like(denom, 1e-12))
    m = torch.stack([x / denom, y / denom], dim=-1)
    # projection domain: z > -w d with w from alpha
    w = torch.where(alpha <= 0.5, alpha / (1.0 - alpha), (1.0 - alpha) / alpha)
    return m, safe & (z > -w * d)


def _eucm_back_project_normalized(dist_params, m):
    alpha, beta = dist_params[..., 0], dist_params[..., 1]
    mx, my = m[..., 0], m[..., 1]
    r2 = mx * mx + my * my
    under = 1.0 - (2.0 * alpha - 1.0) * beta * r2
    valid = under >= 0.0
    mz = (1.0 - beta * alpha * alpha * r2) / (
        alpha * torch.sqrt(torch.clamp(under, min=0.0)) + (1.0 - alpha)
    )
    return torch.stack([mx, my, mz], dim=-1), valid


def project(cam: Camera, p_C: torch.Tensor):
    """Project camera-frame points (..., 3) to pixels (..., 2), with validity."""
    fx, fy, cx, cy = forward_ad.lift(cam.fxfycxcy, p_C).unbind(-1)
    if cam.model == EUCM:
        m, z_ok = _eucm_project_normalized(cam.dist_params, p_C)
    else:
        z = p_C[..., 2]
        z_ok = z > 1e-6
        z_safe = torch.where(z_ok, z, torch.ones_like(z))
        xy = p_C[..., :2] / z_safe[..., None]
        m = dist.distort(cam.model, cam.dist_params, xy)
    u = fx * m[..., 0] + cx
    v = fy * m[..., 1] + cy
    uv = torch.stack([u, v], dim=-1)
    in_img = (
        (u >= -0.5) & (u <= cam.width - 0.5) & (v >= -0.5) & (v <= cam.height - 0.5)
    )
    return uv, z_ok & in_img


def back_project(cam: Camera, uv: torch.Tensor):
    """Pixels (..., 2) -> rays (..., 3) with z = 1 (unnormalised for EUCM),
    plus validity (the re-distorted point must reproduce the pixel)."""
    fx, fy, cx, cy = cam.fxfycxcy.unbind(-1)
    m = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    if cam.model == EUCM:
        return _eucm_back_project_normalized(cam.dist_params, m)
    xy = dist.undistort(cam.model, cam.dist_params, m)
    ray = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    err = torch.linalg.norm(dist.distort(cam.model, cam.dist_params, xy) - m, dim=-1)
    return ray, err < 1e-6


def project_homogeneous(cam: Camera, hp_C: torch.Tensor):
    """Project homogeneous camera-frame points [x,y,z,w] (w may be 0)."""
    w = hp_C[..., 3]
    p = torch.where(w[..., None] >= 0, hp_C[..., :3], -hp_C[..., :3])
    return project(cam, p)
