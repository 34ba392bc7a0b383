"""Occupancy submaps: dense log-odds voxel grids on the device (torch
counterpart of the dense half of ``okvis2x_tpu/mapping/submap.py``).

A submap is a D^3 grid at `res` metres (default 128^3 at 0.2 m) centred on
the keyframe that anchors it (T_WK).  Depth rays are integrated by
scattering their samples into voxels (``index_add_``): free-space samples
from the sensor to the surface band, then a signed band profile
(free before the surface, 0 at it, occupied behind it), scaled down for
noisy measurements; each voxel takes the mean of this integration's samples,
clipped to [log_odd_min, log_odd_max], and counts them in `weight`.
Trilinear interpolation and its gradient read the field back; `observed_mask`
and `occupied_point_list` serve the overlap test and the export.

The grid holds float32.  The ray geometry runs in the camera's dtype (the
app's cameras are float64), with float32 inputs (depth, T_KC) promoted, as
the JAX package's does under x64; the updates are float32.

Fine resolutions use the brick-sparse grid of ``mapping/brick.py``: the
functions below take either config (a `BrickConfig` has a `table_dim`) and
dispatch on it, as the JAX package's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.utils.linspace import linspace


class SubmapConfig(NamedTuple):
    dim: int = 128  # voxels per side
    res: float = 0.2  # metres per voxel
    log_odd_occ: float = 0.85  # per-hit increment
    log_odd_free: float = -0.25  # per-pass decrement
    log_odd_min: float = -5.0
    log_odd_max: float = 5.0
    surface_band: float = 0.3  # metres: half-width of the occupied band
    samples_per_ray: int = 48  # free-space samples along each ray
    band_samples: int = 8  # surface-band samples


class Submap(NamedTuple):
    T_WK: torch.Tensor  # (7,) anchor pose, re-anchored on loop closure
    logodds: torch.Tensor  # (D, D, D)
    weight: torch.Tensor  # (D, D, D) integration counts


def is_brick(cfg) -> bool:
    return hasattr(cfg, "table_dim")


def _brick():
    from okvis2x_tpu_torch.mapping import brick

    return brick


def new_submap(T_WK, cfg, dtype=torch.float32, device=None):
    """A submap of the grid config: dense `SubmapConfig`, or brick-sparse
    `mapping.brick.BrickConfig`."""
    if is_brick(cfg):
        return _brick().new_submap(T_WK, cfg, dtype, device)
    D = cfg.dim
    return Submap(T_WK=torch.as_tensor(T_WK, dtype=dtype, device=device).clone(),
                  logodds=torch.zeros((D, D, D), dtype=dtype, device=device),
                  weight=torch.zeros((D, D, D), dtype=dtype, device=device))


def _world_to_voxel(cfg: SubmapConfig, p_K: torch.Tensor) -> torch.Tensor:
    """Submap-frame metres -> continuous voxel coordinates (centred grid)."""
    half = cfg.dim * cfg.res / 2.0
    return (p_K + half) / cfg.res - 0.5


def _in_bounds(cfg: SubmapConfig, v: torch.Tensor) -> torch.Tensor:
    return ((v >= 0.0) & (v <= cfg.dim - 1.001)).all(dim=-1)


def _flat(cfg: SubmapConfig, vi: torch.Tensor) -> torch.Tensor:
    d = cfg.dim
    return (vi[..., 0] * d + vi[..., 1]) * d + vi[..., 2]


def _nearest(cfg: SubmapConfig, p_K: torch.Tensor):
    """(integer voxel (..., 3) clipped to the grid, in bounds (...))."""
    v = _world_to_voxel(cfg, p_K)
    return torch.clamp(torch.round(v).to(torch.int64), 0, cfg.dim - 1), _in_bounds(cfg, v)


def _ray_samples(cfg: SubmapConfig, origin_K, end_K, valid, sigma, dtype):
    """Sample points (N, S+B, 3) of each ray (in the rays' dtype) with
    their log-odds updates (N, S+B) in `dtype` and validity (N, S+B):
    `samples_per_ray` free-space samples
    from the origin to range - band, then `band_samples` band samples from
    range - band (free) to range + band / 2 (occupied), zero at the surface;
    updates scaled by clip(0.1 / sigma, 0.05, 1)."""
    d = end_K - origin_K[None, :]
    rng = torch.linalg.norm(d, dim=-1, keepdim=True)
    dirn = d / torch.clamp(rng, min=1e-9)
    S, B, band = cfg.samples_per_ray, cfg.band_samples, cfg.surface_band
    dev = end_K.device
    fr = linspace(0.0, 1.0, S, dtype=dtype, device=dev)
    depth_f = fr[None, :] * torch.clamp(rng - band, min=0.0)
    u = linspace(-1.0, 0.5, B, dtype=dtype, device=dev)
    depth_b = rng + band * u[None, :]
    upd_b = torch.where(u < 0, cfg.log_odd_free * (-u), cfg.log_odd_occ * (u / 0.5))
    depth = torch.cat([depth_f, depth_b], dim=1)
    pts = origin_K[None, None, :] + dirn[:, None, :] * depth[..., None]
    upd = torch.cat([torch.full((S,), cfg.log_odd_free, dtype=dtype, device=dev), upd_b])
    sig_scale = torch.clamp(0.1 / torch.clamp(torch.as_tensor(sigma, dtype=dtype, device=dev),
                                              min=1e-3), 0.05, 1.0)
    if sig_scale.ndim > 0:
        sig_scale = sig_scale.reshape(-1, 1)
    upd = (upd[None, :] * sig_scale).expand(pts.shape[:2])
    ok = valid[:, None].expand_as(upd)
    return pts, upd, ok


def integrate_rays(sm, cfg, origin_K: torch.Tensor, end_K: torch.Tensor, valid: torch.Tensor,
                   sigma=0.1):
    """Batch ray integration, nearest-voxel: each voxel moves by the mean
    of this batch's updates in it, then clipped; `weight` counts them."""
    if is_brick(cfg):
        return _brick().integrate_rays(sm, cfg, origin_K, end_K, valid, sigma)
    pts, upd, ok = _ray_samples(cfg, origin_K, end_K, valid, sigma, sm.logodds.dtype)
    vi, inb = _nearest(cfg, pts)
    ok = (inb & ok).reshape(-1)
    flat = _flat(cfg, vi).reshape(-1)
    okf = ok.to(sm.logodds.dtype)
    upd = torch.where(ok, upd.reshape(-1), torch.zeros_like(okf))
    lo = sm.logodds.reshape(-1)
    sum_upd = torch.zeros_like(lo).index_add_(0, flat, upd)
    cnt = torch.zeros_like(lo).index_add_(0, flat, okf)
    lo = torch.clamp(lo + sum_upd / torch.clamp(cnt, min=1.0), cfg.log_odd_min, cfg.log_odd_max)
    w = sm.weight.reshape(-1) + cnt
    D = cfg.dim
    return sm._replace(logodds=lo.reshape(D, D, D), weight=w.reshape(D, D, D))


def depth_rays(cam: pinhole.Camera, T_KC: torch.Tensor, depth: torch.Tensor, stride: int,
               max_depth: float):
    """The rays of a strided pixel grid (rows outer) of an (H, W) depth
    image: (origin (3,), end points (N, 3) in the submap frame, valid
    (N,))."""
    H, W = depth.shape
    dev = depth.device
    gdt = cam.fxfycxcy.dtype
    ys = torch.arange(0, H, stride, device=dev)
    xs = torch.arange(0, W, stride, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    uv = torch.stack([xx, yy], dim=-1).reshape(-1, 2).to(gdt)
    d = depth[::stride, ::stride].reshape(-1)
    ray, bp_ok = pinhole.back_project(cam.to(device=dev), uv)
    p_C = ray / ray[..., 2:3] * d[:, None].to(gdt)
    T_KC = T_KC.to(gdt)
    valid = bp_ok & (d > 0.05) & (d < max_depth) & torch.isfinite(d)
    return se3.se3_t(T_KC), se3.se3_apply(T_KC, p_C), valid


def integrate_depth_image(sm, cfg, cam: pinhole.Camera, T_KC: torch.Tensor, depth: torch.Tensor,
                          sigma: torch.Tensor, stride: int = 4, max_depth: float = 20.0):
    """Back-project a strided pixel grid of a metric depth image (0 / inf
    invalid) taken at camera pose T_KC and integrate its rays, sigma-aware."""
    origin, p_K, valid = depth_rays(cam, T_KC, depth, stride, max_depth)
    sg = sigma[::stride, ::stride].reshape(-1)
    return integrate_rays(sm, cfg, origin, p_K, valid, sg)


def _corners(cfg: SubmapConfig, sm: Submap, p_K: torch.Tensor):
    """The 8 trilinear corner values g[dx][dy][dz] (...), the fractions
    (..., 3) and the in-bounds mask of points (..., 3)."""
    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    v = torch.clamp(v, 0.0, cfg.dim - 1.001)
    v0 = torch.floor(v).to(torch.int64)
    f = v - v0
    lo = sm.logodds
    g = [[[lo[v0[..., 0] + dx, v0[..., 1] + dy, v0[..., 2] + dz] for dz in (0, 1)]
          for dy in (0, 1)] for dx in (0, 1)]
    return g, f, ok


def _trilinear(g, f, ok):
    """The trilinear value of corners g[dx][dy][dz] at fractions f (..., 3),
    0 where not ok."""
    fx, fy, fz = f.unbind(-1)
    c00 = g[0][0][0] * (1 - fx) + g[1][0][0] * fx
    c10 = g[0][1][0] * (1 - fx) + g[1][1][0] * fx
    c01 = g[0][0][1] * (1 - fx) + g[1][0][1] * fx
    c11 = g[0][1][1] * (1 - fx) + g[1][1][1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    val = c0 * (1 - fz) + c1 * fz
    return torch.where(ok, val, torch.zeros_like(val)), ok


def _trilinear_grad(g, f, ok, res: float):
    """The gradient of the trilinear field of corners g in metres (voxels
    of `res`), 0 where not ok."""
    fx, fy, fz = f.unbind(-1)
    dx = ((g[1][0][0] - g[0][0][0]) * (1 - fy) * (1 - fz)
          + (g[1][1][0] - g[0][1][0]) * fy * (1 - fz)
          + (g[1][0][1] - g[0][0][1]) * (1 - fy) * fz
          + (g[1][1][1] - g[0][1][1]) * fy * fz)
    dy = ((g[0][1][0] - g[0][0][0]) * (1 - fx) * (1 - fz)
          + (g[1][1][0] - g[1][0][0]) * fx * (1 - fz)
          + (g[0][1][1] - g[0][0][1]) * (1 - fx) * fz
          + (g[1][1][1] - g[1][0][1]) * fx * fz)
    dz = ((g[0][0][1] - g[0][0][0]) * (1 - fx) * (1 - fy)
          + (g[1][0][1] - g[1][0][0]) * fx * (1 - fy)
          + (g[0][1][1] - g[0][1][0]) * (1 - fx) * fy
          + (g[1][1][1] - g[1][1][0]) * fx * fy)
    grad = torch.stack([dx, dy, dz], dim=-1) / res
    return torch.where(ok[..., None], grad, torch.zeros_like(grad)), ok


def interp_occupancy(sm, cfg, p_K: torch.Tensor):
    """Trilinear log-odds at (..., 3) submap-frame points: (value, inside);
    0 outside the grid."""
    if is_brick(cfg):
        return _brick().interp_occupancy(sm, cfg, p_K)
    return _trilinear(*_corners(cfg, sm, p_K))


def grad_occupancy(sm, cfg, p_K: torch.Tensor):
    """Gradient of the trilinear field with respect to the metric position
    (..., 3): (gradient, inside); 0 outside the grid."""
    if is_brick(cfg):
        return _brick().grad_occupancy(sm, cfg, p_K)
    return _trilinear_grad(*_corners(cfg, sm, p_K), cfg.res)


def observed_mask(sm, cfg, p_K: torch.Tensor) -> torch.Tensor:
    """(...) bool: the point lands in a voxel with integration weight > 0."""
    if is_brick(cfg):
        return _brick().observed_mask(sm, cfg, p_K)
    vi, ok = _nearest(cfg, p_K)
    return (sm.weight[vi[..., 0], vi[..., 1], vi[..., 2]] > 0) & ok


def occupied_point_list(sm, cfg, threshold: float = 1.0, max_points: int = 4096):
    """The first `max_points` occupied voxel centres (submap frame, flat
    index order), zero-padded: ((max_points, 3), valid (max_points,))."""
    if is_brick(cfg):
        return _brick().occupied_point_list(sm, cfg, threshold, max_points)
    occ = (sm.logodds > threshold).reshape(-1)
    idx = torch.nonzero(occ)[:max_points, 0]
    n = idx.shape[0]
    D = cfg.dim
    vi = torch.stack([idx // (D * D), (idx // D) % D, idx % D], dim=-1)
    centres = torch.zeros((max_points, 3), dtype=sm.logodds.dtype, device=occ.device)
    centres[:n] = (vi.to(sm.logodds.dtype) + 0.5) * cfg.res - D * cfg.res / 2.0
    valid = torch.arange(max_points, device=occ.device) < n
    return centres, valid


def occupied_points(sm: Submap, cfg: SubmapConfig, threshold: float = 1.0):
    """All voxel centres (D^3, 3) in the submap frame and the occupied mask
    (D^3,) of a dense grid."""
    D = cfg.dim
    idx = torch.arange(D, device=sm.logodds.device)
    g = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1).reshape(-1, 3)
    centres = (g.to(sm.logodds.dtype) + 0.5) * cfg.res - cfg.dim * cfg.res / 2.0
    return centres, (sm.logodds > threshold).reshape(-1)
