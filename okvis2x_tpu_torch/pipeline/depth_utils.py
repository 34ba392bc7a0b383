"""Depth-map conversion and registration helpers (torch counterpart of
``okvis2x_tpu/pipeline/depth_utils.py``, the reference's DepthUtils):
raw <-> metric depth, disparity <-> depth, back-projection of a depth map,
re-registration of a depth image from one camera into another's image
plane, and the sparse depth map of tracked landmarks.

Registration back-projects every source pixel, transforms and projects it,
and resolves collisions with a scatter-min z-buffer
(``scatter_reduce(..., "amin")``): the nearest surface wins.  Unmapped
target pixels are 0 (invalid).
"""

from __future__ import annotations

import torch

from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.cameras.pinhole import Camera
from okvis2x_tpu_torch.core import se3


def input_depth_to_meters(raw: torch.Tensor, scale: float = 1e-3) -> torch.Tensor:
    """uint16 (or float) sensor depth -> float32 metres; non-positive = 0."""
    d = raw.to(torch.float32) * scale
    return torch.where(d > 0, d, torch.zeros_like(d))


def meters_to_input_depth(depth_m: torch.Tensor, scale: float = 1e-3) -> torch.Tensor:
    """Metres -> sensor units in [0, 65535] (int32: torch has no uint16
    arithmetic on every device)."""
    return torch.clamp(torch.round(depth_m / scale), 0, 65535).to(torch.int32)


def disparity_to_depth(disp: torch.Tensor, fx: float, baseline: float) -> torch.Tensor:
    """Stereo disparity [px] -> metric depth; 0 where disp <= 0."""
    safe = torch.clamp(disp, min=1e-6)
    return torch.where(disp > 0, fx * baseline / safe, torch.zeros_like(disp))


def depth_sigma_from_disparity(disp, disp_sigma, fx: float, baseline: float) -> torch.Tensor:
    """First-order sigma_z = z^2 / (fx b) * sigma_d; 0 where disp <= 0."""
    z = disparity_to_depth(disp, fx, baseline)
    return torch.where(disp > 0, z * z / (fx * baseline) * disp_sigma, torch.zeros_like(z))


def depth_to_points(depth: torch.Tensor, cam: Camera):
    """Back-project an (H, W) metric depth map: ((H*W, 3) camera-frame
    points with p_z == depth, (H*W,) valid)."""
    H, W = depth.shape
    v, u = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                          torch.arange(W, dtype=depth.dtype, device=depth.device),
                          indexing="ij")
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    rays, ok = pinhole.back_project(cam.to(dtype=depth.dtype), uv)
    rays = rays / torch.clamp(rays[:, 2:3], min=1e-9)
    d = depth.reshape(-1)
    return rays * d[:, None], ok & (d > 0)


def transform_points(T_AB: torch.Tensor, p_B: torch.Tensor) -> torch.Tensor:
    """Apply the SE(3) pose T_AB (7,) to points (N, 3)."""
    R = se3.quat_to_matrix(se3.se3_q(T_AB))
    return p_B @ R.T + se3.se3_t(T_AB)[None, :]


def _zbuffer_target(pts_src, valid, cam_dst: Camera, T_dst_src):
    """Transform and project source points into `cam_dst`: (flat target
    index, z, in-bounds mask)."""
    pts = transform_points(T_dst_src.to(pts_src.dtype), pts_src)
    uv, ok = pinhole.project(cam_dst.to(dtype=pts.dtype), pts)
    z = pts[:, 2]
    valid = valid & ok & (z > 0)
    Hd, Wd = cam_dst.height, cam_dst.width
    ui = torch.round(uv[:, 0]).to(torch.int64)
    vi = torch.round(uv[:, 1]).to(torch.int64)
    inb = (ui >= 0) & (ui < Wd) & (vi >= 0) & (vi < Hd) & valid
    flat = torch.where(inb, vi * Wd + ui, torch.zeros_like(ui))
    return flat, z, inb


def _scatter_min(n: int, flat, val, inb):
    buf = torch.full((n,), float("inf"), dtype=val.dtype, device=val.device)
    return buf.scatter_reduce_(0, flat, torch.where(inb, val, torch.full_like(val, float("inf"))),
                               reduce="amin")


def register_depth(depth_src: torch.Tensor, cam_src: Camera, cam_dst: Camera,
                   T_dst_src: torch.Tensor, depth_scale: float = 1.0) -> torch.Tensor:
    """Re-render a depth image from `cam_src` into `cam_dst`'s image plane
    (the nearest surface wins; unmapped pixels 0)."""
    pts_src, valid = depth_to_points(depth_src * depth_scale, cam_src)
    flat, z, inb = _zbuffer_target(pts_src, valid, cam_dst, T_dst_src)
    buf = _scatter_min(cam_dst.height * cam_dst.width, flat, z, inb)
    out = torch.where(torch.isfinite(buf), buf, torch.zeros_like(buf))
    return out.reshape(cam_dst.height, cam_dst.width)


def warp_depth_sigma(sigma_src: torch.Tensor, depth_src: torch.Tensor, cam_src: Camera,
                     cam_dst: Camera, T_dst_src: torch.Tensor) -> torch.Tensor:
    """Carry a per-pixel sigma map through the same registration: each
    target pixel takes the sigma of the source pixel that won its z-buffer."""
    pts_src, valid = depth_to_points(depth_src, cam_src)
    flat, z, inb = _zbuffer_target(pts_src, valid, cam_dst, T_dst_src)
    zbuf = _scatter_min(cam_dst.height * cam_dst.width, flat, z, inb)
    zval = torch.where(inb, z, torch.full_like(z, float("inf")))
    wins = inb & (zval <= zbuf[flat] + 1e-9)
    sig = sigma_src.reshape(-1)
    sbuf = torch.zeros(cam_dst.height * cam_dst.width, dtype=sig.dtype, device=sig.device)
    sbuf.scatter_reduce_(0, torch.where(wins, flat, torch.zeros_like(flat)),
                         torch.where(wins, sig, torch.zeros_like(sig)), reduce="amax")
    return sbuf.reshape(cam_dst.height, cam_dst.width)


def sparse_depth_from_landmarks(hp_W: torch.Tensor, valid: torch.Tensor, T_WC: torch.Tensor,
                                cam: Camera, stride: int = 1) -> torch.Tensor:
    """Tracked landmarks rendered into an (H, W) sparse depth map (0 where
    none projects; the nearest wins), pixels snapped to a `stride` grid."""
    T_CW = se3.se3_inverse(T_WC)
    p_C = transform_points(T_CW, hp_W[:, :3] / torch.clamp(hp_W[:, 3:4], min=1e-12))
    uv, ok = pinhole.project(cam.to(dtype=p_C.dtype), p_C)
    z = p_C[:, 2]
    ok = ok & valid & (z > 0)
    H, W = cam.height, cam.width
    ui = torch.div(torch.round(uv[:, 0]).to(torch.int64), stride, rounding_mode="floor") * stride
    vi = torch.div(torch.round(uv[:, 1]).to(torch.int64), stride, rounding_mode="floor") * stride
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & ok
    flat = torch.where(inb, vi * W + ui, torch.zeros_like(ui))
    buf = _scatter_min(H * W, flat, z, inb)
    return torch.where(torch.isfinite(buf), buf, torch.zeros_like(buf)).reshape(H, W)
