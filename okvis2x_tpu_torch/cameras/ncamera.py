"""Multi-camera rig (extrinsics + per-camera models), torch.

Counterpart of ``okvis2x_tpu/cameras/ncamera.py``: a rig is a tuple of
`Camera`s plus a stacked (N, 7) tensor of sensor-to-camera extrinsics T_SC
(pose of camera frame C in the IMU/sensor frame S, so that p_S = T_SC p_C).
The cameras of one rig may have different distortion models.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.cameras.pinhole import Camera
from okvis2x_tpu_torch.core import se3


class CameraRig(NamedTuple):
    cameras: Tuple[Camera, ...]
    T_SC: torch.Tensor  # (N, 7) sensor-to-camera extrinsics

    @property
    def num_cameras(self) -> int:
        return len(self.cameras)


def make_rig(cameras: Sequence[Camera], T_SC: Sequence[torch.Tensor]) -> CameraRig:
    return CameraRig(cameras=tuple(cameras),
                     T_SC=torch.stack([torch.as_tensor(T) for T in T_SC], dim=0))


def project_world_point(rig: CameraRig, cam_idx: int, T_WS: torch.Tensor,
                        hp_W: torch.Tensor):
    """World homogeneous point -> pixel in camera `cam_idx`:
    p_C = T_SC^-1 T_WS^-1 p_W, the chain every reprojection factor uses."""
    T_CW = se3.se3_multiply(se3.se3_inverse(rig.T_SC[cam_idx]), se3.se3_inverse(T_WS))
    hp_C = se3.se3_apply_homogeneous(T_CW, hp_W)
    return pinhole.project_homogeneous(rig.cameras[cam_idx], hp_C)


def overlap_masks(rig: CameraRig, grid: int = 16):
    """Approximate inter-camera overlap flags by reprojecting a grid of rays
    of camera i, at a nominal depth of 3 m, into camera j: overlapping when
    more than 5% of them land in j's image."""
    n = rig.num_cameras
    flags = []
    for i in range(n):
        cam_i = rig.cameras[i]
        dtype, dev = cam_i.fxfycxcy.dtype, cam_i.fxfycxcy.device
        us = torch.linspace(0.0, cam_i.width - 1.0, grid, dtype=dtype, device=dev)
        vs = torch.linspace(0.0, cam_i.height - 1.0, grid, dtype=dtype, device=dev)
        uv = torch.stack(torch.meshgrid(us, vs, indexing="xy"), dim=-1).reshape(-1, 2)
        ray_i, valid_i = pinhole.back_project(cam_i, uv)
        row = []
        for j in range(n):
            if i == j:
                row.append(True)
                continue
            p_Ci = ray_i / torch.clamp(ray_i[..., 2:3], min=1e-6) * 3.0
            T_CjCi = se3.se3_multiply(se3.se3_inverse(rig.T_SC[j]), rig.T_SC[i])
            _, valid_j = pinhole.project(rig.cameras[j], se3.se3_apply(T_CjCi, p_Ci))
            frac = (valid_i & valid_j).to(torch.float32).mean()
            row.append(bool(frac > 0.05))
        flags.append(row)
    return flags
