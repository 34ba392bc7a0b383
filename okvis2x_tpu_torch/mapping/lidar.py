"""LiDAR utilities: motion deskew and voxel-grid downsampling (torch
counterpart of ``okvis2x_tpu/mapping/lidar.py``; the reference's
LidarMotionUndistortion and VoxelGridFilter).

`deskew` interpolates the two bracketing poses per ray (float32, on the
tensors' device); `deskew_imu` propagates the raw IMU samples per ray on the
host; `voxel_downsample` keeps the first points of each voxel on the host;
`voxel_downsample_device` elects one point per hash slot on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from okvis2x_tpu_torch.core import se3, se3np
from okvis2x_tpu_torch.imu import preintegration_np as pre_np


def deskew(T_WS_0: torch.Tensor, T_WS_1: torch.Tensor, t_frac: torch.Tensor,
           p_S: torch.Tensor) -> torch.Tensor:
    """Motion-compensate a sweep (N, 3), measured in the moving sensor frame
    with per-ray times `t_frac` (N,) in [0, 1], into the frame at scan end:
    each ray's pose is the geodesic interpolation between the scan-start
    pose T_WS_0 and the scan-end pose T_WS_1."""
    d = se3.local_delta(T_WS_0, T_WS_1)
    T_t = se3.retract(T_WS_0.expand(t_frac.shape[0], 7), t_frac[:, None] * d)
    p_W = se3.se3_apply(T_t, p_S)
    return se3.se3_apply(se3.se3_inverse(T_WS_1), p_W)


def deskew_imu(imu_params, imu_t: np.ndarray, imu_gyr: np.ndarray, imu_acc: np.ndarray, f_a,
               t_point: np.ndarray, pts_S: np.ndarray, t_end: float | None = None):
    """Per-ray IMU-propagated motion compensation into the frame at `t_end`
    (default: the last ray): the state `f_a` at or before the sweep start
    (T_WS, sb) is propagated through the raw IMU samples to every ray time
    in one pass.  Returns (points in the frame at t_end (N, 3), the pose
    propagated to t_end (7,)); float64 numpy."""
    t_point = np.asarray(t_point, np.float64)
    if t_end is None:
        t_end = float(t_point.max())
    tq = np.concatenate([t_point, [t_end]])
    order = np.argsort(tq)
    T_sorted = pre_np.predict_states_batch(
        imu_params, imu_t, imu_gyr, imu_acc, float(f_a.timestamp), tq[order],
        np.asarray(f_a.T_WS), np.asarray(f_a.sb[0:3]), np.asarray(f_a.sb[3:6]),
        np.asarray(f_a.sb[6:9]))
    T_all = np.empty_like(T_sorted)
    T_all[order] = T_sorted
    T_rays, T_end = T_all[:-1], T_all[-1]
    # p_end = T_end^-1 T_ray p
    R_end_T = se3np.quat_to_matrix(T_end[3:7]).T
    Rs = se3np.quat_to_matrix(T_rays[:, 3:7])
    p_W = np.einsum("nij,nj->ni", Rs, pts_S) + T_rays[:, :3]
    return (p_W - T_end[:3]) @ R_end_T.T, T_end


def voxel_downsample(pts: np.ndarray, voxel: float, max_per_voxel: int = 1) -> np.ndarray:
    """Keep up to `max_per_voxel` points per voxel, the first ones in the
    input's order, in the input's order."""
    if len(pts) == 0:
        return pts
    keys = np.floor(pts / voxel).astype(np.int64)
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    new_cell = np.any(np.diff(keys[order], axis=0) != 0, axis=1)
    cell_id = np.concatenate([[0], np.cumsum(new_cell)])
    starts = np.concatenate([[0], np.nonzero(new_cell)[0] + 1])
    rank_in_cell = np.arange(len(pts)) - starts[cell_id]
    return pts[np.sort(order[rank_in_cell < max_per_voxel])]


def voxel_downsample_device(pts: torch.Tensor, valid: torch.Tensor, voxel: float,
                            table_size: int = 1 << 14):
    """Approximate voxel downsampling by hash-slot election on the device:
    each valid point hashes its voxel key (int32 arithmetic with
    wraparound) into a table of `table_size` slots and the lowest index
    wins its slot; collisions only thin further.  Returns (pts, keep)."""
    keys = torch.floor(pts / voxel).to(torch.int32)
    h = (keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791) % table_size
    h = h.to(torch.int64)
    n = pts.shape[0]
    order = torch.arange(n, dtype=torch.int32, device=pts.device)
    slot_winner = torch.full((table_size,), n, dtype=torch.int32, device=pts.device)
    slot_winner = slot_winner.scatter_reduce(0, h, torch.where(valid, order, n), "amin")
    return pts, (slot_winner[h] == order) & valid
