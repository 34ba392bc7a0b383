"""Trajectory output + ATE evaluation.

Replaces the reference's `TrajectoryOutput` CSV writers (okvis_multisensor_
processing/src/TrajectoryOutput.cpp) and the external evo-style evaluation
used with tools/convert_to_tum.py: writes TUM-format trajectories and
computes ATE RMSE after SE(3) (or Sim(3)) Umeyama alignment.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def write_tum(path: str, ts: np.ndarray, T_WS: np.ndarray):
    """TUM format: t x y z qx qy qz qw."""
    with open(path, "w") as f:
        for t, T in zip(ts, T_WS):
            f.write(
                f"{t:.9f} {T[0]:.9f} {T[1]:.9f} {T[2]:.9f} "
                f"{T[3]:.9f} {T[4]:.9f} {T[5]:.9f} {T[6]:.9f}\n"
            )


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-neighbour timestamp association; returns index pairs."""
    j = np.searchsorted(t_b, t_a)
    j = np.clip(j, 1, len(t_b) - 1)
    left = np.abs(t_b[j - 1] - t_a)
    right = np.abs(t_b[j] - t_a)
    jj = np.where(left < right, j - 1, j)
    ok = np.abs(t_b[jj] - t_a) < max_dt
    return np.nonzero(ok)[0], jj[ok]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment dst ≈ s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    t_est: np.ndarray,
    p_est: np.ndarray,
    t_gt: np.ndarray,
    p_gt: np.ndarray,
    with_scale: bool = False,
) -> Optional[float]:
    """ATE RMSE [m] after alignment; None if too few associations."""
    ia, ib = associate(t_est, t_gt)
    if len(ia) < 3:
        return None
    src = p_est[ia]
    dst = p_gt[ib]
    s, R, t = umeyama_alignment(src, dst, with_scale)
    err = dst - (s * (R @ src.T).T + t)
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def read_tum(path: str):
    """Read a TUM-format trajectory; returns (ts (N,), T_WS (N, 7))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    arr = np.asarray(rows, np.float64)
    if arr.size == 0:
        return np.zeros(0), np.zeros((0, 7))
    return arr[:, 0], arr[:, 1:8]


def ate_stats(
    t_est: np.ndarray,
    p_est: np.ndarray,
    t_gt: np.ndarray,
    p_gt: np.ndarray,
    with_scale: bool = False,
    max_dt: float = 0.02,
) -> Optional[dict]:
    """Full evo-style ATE statistics after Umeyama alignment."""
    ia, ib = associate(t_est, t_gt, max_dt)
    if len(ia) < 3:
        return None
    src, dst = p_est[ia], p_gt[ib]
    s, R, t = umeyama_alignment(src, dst, with_scale)
    err = np.linalg.norm(dst - (s * (R @ src.T).T + t), axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "num_pairs": int(len(err)),
        "scale": float(s),
    }


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def rpe_stats(
    t_est: np.ndarray,
    T_est: np.ndarray,
    t_gt: np.ndarray,
    T_gt: np.ndarray,
    delta: int = 1,
    max_dt: float = 0.02,
) -> Optional[dict]:
    """Relative pose error over a fixed frame delta (evo rpe equivalent):
    per-pair translational and rotational error of
    (T_gt_i^-1 T_gt_j)^-1 (T_est_i^-1 T_est_j)."""
    ia, ib = associate(t_est, t_gt, max_dt)
    if len(ia) < delta + 2:
        return None
    terr, rerr = [], []
    for k in range(len(ia) - delta):
        i, j = k, k + delta
        Re_i = _quat_to_matrix_np(T_est[ia[i], 3:7])
        Re_j = _quat_to_matrix_np(T_est[ia[j], 3:7])
        Rg_i = _quat_to_matrix_np(T_gt[ib[i], 3:7])
        Rg_j = _quat_to_matrix_np(T_gt[ib[j], 3:7])
        de = Re_i.T @ (T_est[ia[j], :3] - T_est[ia[i], :3])
        dg = Rg_i.T @ (T_gt[ib[j], :3] - T_gt[ib[i], :3])
        terr.append(np.linalg.norm(de - dg))
        Rrel = (Rg_i.T @ Rg_j).T @ (Re_i.T @ Re_j)
        c = np.clip((np.trace(Rrel) - 1.0) / 2.0, -1.0, 1.0)
        rerr.append(np.degrees(np.arccos(c)))
    terr = np.asarray(terr)
    rerr = np.asarray(rerr)
    return {
        "trans_rmse": float(np.sqrt((terr**2).mean())),
        "trans_mean": float(terr.mean()),
        "rot_rmse_deg": float(np.sqrt((rerr**2).mean())),
        "rot_mean_deg": float(rerr.mean()),
        "num_pairs": int(len(terr)),
        "delta_frames": int(delta),
    }
