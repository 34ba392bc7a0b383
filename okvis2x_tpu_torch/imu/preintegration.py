"""IMU preintegration: propagation, covariance and bias Jacobians (torch).

Counterpart of ``okvis2x_tpu/imu/preintegration.py``: midpoint integration of
the IMU kinematics between t0 and t1 over a mask-padded measurement buffer,
with the 15-dim error-state covariance ordered
``[dp (0:3), dalpha (3:6), dv (6:9), dbg (9:12), dba (12:15)]`` and the
first-order bias Jacobians accumulated alongside.  Every function broadcasts
over leading batch dimensions (the JAX package vmaps instead); the scan over
samples is a plain loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.core import se3


class ImuParams(NamedTuple):
    """Noise densities (continuous-time), as in okvis2.yaml `imu_params`."""

    sigma_g: float = 12.0e-4  # gyro noise density [rad/s/sqrt(Hz)]
    sigma_a: float = 8.0e-3  # accel noise density [m/s^2/sqrt(Hz)]
    sigma_gw: float = 4.0e-6  # gyro random walk
    sigma_aw: float = 4.0e-5  # accel random walk
    g: float = 9.81007  # gravity magnitude
    rate: float = 200.0  # nominal rate [Hz]
    g_max: float = 7.8  # max gyro reading [rad/s]
    a_max: float = 176.0  # max accel reading [m/s^2]
    sigma_bg: float = 0.03  # prior stdev gyro bias (init)
    sigma_ba: float = 0.1  # prior stdev accel bias (init)


class ImuBatch(NamedTuple):
    """Fixed-capacity measurement window (..., N); invalid rows masked."""

    t: torch.Tensor  # (..., N) timestamps [s]
    gyr: torch.Tensor  # (..., N, 3)
    acc: torch.Tensor  # (..., N, 3)
    mask: torch.Tensor  # (..., N) bool


class Preintegrated(NamedTuple):
    """Result of preintegrating an ImuBatch between t0 and t1."""

    dq: torch.Tensor  # (..., 4) Delta rotation quaternion (S0 <- S1)
    dp: torch.Tensor  # (..., 3) position increment in S0
    dv: torch.Tensor  # (..., 3) velocity increment in S0
    dp_dbg: torch.Tensor  # (..., 3, 3)
    dp_dba: torch.Tensor  # (..., 3, 3)
    dv_dbg: torch.Tensor  # (..., 3, 3)
    dv_dba: torch.Tensor  # (..., 3, 3)
    dq_dbg: torch.Tensor  # (..., 3, 3)  d(log dq)/db_g
    P: torch.Tensor  # (..., 15, 15) covariance
    dt: torch.Tensor  # (...,) total integration time
    lin_bg: torch.Tensor  # (..., 3) gyro bias linearisation point
    lin_ba: torch.Tensor  # (..., 3) accel bias linearisation point


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def preintegrate(
    params: ImuParams,
    batch: ImuBatch,
    t0: torch.Tensor,
    t1: torch.Tensor,
    bg: torch.Tensor,
    ba: torch.Tensor,
) -> Preintegrated:
    """Midpoint preintegration over the measurements in [t0, t1]; boundary
    intervals are clipped to [t0, t1], masked intervals are no-ops."""
    dtype, dev = batch.acc.dtype, batch.acc.device
    t0 = torch.as_tensor(t0, dtype=dtype, device=dev)[..., None]
    t1 = torch.as_tensor(t1, dtype=dtype, device=dev)[..., None]
    ta = torch.minimum(torch.maximum(batch.t[..., :-1], t0), t1)
    tb = torch.minimum(torch.maximum(batch.t[..., 1:], t0), t1)
    m = (batch.mask[..., :-1] & batch.mask[..., 1:]).to(dtype)
    dts = torch.clamp(tb - ta, min=0.0) * m

    g0 = batch.gyr[..., :-1, :] - bg[..., None, :]
    g1 = batch.gyr[..., 1:, :] - bg[..., None, :]
    a0 = batch.acc[..., :-1, :] - ba[..., None, :]
    a1 = batch.acc[..., 1:, :] - ba[..., None, :]

    sg2 = params.sigma_g**2
    sa2 = params.sigma_a**2
    sgw2 = params.sigma_gw**2
    saw2 = params.sigma_aw**2

    shape = batch.t.shape[:-1]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z33 = torch.zeros(shape + (3, 3), dtype=dtype, device=dev)
    dq = se3.quat_identity(dtype, dev).expand(shape + (4,))
    dp = torch.zeros(shape + (3,), dtype=dtype, device=dev)
    dv = torch.zeros(shape + (3,), dtype=dtype, device=dev)
    dp_dbg, dp_dba, dv_dbg, dv_dba, dq_dbg = z33, z33, z33, z33, z33
    P = torch.zeros(shape + (15, 15), dtype=dtype, device=dev)

    for k in range(dts.shape[-1]):
        dt = dts[..., k]
        has = dt > 0.0
        dt = torch.where(has, dt, torch.zeros_like(dt))
        dtv = dt[..., None]
        dtm = dt[..., None, None]
        w0, w1, f0, f1 = g0[..., k, :], g1[..., k, :], a0[..., k, :], a1[..., k, :]

        omega = 0.5 * (w0 + w1)
        dq_step = se3.delta_q(omega * dtv)
        dq_new = se3.quat_normalize(se3.quat_multiply(dq, dq_step))
        C0 = se3.quat_to_matrix(dq)
        C1 = se3.quat_to_matrix(dq_new)
        acc_S0 = 0.5 * (_mv(C0, f0) + _mv(C1, f1))
        dv_new = dv + acc_S0 * dtv
        dp_new = dp + dv * dtv + 0.5 * acc_S0 * dtv * dtv

        C_step = se3.quat_to_matrix(dq_step)
        dq_dbg_new = C_step.transpose(-1, -2) @ dq_dbg - eye3 * dtm
        acc_avg = 0.5 * (f0 + f1)
        C0_ax = C0 @ se3.cross_matrix(acc_avg)
        dacc_dbg = -C0_ax @ dq_dbg
        dacc_dba = -0.5 * (C0 + C1)
        dv_dbg_new = dv_dbg + dacc_dbg * dtm
        dv_dba_new = dv_dba + dacc_dba * dtm
        dp_dbg_new = dp_dbg + dv_dbg * dtm + 0.5 * dacc_dbg * dtm * dtm
        dp_dba_new = dp_dba + dv_dba * dtm + 0.5 * dacc_dba * dtm * dtm

        F = torch.eye(15, dtype=dtype, device=dev).expand(shape + (15, 15)).clone()
        F[..., 0:3, 6:9] = eye3 * dtm
        F[..., 0:3, 3:6] = -0.5 * C0_ax * dtm * dtm
        F[..., 0:3, 12:15] = 0.5 * dacc_dba * dtm * dtm
        F[..., 3:6, 3:6] = C_step.transpose(-1, -2)
        F[..., 3:6, 9:12] = -eye3 * dtm
        F[..., 6:9, 3:6] = -C0_ax * dtm
        F[..., 6:9, 12:15] = dacc_dba * dtm
        P_new = F @ P @ F.transpose(-1, -2)
        P_new[..., 0:3, 0:3] += eye3 * (0.25 * sa2 * dtm * dtm * dtm)
        P_new[..., 3:6, 3:6] += eye3 * (sg2 * dtm)
        P_new[..., 6:9, 6:9] += eye3 * (sa2 * dtm)
        P_new[..., 9:12, 9:12] += eye3 * (sgw2 * dtm)
        P_new[..., 12:15, 12:15] += eye3 * (saw2 * dtm)

        h1, h2 = has[..., None], has[..., None, None]
        dq = torch.where(h1, dq_new, dq)
        dp = torch.where(h1, dp_new, dp)
        dv = torch.where(h1, dv_new, dv)
        dp_dbg = torch.where(h2, dp_dbg_new, dp_dbg)
        dp_dba = torch.where(h2, dp_dba_new, dp_dba)
        dv_dbg = torch.where(h2, dv_dbg_new, dv_dbg)
        dv_dba = torch.where(h2, dv_dba_new, dv_dba)
        dq_dbg = torch.where(h2, dq_dbg_new, dq_dbg)
        P = torch.where(h2, P_new, P)

    return Preintegrated(
        dq=dq, dp=dp, dv=dv, dp_dbg=dp_dbg, dp_dba=dp_dba, dv_dbg=dv_dbg,
        dv_dba=dv_dba, dq_dbg=dq_dbg, P=P, dt=dts.sum(-1), lin_bg=bg,
        lin_ba=ba,
    )


def propagate_state(params: ImuParams, pre: Preintegrated, T_WS0: torch.Tensor,
                    v_W0: torch.Tensor, bg: torch.Tensor, ba: torch.Tensor):
    """Predict (T_WS1, v_W1) from preintegrated quantities, with first-order
    bias correction around the linearisation point."""
    dbg = bg - pre.lin_bg
    dba = ba - pre.lin_ba
    dp = pre.dp + _mv(pre.dp_dbg, dbg) + _mv(pre.dp_dba, dba)
    dv = pre.dv + _mv(pre.dv_dbg, dbg) + _mv(pre.dv_dba, dba)
    dq = se3.quat_multiply(pre.dq, se3.delta_q(_mv(pre.dq_dbg, dbg)))
    g_W = torch.tensor([0.0, 0.0, -params.g], dtype=pre.dp.dtype, device=pre.dp.device)
    C_WS0 = se3.quat_to_matrix(se3.se3_q(T_WS0))
    dt = pre.dt[..., None]
    t1 = se3.se3_t(T_WS0) + v_W0 * dt + 0.5 * g_W * dt * dt + _mv(C_WS0, dp)
    v1 = v_W0 + g_W * dt + _mv(C_WS0, dv)
    q1 = se3.quat_normalize(se3.quat_multiply(se3.se3_q(T_WS0), dq))
    return torch.cat([t1, q1], dim=-1), v1


def init_pose_from_accel(acc_mean: torch.Tensor, gyr_mean: torch.Tensor) -> torch.Tensor:
    """Gravity-aligned initial pose with yaw = 0: the q whose C(q)^T (-g e_z)
    matches the measured specific-force direction."""
    del gyr_mean
    dtype, dev = acc_mean.dtype, acc_mean.device
    ez_W = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    ez_S = acc_mean / torch.clamp(torch.linalg.norm(acc_mean), min=1e-9)
    v = se3.cross(ez_S, ez_W)
    s = torch.linalg.norm(v)
    c = torch.dot(ez_S, ez_W)
    angle = torch.atan2(s, c)
    axis = torch.where(
        s > 1e-9, v / torch.clamp(s, min=1e-12),
        torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev),
    )
    q = se3.delta_q(axis * angle)
    return torch.cat([torch.zeros(3, dtype=dtype, device=dev), q])
