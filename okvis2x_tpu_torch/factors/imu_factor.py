"""Preintegrated IMU factor between two states (torch counterpart of
``okvis2x_tpu/factors/imu_factor.py``).  Residual (15-dim, ordering
[dp, dalpha, dv, dbg, dba], whitened by the preintegration sqrt information):

    r_dp     = C_WS0^T (t1 - t0 - v0 dt - 1/2 g dt^2) - dp_hat(b0)
    r_dalpha = log( dq_hat(b0)^-1 ⊗ q0^-1 ⊗ q1 )
    r_dv     = C_WS0^T (v1 - v0 - g dt) - dv_hat(b0)
    r_dbg    = bg1 - bg0
    r_dba    = ba1 - ba0
"""

from __future__ import annotations

import torch

from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.imu.preintegration import ImuParams, Preintegrated
from okvis2x_tpu_torch.utils.forward_ad import lift


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def sqrt_information(P: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Lower-triangular W = L^-1 with P = L L^T, so W^T W = P^-1 (Cholesky of
    the symmetrised, regularised covariance); batched over leading dims."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    Preg = 0.5 * (P + P.transpose(-1, -2)) + eps * eye
    L = torch.linalg.cholesky(Preg)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def residual(params: ImuParams, pre: Preintegrated, sqrt_info, T_WS0, sb0, T_WS1, sb1):
    dtype, dev = T_WS0.dtype, T_WS0.device
    v0, bg0, ba0 = sb0[..., 0:3], sb0[..., 3:6], sb0[..., 6:9]
    v1, bg1, ba1 = sb1[..., 0:3], sb1[..., 3:6], sb1[..., 6:9]
    dbg = bg0 - lift(pre.lin_bg, bg0)
    dba = ba0 - lift(pre.lin_ba, ba0)
    dp_hat = lift(pre.dp, dbg) + _mv(pre.dp_dbg, dbg) + _mv(pre.dp_dba, dba)
    dv_hat = lift(pre.dv, dbg) + _mv(pre.dv_dbg, dbg) + _mv(pre.dv_dba, dba)
    dq_hat = se3.quat_multiply(lift(pre.dq, dbg), se3.delta_q(_mv(pre.dq_dbg, dbg)))

    g_W = torch.tensor([0.0, 0.0, -params.g], dtype=dtype, device=dev)
    dt = pre.dt[..., None]
    q0 = se3.se3_q(T_WS0)
    C0T = se3.quat_to_matrix(q0).transpose(-1, -2)
    t0 = se3.se3_t(T_WS0)
    t1 = se3.se3_t(T_WS1)
    r_dp = _mv(C0T, t1 - t0 - v0 * lift(dt, v0) - lift(0.5 * g_W * dt * dt, t0)) - dp_hat
    q_rel = se3.quat_multiply(se3.quat_conjugate(q0), se3.se3_q(T_WS1))
    q_err = se3.quat_multiply(se3.quat_conjugate(dq_hat), q_rel)
    r_dalpha = se3.quat_log(q_err)
    r_dv = _mv(C0T, v1 - v0 - lift(g_W * dt, v0)) - dv_hat
    r = torch.cat([r_dp, r_dalpha, r_dv, bg1 - bg0, ba1 - ba0], dim=-1)
    return _mv(sqrt_info, r)


def residual_on_manifold(params, pre, sqrt_info, T_WS0, sb0, T_WS1, sb1, d0, dsb0, d1, dsb1):
    """Residual as a function of minimal increments (for jacfwd at 0)."""
    return residual(
        params, pre, sqrt_info,
        se3.retract(T_WS0, d0), lift(sb0, dsb0) + dsb0, se3.retract(T_WS1, d1),
        lift(sb1, dsb1) + dsb1,
    )


def pseudo_residual(sigma_v, sigma_q, dt, T_WS0, sb0, T_WS1, sb1):
    """Weak constant-velocity + constant-pose-rate prior (the reference's
    PseudoImuError)."""
    d = se3.local_delta(T_WS0, T_WS1)
    dt = torch.clamp(torch.as_tensor(dt, dtype=d.dtype, device=d.device), min=1e-3)
    return torch.cat([d / (sigma_q * dt[..., None]), (sb1 - sb0) / sigma_v], dim=-1)
