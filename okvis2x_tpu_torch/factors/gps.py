"""GNSS position factors (torch counterpart of ``okvis2x_tpu/factors/gps.py``).

A position fix p_G in the GNSS frame G constrains the host state through the
4-dof world-to-GNSS alignment T_GW (position and yaw; roll and pitch are
observable from gravity):

    r = sqrt_info * (p_meas_G - T_GW * (p_WS(t_g) + C_WS(t_g) r_SA))

An asynchronous fix first propagates the host state to the fix time t_g
through the IMU preintegration of the gap (the factor's bridge).  Functions
broadcast over leading batch dimensions of the state and the fix; `T_GW` is
one (7,) pose.
"""

from __future__ import annotations

import torch

from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.imu.preintegration import ImuParams, Preintegrated, propagate_state


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def retract_4dof(T_GW: torch.Tensor, d4: torch.Tensor) -> torch.Tensor:
    """Position + yaw boxplus for the alignment frame."""
    t = T_GW[:3] + d4[:3]
    dyaw = torch.cat([torch.zeros(2, dtype=d4.dtype, device=d4.device), d4[3:4]])
    q = se3.quat_normalize(se3.quat_multiply(se3.delta_q(dyaw), T_GW[3:7]))
    return torch.cat([t, q])


def residual_sync(T_GW, T_WS, p_meas_G, r_SA, sqrt_info):
    """Whitened position error of a fix taken at the state's own time."""
    p_W = se3.se3_t(T_WS) + se3.quat_rotate(se3.se3_q(T_WS), r_SA)
    return _mv(sqrt_info, p_meas_G - se3.se3_apply(T_GW, p_W))


def residual_async(params: ImuParams, pre: Preintegrated, T_GW, T_WS, sb, p_meas_G,
                   r_SA, sqrt_info):
    """Asynchronous fix: the host state (T_WS, sb) propagated to the fix time
    through `pre` (host state -> fix time), then `residual_sync`."""
    T_t, _ = propagate_state(params, pre, T_WS, sb[..., 0:3], sb[..., 3:6], sb[..., 6:9])
    return residual_sync(T_GW, T_t, p_meas_G, r_SA, sqrt_info)


def residual_async_on_manifold(params, pre, T_GW, T_WS, sb, p_meas_G, r_SA, sqrt_info,
                               dpose, dsb, d4):
    """`residual_async` at the increments (dpose, dsb, d4) of the host pose,
    its speed/bias and T_GW: the function the solver differentiates at 0."""
    return residual_async(params, pre, retract_4dof(T_GW, d4), se3.retract(T_WS, dpose),
                          sb + dsb, p_meas_G, r_SA, sqrt_info)
