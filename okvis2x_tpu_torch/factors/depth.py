"""Per-keypoint landmark-depth factor (torch counterpart of
``okvis2x_tpu/factors/depth.py``, the reference's ``DepthErrorT``):

    r = sqrt_info * (d_meas - z_C)           (1-dim)

on the depth of a landmark in the camera frame, attached to the pose T_WS,
the homogeneous point hp_W and the extrinsics T_SC.  The one-sided variant
ignores the residual where the predicted depth exceeds the measurement;
both ignore points at infinity (|w| < 1e-16).  The gate is applied outside
the differentiated function, so ignored rows have exactly zero Jacobians.
Functions broadcast over leading batch dimensions except `linearize`, a
single observation that the solver vmaps over the observation rows.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.utils.forward_ad import lift


def predicted_depth(T_WS, T_SC, hp_W):
    """(z, w) of the homogeneous world point in the camera frame."""
    T_WC = se3.se3_multiply(T_WS, T_SC)
    hp_C = se3.se3_apply_homogeneous(se3.se3_inverse(T_WC), hp_W)
    return hp_C[..., 2], hp_C[..., 3]


def _gate(z, w, d_meas, onesided: bool):
    """(z / w with w = 1 at infinity, ignored)."""
    at_inf = w.abs() < 1e-16
    p_z = z / torch.where(at_inf, torch.ones_like(w), w)
    ignore = at_inf | (p_z > d_meas) if onesided else at_inf
    return p_z, ignore


def residual(T_WS, T_SC, hp_W, d_meas, sqrt_info, onesided: bool):
    """Whitened residual, zero where the gate ignores it."""
    p_z, ignore = _gate(*predicted_depth(T_WS, T_SC, hp_W), d_meas, onesided)
    r = sqrt_info * (d_meas - p_z)
    return torch.where(ignore, torch.zeros_like(r), r)


def residual_on_manifold(T_WS, T_SC, hp_W, d_meas, sqrt_info, dpose, dl, dext):
    """The ungated residual at the minimal increments (dpose 6, dl 3 on the
    xyz part of hp_W, dext 6): the function the solver differentiates at 0."""
    hp = torch.cat([lift(hp_W[..., :3], dl) + dl, hp_W[..., 3:]], dim=-1)
    p_z, _ = _gate(*predicted_depth(se3.retract(T_WS, dpose), se3.retract(T_SC, dext), hp),
                   d_meas, False)
    return lift(sqrt_info, p_z) * (lift(d_meas, p_z) - p_z)


def linearize(T_WS, T_SC, hp_W, d_meas, sqrt_info, onesided: bool):
    """Single observation: (r (), J_pose (6,), J_point (3,), J_ext (6,)),
    all zero where the gate ignores the row."""
    z6 = torch.zeros(6, dtype=T_WS.dtype, device=T_WS.device)
    z3 = torch.zeros(3, dtype=T_WS.dtype, device=T_WS.device)

    def f(dpose, dl, dext):
        r = residual_on_manifold(T_WS, T_SC, hp_W, d_meas, sqrt_info, dpose, dl, dext)
        return r, r

    (Jp, Jl, Je), r = jacfwd(f, argnums=(0, 1, 2), has_aux=True)(z6, z3, z6)
    _, ignore = _gate(*predicted_depth(T_WS, T_SC, hp_W), d_meas, onesided)
    keep = (~ignore).to(r.dtype)
    return r * keep, Jp * keep, Jl * keep, Je * keep
