"""Reprojection factor (torch counterpart of
``okvis2x_tpu/factors/reprojection.py``):

    r = sqrt_info * ( z - h( T_SC^-1 T_WS^-1 hp_W ) )        (2-dim)

parameterised by minimal increments (dpose 6, dhp 3 on the xyz part, dext 6).
Jacobians come from ``torch.func.jacfwd`` through ``se3.retract``; the
solver vmaps the single-observation functions over the observation table.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.utils.forward_ad import lift


def residual(cam: pinhole.Camera, T_WS, T_SC, hp_W, uv_meas, sqrt_info):
    """Whitened reprojection residual + validity (sqrt_info is a scalar
    per observation); invalid projections give a zero residual."""
    T_CW = se3.se3_multiply(se3.se3_inverse(T_SC), se3.se3_inverse(T_WS))
    hp_C = se3.se3_apply_homogeneous(T_CW, hp_W)
    uv, valid = pinhole.project_homogeneous(cam, hp_C)
    r = (lift(uv_meas, uv) - uv) * lift(sqrt_info, uv)[..., None]
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    return r, valid


def residual_on_manifold(cam, T_WS, T_SC, hp_W, uv_meas, sqrt_info, dpose, dhp, dext):
    """Residual as a function of minimal increments (for jacfwd at 0)."""
    T_WS_p = se3.retract(T_WS, dpose)
    T_SC_p = se3.retract(T_SC, dext)
    hp_p = torch.cat([lift(hp_W[..., :3], dhp) + dhp, hp_W[..., 3:]], dim=-1)
    return residual(cam, T_WS_p, T_SC_p, hp_p, uv_meas, sqrt_info)


def linearize(cam, T_WS, T_SC, hp_W, uv_meas, sqrt_info):
    """Single observation: (r (2,), J_pose (2,6), J_hp (2,3), J_ext (2,6),
    valid)."""
    z6 = torch.zeros(6, dtype=T_WS.dtype, device=T_WS.device)
    z3 = torch.zeros(3, dtype=T_WS.dtype, device=T_WS.device)

    def f(dpose, dhp, dext):
        r, valid = residual_on_manifold(
            cam, T_WS, T_SC, hp_W, uv_meas, sqrt_info, dpose, dhp, dext
        )
        return r, (r, valid)

    (Jp, Jh, Je), (r, valid) = jacfwd(f, argnums=(0, 1, 2), has_aux=True)(z6, z3, z6)
    return r, Jp, Jh, Je, valid
