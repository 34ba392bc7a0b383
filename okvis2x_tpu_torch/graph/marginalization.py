"""Observation -> relative-pose-edge marginalisation (TwoPoseGraphError).

Torch counterpart of ``okvis2x_tpu/graph/marginalization.py``: summarise the
reprojection information of landmarks co-observed by two keyframes into a
6-dof relative-pose edge (`two_pose_edge`), or with the camera extrinsics
marginalised as well (`two_pose_extrinsics_edge`).

  1. linearise the co-observed reprojection factors (Cauchy corrector);
  2. Schur-marginalise the landmarks -> 12x12 Hessian over (pose_a, pose_b);
  3. reparametrise (delta_a, delta_b) -> (delta_a, delta_rel) by the exact
     Jacobian of the reparametrisation at 0;
  4. marginalise delta_a with a rank-revealing pseudo-inverse;
  5. eigendecompose the 6x6 relative information, clamp the eigenvalues and
     return the symmetric square root as sqrt information.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from okvis2x_tpu_torch.cameras.pinhole import Camera
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.factors import reprojection, robust
from okvis2x_tpu_torch.solver.gauss_newton import StackedCameras
from okvis2x_tpu_torch.utils import forward_ad


def two_pose_edge(
    cams: StackedCameras,
    T_WS_a: torch.Tensor,  # (7,)
    T_WS_b: torch.Tensor,  # (7,)
    T_SC: torch.Tensor,  # (C, 7)
    hp_W: torch.Tensor,  # (L, 4) co-observed landmarks
    lm_mask: torch.Tensor,  # (L,)
    obs_pose: torch.Tensor,  # (N,) int: 0 -> pose a, 1 -> pose b
    obs_cam: torch.Tensor,  # (N,) int
    obs_lm: torch.Tensor,  # (N,) int row into hp_W
    obs_uv: torch.Tensor,  # (N, 2)
    obs_sqrt_info: torch.Tensor,  # (N,)
    obs_mask: torch.Tensor,  # (N,) bool
    cauchy_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (T_ab (7,), sqrt_info (6,6), strength ()); `strength` is the
    trace of the relative information."""
    dtype, dev = T_WS_a.dtype, T_WS_a.device
    L = hp_W.shape[0]
    N = obs_pose.shape[0]
    poses = torch.stack([T_WS_a, T_WS_b])
    z6 = torch.zeros(6, dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)

    def one(T_WS, T_SC_c, hp, uv, si, kc, dp):
        cam = Camera(kc, dp, cams.width, cams.height, cams.model)

        def f(dpose, dhp):
            r, valid = reprojection.residual_on_manifold(
                cam, T_WS, T_SC_c, hp, uv, si, dpose, dhp, z6
            )
            return r, (r, valid)

        (Jp, Jh), (r, valid) = jacfwd(f, argnums=(0, 1), has_aux=True)(z6, z3)
        return r, Jp, Jh, valid

    with forward_ad.LOCK:
        r, Jp, Jh, valid = vmap(one)(
            poses[obs_pose], T_SC[obs_cam], hp_W[obs_lm], obs_uv, obs_sqrt_info,
            cams.fxfycxcy[obs_cam], cams.dist_params[obs_cam],
        )
    # pose Jacobian into the 12-wide row at column 6 * pose
    Jrow = torch.zeros((N, 2, 12), dtype=dtype, device=dev)
    cols = (obs_pose[:, None] * 6 + torch.arange(6, device=dev))[:, None, :]
    Jrow.scatter_(2, cols.expand(N, 2, 6), Jp)

    m = (valid & obs_mask & lm_mask[obs_lm]).to(dtype)
    s = torch.sum(r * r, dim=-1)
    w = robust.weight(robust.CAUCHY, s, cauchy_scale) * m
    sw = torch.sqrt(w)[:, None]
    Jrow = Jrow * sw[..., None]
    Jh = Jh * sw[..., None]

    # Schur out the landmarks
    J12 = Jrow.reshape(-1, 12)
    H2 = J12.T @ J12
    H_ll = torch.zeros((L, 3, 3), dtype=dtype, device=dev).index_add_(
        0, obs_lm, torch.einsum("nri,nrj->nij", Jh, Jh)
    )
    W = torch.zeros((L, 12, 3), dtype=dtype, device=dev).index_add_(
        0, obs_lm, torch.einsum("nrp,nri->npi", Jrow, Jh)
    )
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    lm_ok = (torch.diagonal(H_ll, dim1=-2, dim2=-1).sum(-1) > 1e-9) & lm_mask
    H_ll_inv = torch.linalg.inv(H_ll + 1e-8 * eye3) * lm_ok.to(dtype)[:, None, None]
    H2 = H2 - torch.einsum("lpi,lij,lqj->pq", W, H_ll_inv, W)

    # reparametrise to (delta_a, delta_rel)
    T_ab = se3.se3_multiply(se3.se3_inverse(T_WS_a), T_WS_b)

    def to_abs(da, drel):
        Ta = se3.retract(T_WS_a, da)
        Tb = se3.se3_multiply(Ta, se3.retract(T_ab, drel))
        return torch.cat([da, se3.local_delta(T_WS_b, Tb)])

    with forward_ad.LOCK:
        Aa, Ar = jacfwd(to_abs, argnums=(0, 1))(z6, z6)
    A = torch.cat([Aa, Ar], dim=1)
    Hy = A.T @ H2 @ A
    H_aa, H_ar, H_rr = Hy[:6, :6], Hy[:6, 6:], Hy[6:, 6:]

    # marginalise the absolute block with a pseudo-inverse
    H_rel = H_rr - H_ar.T @ _pinv_psd(H_aa) @ H_ar

    return (T_ab,) + _sqrt_information(H_rel)


def _pinv_psd(H: torch.Tensor) -> torch.Tensor:
    """Rank-revealing pseudo-inverse of a symmetric block (eigenvalues below
    1e-9 of the largest, or of 1, are dropped)."""
    e, U = torch.linalg.eigh(0.5 * (H + H.T))
    tol = torch.clamp(e.abs().max(), min=1.0) * 1e-9
    inv_e = torch.where(e > tol, 1.0 / torch.where(e > tol, e, torch.ones_like(e)),
                        torch.zeros_like(e))
    return (U * inv_e[None, :]) @ U.T


def _sqrt_information(H_rel: torch.Tensor):
    """Rank-safe symmetric square root of a 6x6 information and its
    strength (the sum of its clamped eigenvalues)."""
    er, Ur = torch.linalg.eigh(0.5 * (H_rel + H_rel.T))
    er_c = torch.clamp(er, min=0.0)
    return (Ur * torch.sqrt(er_c)[None, :]) @ Ur.T, er_c.sum()


def two_pose_extrinsics_edge(
    cams: StackedCameras,
    T_WS_a: torch.Tensor,
    T_WS_b: torch.Tensor,
    T_SC: torch.Tensor,  # (C, 7)
    hp_W: torch.Tensor,
    lm_mask: torch.Tensor,
    obs_pose: torch.Tensor,
    obs_cam: torch.Tensor,
    obs_lm: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_sqrt_info: torch.Tensor,
    obs_mask: torch.Tensor,
    cauchy_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`two_pose_edge` with the camera extrinsics marginalised together with
    the absolute pose (the reference's TwoPoseExtrinsicsGraphError), so that
    the edge does not pin the extrinsics at their linearisation point.  The
    relative information is never larger than `two_pose_edge`'s.  The JAX
    package defines it and its tests call it; its estimator marginalises with
    `two_pose_edge` under online calibration, and so does the port's.
    Returns (T_ab (7,), sqrt_info (6, 6), strength ())."""
    dtype, dev = T_WS_a.dtype, T_WS_a.device
    L = hp_W.shape[0]
    C = T_SC.shape[0]
    N = obs_pose.shape[0]
    P = 12 + 6 * C
    poses = torch.stack([T_WS_a, T_WS_b])
    z6 = torch.zeros(6, dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)

    def one(T_WS, T_SC_c, hp, uv, si, kc, dp):
        cam = Camera(kc, dp, cams.width, cams.height, cams.model)

        def f(dpose, dhp, dext):
            r, valid = reprojection.residual_on_manifold(
                cam, T_WS, T_SC_c, hp, uv, si, dpose, dhp, dext
            )
            return r, (r, valid)

        (Jp, Jh, Je), (r, valid) = jacfwd(f, argnums=(0, 1, 2), has_aux=True)(z6, z3, z6)
        return r, Jp, Jh, Je, valid

    with forward_ad.LOCK:
        r, Jp, Jh, Je, valid = vmap(one)(
            poses[obs_pose], T_SC[obs_cam], hp_W[obs_lm], obs_uv, obs_sqrt_info,
            cams.fxfycxcy[obs_cam], cams.dist_params[obs_cam],
        )
    # pose Jacobian at column 6 * pose, extrinsics at 12 + 6 * camera
    Jrow = torch.zeros((N, 2, P), dtype=dtype, device=dev)
    ar6 = torch.arange(6, device=dev)
    Jrow.scatter_(2, (obs_pose[:, None] * 6 + ar6)[:, None, :].expand(N, 2, 6), Jp)
    Jrow.scatter_(2, (12 + obs_cam[:, None] * 6 + ar6)[:, None, :].expand(N, 2, 6), Je)

    m = (valid & obs_mask & lm_mask[obs_lm]).to(dtype)
    s = torch.sum(r * r, dim=-1)
    w = robust.weight(robust.CAUCHY, s, cauchy_scale) * m
    sw = torch.sqrt(w)[:, None]
    Jrow = Jrow * sw[..., None]
    Jh = Jh * sw[..., None]

    # Schur out the landmarks from the (12 + 6C)-wide system
    Jf = Jrow.reshape(-1, P)
    H = Jf.T @ Jf
    H_ll = torch.zeros((L, 3, 3), dtype=dtype, device=dev).index_add_(
        0, obs_lm, torch.einsum("nri,nrj->nij", Jh, Jh)
    )
    W = torch.zeros((L, P, 3), dtype=dtype, device=dev).index_add_(
        0, obs_lm, torch.einsum("nrp,nri->npi", Jrow, Jh)
    )
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    lm_ok = (torch.diagonal(H_ll, dim1=-2, dim2=-1).sum(-1) > 1e-9) & lm_mask
    H_ll_inv = torch.linalg.inv(H_ll + 1e-8 * eye3) * lm_ok.to(dtype)[:, None, None]
    H = H - torch.einsum("lpi,lij,lqj->pq", W, H_ll_inv, W)

    # reparametrise the pose block to (delta_a, delta_rel); extrinsics stay
    T_ab = se3.se3_multiply(se3.se3_inverse(T_WS_a), T_WS_b)

    def to_abs(da, drel):
        Ta = se3.retract(T_WS_a, da)
        Tb = se3.se3_multiply(Ta, se3.retract(T_ab, drel))
        return torch.cat([da, se3.local_delta(T_WS_b, Tb)])

    with forward_ad.LOCK:
        Aa, Ar = jacfwd(to_abs, argnums=(0, 1))(z6, z6)
    A = torch.zeros((P, P), dtype=dtype, device=dev)
    A[:12, :6] = Aa
    A[:12, 6:12] = Ar
    A[12:, 12:] = torch.eye(6 * C, dtype=dtype, device=dev)
    Hy = A.T @ H @ A

    # marginalise the gauge block (delta_a) and the extrinsics together
    drop = torch.cat([torch.arange(6, device=dev), torch.arange(12, P, device=dev)])
    H_dd = Hy[drop][:, drop]
    H_dr = Hy[drop][:, 6:12]
    H_rel = Hy[6:12, 6:12] - H_dr.T @ _pinv_psd(H_dd) @ H_dr
    return (T_ab,) + _sqrt_information(H_rel)
