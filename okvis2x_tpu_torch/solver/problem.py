"""Bundle-adjustment problem container (struct-of-arrays, fixed capacity).

Torch counterpart of ``okvis2x_tpu/solver/problem.py``.  The sliding-window
problem is a set of fixed-capacity tensors with validity masks; graph
surgery is index/mask rewrites on the host.

Capacities: K frames, L landmarks, C cameras, N observations, M IMU links,
R relative-pose edges, G GNSS rows, Q submap-ICP points.  Reduced (frame) system layout,
dimension P = K*15 + C*6 + 4:
    frame k: [k*15 : k*15+6] pose tangent, [k*15+6 : k*15+15] speed/bias
    camera c extrinsics: [K*15 + c*6 : K*15 + (c+1)*6]
    4-dof world->GNSS alignment T_GW: the last 4 columns
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.factors.gps import retract_4dof
from okvis2x_tpu_torch.imu.preintegration import Preintegrated


class BAProblem(NamedTuple):
    # -- frame states -------------------------------------------------------
    T_WS: torch.Tensor  # (K, 7)
    sb: torch.Tensor  # (K, 9) [v_W, b_g, b_a]
    frame_valid: torch.Tensor  # (K,) bool
    pose_fixed: torch.Tensor  # (K,) bool
    sb_fixed: torch.Tensor  # (K,) bool
    # -- extrinsics ---------------------------------------------------------
    T_SC: torch.Tensor  # (C, 7)
    ext_fixed: torch.Tensor  # (C,) bool
    ext_prior_T: torch.Tensor  # (C, 7)
    ext_prior_sqrt_info: torch.Tensor  # (C, 6, 6)
    ext_prior_valid: torch.Tensor  # (C,) bool
    # -- landmarks ----------------------------------------------------------
    hp_W: torch.Tensor  # (L, 4) homogeneous
    lm_valid: torch.Tensor  # (L,) bool
    lm_fixed: torch.Tensor  # (L,) bool
    # -- reprojection observations -----------------------------------------
    obs_frame: torch.Tensor  # (N,) int
    obs_cam: torch.Tensor  # (N,) int
    obs_lm: torch.Tensor  # (N,) int
    obs_uv: torch.Tensor  # (N, 2)
    obs_sqrt_info: torch.Tensor  # (N,) 1/sigma_px
    obs_valid: torch.Tensor  # (N,) bool
    obs_depth: torch.Tensor  # (N,)
    obs_depth_si: torch.Tensor  # (N,)
    obs_depth_valid: torch.Tensor  # (N,) bool
    # -- IMU links ----------------------------------------------------------
    imu_i: torch.Tensor  # (M,) int
    imu_j: torch.Tensor  # (M,) int
    imu_pre: Preintegrated  # batched (M, ...)
    imu_sqrt_info: torch.Tensor  # (M, 15, 15)
    imu_valid: torch.Tensor  # (M,) bool
    # -- unary priors -------------------------------------------------------
    pose_prior_T: torch.Tensor  # (K, 7)
    pose_prior_sqrt_info: torch.Tensor  # (K, 6, 6)
    pose_prior_valid: torch.Tensor  # (K,) bool
    sb_prior: torch.Tensor  # (K, 9)
    sb_prior_sqrt_info: torch.Tensor  # (K, 9, 9)
    sb_prior_valid: torch.Tensor  # (K,) bool
    # -- relative pose edges ------------------------------------------------
    rel_i: torch.Tensor  # (R,) int
    rel_j: torch.Tensor  # (R,) int
    rel_T: torch.Tensor  # (R, 7)
    rel_sqrt_info: torch.Tensor  # (R, 6, 6)
    rel_valid: torch.Tensor  # (R,) bool
    # -- GNSS alignment + position rows -------------------------------------
    T_GW: torch.Tensor  # (7,)
    tgw_fixed: torch.Tensor  # () bool
    gps_frame: torch.Tensor  # (G,) int
    gps_pre: Preintegrated  # batched (G, ...)
    gps_p_G: torch.Tensor  # (G, 3)
    gps_r_SA: torch.Tensor  # (3,)
    gps_sqrt_info: torch.Tensor  # (G, 3, 3)
    gps_valid: torch.Tensor  # (G,) bool
    # -- per-point submap ICP rows (the reference's live SubmapIcpError
    # factors): each point, measured in the body frame of window frame
    # icp_b, against the occupancy field of `icp_map` (a mapping.submap
    # Submap) whose anchor is window frame icp_a; both poses iterate in the
    # solve.  The grid's config travels in SolverConfig.icp_cfg. -----------
    icp_a: torch.Tensor | None = None  # (Q,) int anchor frame
    icp_b: torch.Tensor | None = None  # (Q,) int point-owner frame
    icp_p_B: torch.Tensor | None = None  # (Q, 3) points in the owner's body frame
    icp_si: torch.Tensor | None = None  # (Q,) residual whitening (1 / sigma)
    icp_valid: torch.Tensor | None = None  # (Q,) bool
    icp_map: object = None

    @property
    def K(self) -> int:
        return self.T_WS.shape[0]

    @property
    def C(self) -> int:
        return self.T_SC.shape[0]

    @property
    def L(self) -> int:
        return self.hp_W.shape[0]

    @property
    def P(self) -> int:
        return self.K * 15 + self.C * 6 + 4


def empty_pre(M: int, dtype, device=None) -> Preintegrated:
    kw = dict(dtype=dtype, device=device)
    z3 = torch.zeros((M, 3), **kw)
    z33 = torch.zeros((M, 3, 3), **kw)
    return Preintegrated(
        dq=se3.quat_identity(**kw).repeat(M, 1),
        dp=z3, dv=z3.clone(), dp_dbg=z33, dp_dba=z33.clone(),
        dv_dbg=z33.clone(), dv_dba=z33.clone(), dq_dbg=z33.clone(),
        P=torch.eye(15, **kw).repeat(M, 1, 1),
        dt=torch.zeros((M,), **kw),
        lin_bg=z3.clone(), lin_ba=z3.clone(),
    )


def empty_problem(
    K: int, L: int, C: int, N: int, M: int, R: int = 0, G: int = 0, Q: int = 0,
    dtype=torch.float64, device=None,
) -> BAProblem:
    """Allocate an all-invalid problem of the given capacities."""
    kw = dict(dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    b = dict(dtype=torch.bool, device=device)
    idq = se3.se3_identity(**kw).repeat(K, 1)
    return BAProblem(
        T_WS=idq,
        sb=torch.zeros((K, 9), **kw),
        frame_valid=torch.zeros((K,), **b),
        pose_fixed=torch.zeros((K,), **b),
        sb_fixed=torch.zeros((K,), **b),
        T_SC=se3.se3_identity(**kw).repeat(C, 1),
        ext_fixed=torch.ones((C,), **b),
        ext_prior_T=se3.se3_identity(**kw).repeat(C, 1),
        ext_prior_sqrt_info=torch.eye(6, **kw).repeat(C, 1, 1),
        ext_prior_valid=torch.zeros((C,), **b),
        hp_W=torch.tensor([0.0, 0, 0, 1], **kw).repeat(L, 1),
        lm_valid=torch.zeros((L,), **b),
        lm_fixed=torch.zeros((L,), **b),
        obs_frame=torch.zeros((N,), **i64),
        obs_cam=torch.zeros((N,), **i64),
        obs_lm=torch.zeros((N,), **i64),
        obs_uv=torch.zeros((N, 2), **kw),
        obs_sqrt_info=torch.ones((N,), **kw),
        obs_valid=torch.zeros((N,), **b),
        obs_depth=torch.ones((N,), **kw),
        obs_depth_si=torch.ones((N,), **kw),
        obs_depth_valid=torch.zeros((N,), **b),
        imu_i=torch.zeros((M,), **i64),
        imu_j=torch.zeros((M,), **i64),
        imu_pre=empty_pre(M, dtype, device),
        imu_sqrt_info=torch.eye(15, **kw).repeat(M, 1, 1),
        imu_valid=torch.zeros((M,), **b),
        pose_prior_T=idq.clone(),
        pose_prior_sqrt_info=torch.eye(6, **kw).repeat(K, 1, 1),
        pose_prior_valid=torch.zeros((K,), **b),
        sb_prior=torch.zeros((K, 9), **kw),
        sb_prior_sqrt_info=torch.eye(9, **kw).repeat(K, 1, 1),
        sb_prior_valid=torch.zeros((K,), **b),
        rel_i=torch.zeros((R,), **i64),
        rel_j=torch.zeros((R,), **i64),
        rel_T=se3.se3_identity(**kw).repeat(R, 1),
        rel_sqrt_info=torch.eye(6, **kw).repeat(R, 1, 1),
        rel_valid=torch.zeros((R,), **b),
        T_GW=se3.se3_identity(**kw),
        tgw_fixed=torch.ones((), **b),
        gps_frame=torch.zeros((G,), **i64),
        gps_pre=empty_pre(G, dtype, device),
        gps_p_G=torch.zeros((G, 3), **kw),
        gps_r_SA=torch.zeros((3,), **kw),
        gps_sqrt_info=torch.eye(3, **kw).repeat(G, 1, 1),
        gps_valid=torch.zeros((G,), **b),
        icp_a=torch.zeros((Q,), **i64) if Q else None,
        icp_b=torch.zeros((Q,), **i64) if Q else None,
        icp_p_B=torch.zeros((Q, 3), **kw) if Q else None,
        icp_si=torch.ones((Q,), **kw) if Q else None,
        icp_valid=torch.zeros((Q,), **b) if Q else None,
        icp_map=None,
    )


def free_mask(p: BAProblem) -> torch.Tensor:
    """(P,) bool — which reduced-system parameters are free to move."""
    pose_free = p.frame_valid & ~p.pose_fixed
    sb_free = p.frame_valid & ~p.sb_fixed
    per_frame = torch.cat(
        [pose_free[:, None].expand(-1, 6), sb_free[:, None].expand(-1, 9)], dim=1
    ).reshape(-1)
    ext_free = (~p.ext_fixed)[:, None].expand(-1, 6).reshape(-1)
    tgw_free = (~p.tgw_fixed).reshape(1).expand(4)
    return torch.cat([per_frame, ext_free, tgw_free])


def apply_delta(p: BAProblem, dx: torch.Tensor, dl: torch.Tensor) -> BAProblem:
    """Retract the reduced-system step dx (P,) and landmark step dl (L, 3)."""
    K, C = p.K, p.C
    dframe = dx[: K * 15].reshape(K, 15)
    T_WS = se3.retract(p.T_WS, dframe[:, :6])
    sb = p.sb + dframe[:, 6:]
    dext = dx[K * 15: K * 15 + C * 6].reshape(C, 6)
    T_SC = se3.retract(p.T_SC, dext)
    T_GW = retract_4dof(p.T_GW, dx[K * 15 + C * 6:])
    hp = torch.cat([p.hp_W[:, :3] + dl, p.hp_W[:, 3:]], dim=1)
    return p._replace(T_WS=T_WS, sb=sb, T_SC=T_SC, T_GW=T_GW, hp_W=hp)
