"""Batched Gauss-Newton / Levenberg-Marquardt with Schur landmark elimination.

Torch counterpart of ``okvis2x_tpu/solver/gauss_newton.py``:

  * every factor family is linearised in one ``vmap`` of ``jacfwd`` through
    the manifold retraction at zero increment;
  * the reprojection rows are scattered into dense rows of a tall (n_res, P)
    matrix (frame and extrinsics columns), so their H_ff = J^T J is one
    matrix product; the small families (priors, IMU links, relative-pose
    edges, GNSS fixes, extrinsics priors) add block products at the columns
    of their parameter blocks;
  * landmark blocks are accumulated per landmark with ``index_add_`` and
    eliminated by a batched Schur complement with closed-form 3x3 inverses;
  * robustification is IRLS with the sqrt(rho') corrector;
  * per-keypoint depth priors (``use_depth``) share the observation rows
    and fold into the same Schur-eliminated landmark blocks;
  * per-point submap-ICP rows (``icp_cfg``) add one block on the anchor
    frame's pose and one on the point owner's pose per point;
  * the LM loop uses deferred accept/reject ("one linearisation per
    iteration") and an optional early exit on converged accepted steps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from okvis2x_tpu_torch.cameras.pinhole import Camera
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.factors import depth, gps, imu_factor, priors, reprojection, robust
from okvis2x_tpu_torch.imu.preintegration import ImuParams
from okvis2x_tpu_torch.mapping import icp_factor
from okvis2x_tpu_torch.solver.problem import BAProblem, apply_delta, free_mask
from okvis2x_tpu_torch.utils import forward_ad


@dataclasses.dataclass(frozen=True)
class StackedCameras:
    """Per-rig camera intrinsics stacked for gather-by-observation."""

    fxfycxcy: torch.Tensor  # (C, 4)
    dist_params: torch.Tensor  # (C, Pd)
    width: int
    height: int
    model: str

    def at(self, idx) -> Camera:
        return Camera(
            fxfycxcy=self.fxfycxcy[idx], dist_params=self.dist_params[idx],
            width=self.width, height=self.height, model=self.model,
        )

    def to(self, device=None, dtype=None) -> "StackedCameras":
        return dataclasses.replace(
            self,
            fxfycxcy=self.fxfycxcy.to(device=device, dtype=dtype),
            dist_params=self.dist_params.to(device=device, dtype=dtype),
        )


def stack_cameras(cams) -> StackedCameras:
    models = {c.model for c in cams}
    if len(models) != 1:
        raise ValueError("stacked cameras need a uniform distortion model")
    return StackedCameras(
        fxfycxcy=torch.stack([c.fxfycxcy for c in cams]),
        dist_params=torch.stack([c.dist_params for c in cams]),
        width=cams[0].width, height=cams[0].height, model=cams[0].model,
    )


class SolverConfig(NamedTuple):
    max_iterations: int = 10
    reproj_loss: str = robust.CAUCHY
    reproj_loss_scale: float = 1.0  # on whitened (unit-sigma) residuals
    init_lambda: float = 1e-6
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    estimate_landmarks: bool = True
    imu_params: ImuParams = ImuParams()
    # > 0: stop once an accepted step's relative cost decrease falls below
    # this tolerance (after early_min_iterations iterations)
    early_exit_rel: float = 0.0
    early_min_iterations: int = 2
    rel_loss: str = robust.NONE
    rel_loss_scale: float = 10.0
    # online extrinsics calibration: add the T_SC prior rows
    use_ext_priors: bool = False
    # per-keypoint depth priors (the reference's one-sided DepthError);
    # use_depth adds their rows (the caller knows whether any is valid)
    depth_onesided: bool = True
    use_depth: bool = False
    # the grid config (mapping.submap.SubmapConfig) of the problem's icp_map;
    # None leaves the per-point submap-ICP rows out
    icp_cfg: object = None


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------


def _accumulate_blocks(H: torch.Tensor, b: torch.Tensor, r: torch.Tensor, blocks,
                       valid: torch.Tensor):
    """Add a factor family given as Jacobian blocks to the reduced normal
    equations in place: H += J^T J, b -= J^T r, with J the rows (n, d, P)
    that the blocks [(J (n, d, w), first column (n,)), ...] span (blocks on
    the same columns add up; the cross products of a row's blocks land
    off the diagonal).  A frame block is 15 wide at column 15 * slot, a T_GW
    block 4 wide at P - 4, an extrinsics block 6 wide at K * 15 + 6 * c.
    Block products instead of the dense rows keep a pose graph of hundreds
    of nodes at O(n) work."""
    m = valid.to(r.dtype)
    r = r * m[:, None]
    n = r.shape[0]
    idx = [(J * m[:, None, None], c0[:, None] + torch.arange(J.shape[-1], device=r.device))
           for J, c0 in blocks]
    for Ja, rows in idx:
        b.index_add_(0, rows.reshape(-1), -torch.einsum("nri,nr->ni", Ja, r).reshape(-1))
        for Jb, cols in idx:
            Hab = torch.einsum("nri,nrj->nij", Ja, Jb)
            wa, wb = rows.shape[1], cols.shape[1]
            H.index_put_(
                (rows[:, :, None].expand(n, wa, wb).reshape(-1),
                 cols[:, None, :].expand(n, wa, wb).reshape(-1)),
                Hab.reshape(-1), accumulate=True,
            )


def _pad15(J: torch.Tensor, col0: int) -> torch.Tensor:
    """Zero-pad a (n, r, w) block into the 15-wide frame layout at `col0`."""
    n, r, w = J.shape
    return torch.nn.functional.pad(J, (col0, 15 - col0 - w))


def _linearize_reprojection(p: BAProblem, cams: StackedCameras):
    """Per-observation (r (N,2), Jrow (N,2,P), Jh (N,2,3), valid (N,))."""
    K, P = p.K, p.P
    f, c, l = p.obs_frame, p.obs_cam, p.obs_lm

    def one(T_WS, T_SC, hp, uv, si, kc, dp):
        cam = Camera(kc, dp, cams.width, cams.height, cams.model)
        return reprojection.linearize(cam, T_WS, T_SC, hp, uv, si)

    with forward_ad.LOCK:
        r, Jp, Jh, Je, valid = vmap(one)(
            p.T_WS[f], p.T_SC[c], p.hp_W[l], p.obs_uv, p.obs_sqrt_info,
            cams.fxfycxcy[c], cams.dist_params[c],
        )
    N = r.shape[0]
    Jrow = torch.zeros((N, 2, P), dtype=r.dtype, device=r.device)
    ar6 = torch.arange(6, device=r.device)
    cols_f = (f[:, None] * 15 + ar6)[:, None, :].expand(N, 2, 6)
    cols_e = (K * 15 + c[:, None] * 6 + ar6)[:, None, :].expand(N, 2, 6)
    Jrow.scatter_(2, cols_f, Jp)
    Jrow.scatter_(2, cols_e, Je)
    return r, Jrow, Jh, valid & p.obs_valid


def _linearize_depth(p: BAProblem, cfg: SolverConfig):
    """Depth priors on the observation rows: (r (N,1), Jrow (N,1,P),
    Jh (N,1,3), valid (N,))."""
    K, P = p.K, p.P
    f, c = p.obs_frame, p.obs_cam

    def one(T_WS, T_SC, hp, d, si):
        return depth.linearize(T_WS, T_SC, hp, d, si, cfg.depth_onesided)

    with forward_ad.LOCK:
        r, Jp, Jl, Je = vmap(one)(p.T_WS[f], p.T_SC[c], p.hp_W[p.obs_lm], p.obs_depth,
                                  p.obs_depth_si)
    N = r.shape[0]
    Jrow = torch.zeros((N, 1, P), dtype=r.dtype, device=r.device)
    ar6 = torch.arange(6, device=r.device)
    Jrow.scatter_(2, (f[:, None] * 15 + ar6)[:, None, :], Jp[:, None, :])
    Jrow.scatter_(2, (K * 15 + c[:, None] * 6 + ar6)[:, None, :], Je[:, None, :])
    return r[:, None], Jrow, Jl[:, None, :], p.obs_depth_valid & p.obs_valid


def _linearize_imu(p: BAProblem, cfg: SolverConfig):
    dtype, dev = p.T_WS.dtype, p.T_WS.device
    z6 = torch.zeros(6, dtype=dtype, device=dev)
    z9 = torch.zeros(9, dtype=dtype, device=dev)

    def one(T0, sb0, T1, sb1, pre, si):
        def f(d0, dsb0, d1, dsb1):
            r = imu_factor.residual_on_manifold(
                cfg.imu_params, pre, si, T0, sb0, T1, sb1, d0, dsb0, d1, dsb1
            )
            return r, r

        (J0, Jsb0, J1, Jsb1), r = jacfwd(f, argnums=(0, 1, 2, 3), has_aux=True)(
            z6, z9, z6, z9
        )
        return r, torch.cat([J0, Jsb0], dim=1), torch.cat([J1, Jsb1], dim=1)

    i, j = p.imu_i, p.imu_j
    with forward_ad.LOCK:
        r, Ji, Jj = vmap(one)(
            p.T_WS[i], p.sb[i], p.T_WS[j], p.sb[j], p.imu_pre, p.imu_sqrt_info
        )
    return r, [(Ji, i * 15), (Jj, j * 15)], p.imu_valid


def _pose_priors(T: torch.Tensor, T_prior: torch.Tensor, si: torch.Tensor):
    """Batched pose priors (n, 7) and their minimal Jacobians: (r (n, 6),
    J (n, 6, 6))."""
    z6 = torch.zeros(6, dtype=T.dtype, device=T.device)

    def one(T1, Tp, si1):
        def f(d):
            r = priors.pose_prior_residual(Tp, se3.retract(T1, d), si1)
            return r, r

        J, r = jacfwd(f, has_aux=True)(z6)
        return r, J

    with forward_ad.LOCK:
        return vmap(one)(T, T_prior, si)


def _linearize_priors(p: BAProblem):
    c0 = torch.arange(p.K, device=p.T_WS.device) * 15
    r_pp, Jp = _pose_priors(p.T_WS, p.pose_prior_T, p.pose_prior_sqrt_info)
    r_sb = priors.speed_bias_prior_residual(p.sb_prior, p.sb, p.sb_prior_sqrt_info)
    return ((r_pp, [(_pad15(Jp, 0), c0)], p.pose_prior_valid),
            (r_sb, [(_pad15(p.sb_prior_sqrt_info, 6), c0)], p.sb_prior_valid))


def _linearize_gps(p: BAProblem, cfg: SolverConfig):
    """GNSS position rows: one block over the host frame's pose and
    speed/bias (15 columns) and one over the 4 T_GW columns."""
    dtype, dev = p.T_WS.dtype, p.T_WS.device
    z6 = torch.zeros(6, dtype=dtype, device=dev)
    z9 = torch.zeros(9, dtype=dtype, device=dev)
    z4 = torch.zeros(4, dtype=dtype, device=dev)

    def one(T_WS, sb, pre, p_G, si):
        def f(dpose, dsb, d4):
            r = gps.residual_async_on_manifold(cfg.imu_params, pre, p.T_GW, T_WS, sb, p_G,
                                               p.gps_r_SA, si, dpose, dsb, d4)
            return r, r

        (Jp, Jsb, J4), r = jacfwd(f, argnums=(0, 1, 2), has_aux=True)(z6, z9, z4)
        return r, torch.cat([Jp, Jsb], dim=1), J4

    fi = p.gps_frame
    with forward_ad.LOCK:
        r, Jf, J4 = vmap(one)(p.T_WS[fi], p.sb[fi], p.gps_pre, p.gps_p_G, p.gps_sqrt_info)
    return r, [(Jf, fi * 15), (J4, torch.full_like(fi, p.P - 4))], p.gps_valid


def _linearize_icp(p: BAProblem, cfg: SolverConfig):
    """Per-point submap-ICP rows (the reference's live SubmapIcpError): the
    residual of each point against the field of the submap anchored at
    window frame icp_a, with Jacobians on both the anchor's and the owner's
    pose, re-evaluated every iteration: (r (Q, 1), blocks, valid (Q,))."""
    z6 = torch.zeros(6, dtype=p.T_WS.dtype, device=p.T_WS.device)
    one_true = torch.ones((1,), dtype=torch.bool, device=p.T_WS.device)

    def one(T_a, T_b, pt, si):
        def f(da, db):
            r = icp_factor.icp_residuals(
                p.icp_map, cfg.icp_cfg, se3.retract(T_a, da), se3.retract(T_b, db),
                pt[None, :], one_true, sigma=1.0)[0][0] * si
            return r, r

        (Ja, Jb), r = jacfwd(f, argnums=(0, 1), has_aux=True)(z6, z6)
        return r, Ja, Jb

    a, b = p.icp_a, p.icp_b
    T_a, T_b = p.T_WS[a], p.T_WS[b]
    with forward_ad.LOCK:
        r, Ja, Jb = vmap(one)(T_a, T_b, p.icp_p_B, p.icp_si)
    # which rows count, at the poses themselves (the rows above are at the
    # retraction of a zero increment)
    _, use = icp_factor.icp_residuals(p.icp_map, cfg.icp_cfg, T_a, T_b, p.icp_p_B,
                                      torch.ones_like(p.icp_valid), sigma=1.0)
    return (r[:, None], [(_pad15(Ja[:, None, :], 0), a * 15), (_pad15(Jb[:, None, :], 0), b * 15)],
            use & p.icp_valid)


def _icp_enabled(p: BAProblem, cfg: SolverConfig) -> bool:
    return (cfg.icp_cfg is not None and p.icp_a is not None and p.icp_a.shape[0] > 0
            and p.icp_map is not None)


def _linearize_ext_priors(p: BAProblem):
    """Unary pose priors on the camera extrinsics T_SC (online calibration),
    in the columns K * 15 + 6 * c."""
    r, J = _pose_priors(p.T_SC, p.ext_prior_T, p.ext_prior_sqrt_info)
    c0 = p.K * 15 + torch.arange(p.C, device=r.device) * 6
    return r, [(J, c0)], p.ext_prior_valid


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3), Taylor-safe; batched (..., 3)."""
    th2 = torch.sum(phi * phi, dim=-1)
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    small = th2 < 1e-10
    c = torch.where(
        small,
        1.0 / 12.0 + th2 / 720.0,
        1.0 / torch.clamp(th2, min=1e-24)
        - (1.0 + torch.cos(th)) / torch.clamp(2.0 * th * torch.sin(th), min=1e-24),
    )
    px = se3.cross_matrix(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * px + c[..., None, None] * (px @ px)


def rel_residual_jacobians(T_A, T_B, Trel, si):
    """Whitened relative-pose residual + closed-form minimal Jacobians,
    batched over edges: returns (r (..., 6), Ji (..., 6, 6), Jj (..., 6, 6))."""
    q_A = se3.se3_q(T_A)
    R_AT = se3.quat_to_matrix(se3.quat_conjugate(q_A))
    D = se3.se3_t(T_B) - se3.se3_t(T_A)
    t_AB = _mv(R_AT, D)
    q_AB = se3.quat_multiply(se3.quat_conjugate(q_A), se3.se3_q(T_B))
    e0 = se3.quat_multiply(q_AB, se3.quat_conjugate(se3.se3_q(Trel)))
    phi = se3.quat_log(e0)
    r = _mv(si, torch.cat([t_AB - se3.se3_t(Trel), phi], dim=-1))
    JlR = _so3_left_jacobian_inv(phi) @ R_AT
    Z = torch.zeros_like(R_AT)
    top_i = torch.cat([-R_AT, R_AT @ se3.cross_matrix(D)], dim=-1)
    bot_i = torch.cat([Z, -JlR], dim=-1)
    Ji = si @ torch.cat([top_i, bot_i], dim=-2)
    top_j = torch.cat([R_AT, Z], dim=-1)
    bot_j = torch.cat([Z, JlR], dim=-1)
    Jj = si @ torch.cat([top_j, bot_j], dim=-2)
    return r, Ji, Jj


def _linearize_rel(p: BAProblem, cfg: SolverConfig):
    i, j = p.rel_i, p.rel_j
    r, Ji, Jj = rel_residual_jacobians(p.T_WS[i], p.T_WS[j], p.rel_T, p.rel_sqrt_info)
    if cfg.rel_loss != robust.NONE:
        s = torch.sum(r * r, dim=-1)
        sw = torch.sqrt(robust.weight(cfg.rel_loss, s, cfg.rel_loss_scale))
        r = r * sw[:, None]
        Ji = Ji * sw[:, None, None]
        Jj = Jj * sw[:, None, None]
    return r, [(_pad15(Ji, 0), i * 15), (_pad15(Jj, 0), j * 15)], p.rel_valid


class Linearization(NamedTuple):
    H_ff: torch.Tensor  # (P, P)
    b_f: torch.Tensor  # (P,)
    H_ll: torch.Tensor  # (L, 3, 3)
    b_l: torch.Tensor  # (L, 3)
    W: torch.Tensor  # (L, P, 3) frame-landmark coupling
    lm_free: torch.Tensor  # (L,)
    cost: torch.Tensor  # robustified total cost


def linearize(p: BAProblem, cams: StackedCameras, cfg: SolverConfig) -> Linearization:
    dtype = p.T_WS.dtype
    P, L = p.P, p.L

    r_o, Jrow_o, Jh_o, valid_o = _linearize_reprojection(p, cams)
    s = torch.sum(r_o * r_o, dim=-1)
    vf = valid_o.to(dtype)
    w = robust.weight(cfg.reproj_loss, s, cfg.reproj_loss_scale) * vf
    cost = 0.5 * torch.sum(robust.rho(cfg.reproj_loss, s, cfg.reproj_loss_scale) * vf)
    sw = torch.sqrt(w)[:, None]
    r_o = r_o * sw
    Jh_o = Jh_o * sw[..., None]
    fmask = free_mask(p).to(dtype)
    Jrow_o = Jrow_o * sw[..., None] * fmask

    Jo = Jrow_o.reshape(-1, P)
    ro = r_o.reshape(-1)
    H_ff = Jo.T @ Jo
    b_f = -(Jo.T @ ro)

    lm_free = p.lm_valid & ~p.lm_fixed
    if not cfg.estimate_landmarks:
        lm_free = torch.zeros_like(lm_free)
    Jh_o = Jh_o * lm_free.to(dtype)[p.obs_lm][:, None, None]

    # landmark blocks: per-observation products summed per landmark
    HtJ = torch.einsum("nri,nrj->nij", Jh_o, Jh_o)
    H_ll = torch.zeros((L, 3, 3), dtype=dtype, device=HtJ.device).index_add_(
        0, p.obs_lm, HtJ
    )
    b_l = -torch.zeros((L, 3), dtype=dtype, device=HtJ.device).index_add_(
        0, p.obs_lm, torch.einsum("nri,nr->ni", Jh_o, r_o)
    )
    Wn = torch.einsum("nrp,nri->npi", Jrow_o, Jh_o)
    W = torch.zeros((L, P, 3), dtype=dtype, device=HtJ.device).index_add_(
        0, p.obs_lm, Wn
    )

    # depth priors: the same observation rows, folded into the same blocks
    if cfg.use_depth:
        r_d, Jrow_d, Jh_d, valid_d = _linearize_depth(p, cfg)
        md = valid_d.to(dtype)[:, None]
        r_d = r_d * md
        Jrow_d = Jrow_d * md[..., None] * fmask
        Jh_d = Jh_d * md[..., None] * lm_free.to(dtype)[p.obs_lm][:, None, None]
        Jd = Jrow_d.reshape(-1, P)
        rd = r_d.reshape(-1)
        H_ff = H_ff + Jd.T @ Jd
        b_f = b_f - Jd.T @ rd
        cost = cost + 0.5 * torch.sum(rd * rd)
        H_ll.index_add_(0, p.obs_lm, torch.einsum("nri,nrj->nij", Jh_d, Jh_d))
        b_l.index_add_(0, p.obs_lm, -torch.einsum("nri,nr->ni", Jh_d, r_d))
        W.index_add_(0, p.obs_lm, torch.einsum("nrp,nri->npi", Jrow_d, Jh_d))

    # priors, IMU links, relative-pose edges, GNSS fixes, extrinsics priors
    # and submap-ICP points: blocks added to the reduced system (the columns of frozen
    # parameters are cleared by the gauge fixing below); families of zero
    # capacity are skipped
    fams = list(_linearize_priors(p))
    if p.imu_i.shape[0]:
        fams.append(_linearize_imu(p, cfg))
    if p.rel_i.shape[0]:
        fams.append(_linearize_rel(p, cfg))
    if p.gps_frame.shape[0]:
        fams.append(_linearize_gps(p, cfg))
    if cfg.use_ext_priors:
        fams.append(_linearize_ext_priors(p))
    if _icp_enabled(p, cfg):
        fams.append(_linearize_icp(p, cfg))
    for r_, blocks, v_ in fams:
        _accumulate_blocks(H_ff, b_f, r_, blocks, v_)
        cost = cost + 0.5 * torch.sum((r_ * v_.to(dtype)[:, None]) ** 2)

    # gauge fixing for frozen / invalid parameters
    fb = fmask > 0
    H_ff = torch.where(fb[:, None] & fb[None, :], H_ff, torch.zeros_like(H_ff))
    H_ff = H_ff + torch.diag((~fb).to(dtype))
    b_f = b_f * fmask
    return Linearization(H_ff, b_f, H_ll, b_l, W, lm_free, cost)


def compute_cost(p: BAProblem, cams: StackedCameras, cfg: SolverConfig) -> torch.Tensor:
    """Robustified total cost without Jacobians."""
    dtype = p.T_WS.dtype
    f, c, l = p.obs_frame, p.obs_cam, p.obs_lm
    r_o, valid = reprojection.residual(
        cams.at(c), p.T_WS[f], p.T_SC[c], p.hp_W[l], p.obs_uv, p.obs_sqrt_info
    )
    valid = (valid & p.obs_valid).to(dtype)
    s = torch.sum(r_o * r_o, dim=-1)
    cost = 0.5 * torch.sum(robust.rho(cfg.reproj_loss, s, cfg.reproj_loss_scale) * valid)

    if cfg.use_depth:
        r_d = depth.residual(p.T_WS[f], p.T_SC[c], p.hp_W[l], p.obs_depth, p.obs_depth_si,
                             cfg.depth_onesided)
        vd = (p.obs_depth_valid & p.obs_valid).to(dtype)
        cost = cost + 0.5 * torch.sum((r_d * vd) ** 2)

    if p.imu_i.shape[0]:
        i, j = p.imu_i, p.imu_j
        r_i = imu_factor.residual(
            cfg.imu_params, p.imu_pre, p.imu_sqrt_info,
            p.T_WS[i], p.sb[i], p.T_WS[j], p.sb[j],
        )
        cost = cost + 0.5 * torch.sum((r_i * p.imu_valid.to(dtype)[:, None]) ** 2)

    r_pp = priors.pose_prior_residual(p.pose_prior_T, p.T_WS, p.pose_prior_sqrt_info)
    cost = cost + 0.5 * torch.sum((r_pp * p.pose_prior_valid.to(dtype)[:, None]) ** 2)
    r_sb = priors.speed_bias_prior_residual(p.sb_prior, p.sb, p.sb_prior_sqrt_info)
    cost = cost + 0.5 * torch.sum((r_sb * p.sb_prior_valid.to(dtype)[:, None]) ** 2)

    if p.rel_i.shape[0]:
        r_r = priors.relative_pose_residual(
            p.rel_T, p.T_WS[p.rel_i], p.T_WS[p.rel_j], p.rel_sqrt_info
        )
        s_r = torch.sum(r_r * r_r, dim=-1) * p.rel_valid.to(dtype)
        cost = cost + 0.5 * torch.sum(robust.rho(cfg.rel_loss, s_r, cfg.rel_loss_scale))

    if p.gps_frame.shape[0]:
        fi = p.gps_frame
        r_g = gps.residual_async(cfg.imu_params, p.gps_pre, p.T_GW, p.T_WS[fi], p.sb[fi],
                                 p.gps_p_G, p.gps_r_SA, p.gps_sqrt_info)
        cost = cost + 0.5 * torch.sum((r_g * p.gps_valid.to(dtype)[:, None]) ** 2)

    if cfg.use_ext_priors:
        r_e = priors.pose_prior_residual(p.ext_prior_T, p.T_SC, p.ext_prior_sqrt_info)
        cost = cost + 0.5 * torch.sum((r_e * p.ext_prior_valid.to(dtype)[:, None]) ** 2)

    if _icp_enabled(p, cfg):
        # every row's own poses: the same arithmetic as one point at a time
        r_icp, use_icp = icp_factor.icp_residuals(
            p.icp_map, cfg.icp_cfg, p.T_WS[p.icp_a], p.T_WS[p.icp_b], p.icp_p_B,
            torch.ones_like(p.icp_valid), sigma=1.0)
        m = (use_icp & p.icp_valid).to(dtype)
        cost = cost + 0.5 * torch.sum((r_icp * p.icp_si * m) ** 2)
    return cost


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    co_d = -(b * i - c * h)
    co_e = a * i - c * g
    co_f = -(a * h - b * g)
    co_g = b * f - c * e
    co_h = -(a * f - c * d)
    co_i = a * e - b * d
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, co_d, co_g], dim=-1),
            torch.stack([co_b, co_e, co_h], dim=-1),
            torch.stack([co_c, co_f, co_i], dim=-1),
        ],
        dim=-2,
    )
    safe = torch.where(det.abs() > torch.finfo(m.dtype).tiny, det, torch.ones_like(det))
    return adj / safe[..., None, None]


def solve_normal_equations(lin: Linearization, lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Schur-complement solve: returns (dx (P,), dl (L, 3))."""
    dtype, dev = lin.H_ff.dtype, lin.H_ff.device
    P = lin.H_ff.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    lm_free_f = lin.lm_free.to(dtype)[:, None, None]
    tr = torch.diagonal(lin.H_ll, dim1=-2, dim2=-1).sum(-1)
    H_ll_d = lin.H_ll + (lam + 1e-12) * tr[:, None, None] / 3.0 * eye3 + 1e-10 * eye3
    H_ll_inv = _inv3x3(H_ll_d) * lm_free_f

    # Schur complement onto the frame system
    WHinv = torch.einsum("lpi,lij->lpj", lin.W, H_ll_inv)
    H_red = lin.H_ff - torch.einsum("lpi,lqi->pq", WHinv, lin.W)
    b_red = lin.b_f - torch.einsum("lpi,li->p", WHinv, lin.b_l)

    # Marquardt damping on the reduced system
    diag = torch.diagonal(H_red)
    H_red = H_red + torch.diag(lam * diag + 1e-12)

    # Jacobi-scaled solve (unit diagonal keeps the mixed-unit system sane)
    d = torch.sqrt(torch.clamp(torch.diagonal(H_red).abs(), min=1e-20))
    Dinv = 1.0 / d
    Hs = H_red * Dinv[:, None] * Dinv[None, :]
    bs = b_red * Dinv
    if P <= 1024:
        dy = torch.linalg.inv(Hs) @ bs
    else:
        # large problems: 256 steps of conjugate gradients on the scaled system
        x, r, pv = torch.zeros_like(bs), bs, bs
        rs = bs @ bs
        for _ in range(256):
            Hp = Hs @ pv
            alpha = rs / torch.clamp(pv @ Hp, min=1e-30)
            x = x + alpha * pv
            r = r - alpha * Hp
            rs_new = r @ r
            pv = r + (rs_new / torch.clamp(rs, min=1e-30)) * pv
            rs = rs_new
        dy = x
    dx = dy * Dinv
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))

    # back-substitute landmarks; guard rank-deficient blocks
    dl = torch.einsum(
        "lij,lj->li", H_ll_inv, lin.b_l - torch.einsum("lpi,p->li", lin.W, dx)
    )
    ok = torch.isfinite(dl).all(dim=1) & (tr > 10 * torch.finfo(dtype).tiny)
    dl = torch.where(ok[:, None], dl, torch.zeros_like(dl))
    return dx, dl


_STATE = ("T_WS", "sb", "T_SC", "hp_W", "T_GW")


def optimize(p: BAProblem, cams: StackedCameras, cfg: SolverConfig) -> Tuple[BAProblem, torch.Tensor]:
    """LM with deferred accept/reject: one linearisation per iteration, whose
    cost doubles as the accept test of the previous step.  Returns the
    optimised problem and the final robust cost."""
    dtype, dev = p.T_WS.dtype, p.T_WS.device

    def state(prob):
        return tuple(getattr(prob, k) for k in _STATE)

    def inject(params):
        return p._replace(**dict(zip(_STATE, params)))

    def select(cond, a, b):
        return tuple(torch.where(cond, x, y) for x, y in zip(a, b))

    params = backup = state(p)
    lam = torch.tensor(cfg.init_lambda, dtype=dtype, device=dev)
    best_cost = torch.tensor(float("inf"), dtype=dtype, device=dev)
    for it in range(cfg.max_iterations):
        prev_best = best_cost
        prob = inject(params)
        lin = linearize(prob, cams, cfg)
        accept = lin.cost <= best_cost
        backup = select(accept, params, backup)
        best_cost = torch.minimum(lin.cost, best_cost)
        lam = torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up)
        lam = torch.clamp(lam, 1e-10, 1e6)
        # on reject the linearisation is at the rejected point: only step
        # when accepted (the rejected iteration is spent raising lambda)
        dx, dl = solve_normal_equations(lin, lam)
        cand = state(apply_delta(prob, dx, dl))
        params = select(accept, cand, backup)
        if cfg.early_exit_rel > 0:
            # only an accepted, improving step can signal convergence
            rel = (prev_best - best_cost) / torch.clamp(prev_best, min=1e-30)
            done = (
                (it + 1 >= cfg.early_min_iterations)
                & torch.isfinite(prev_best)
                & (best_cost < prev_best)
                & (rel < cfg.early_exit_rel)
            )
            if bool(done):
                break
    # the final step was never cost-checked: return the last accepted point
    final_cost = compute_cost(inject(params), cams, cfg)
    take_last = final_cost <= best_cost
    params = select(take_last, params, backup)
    return inject(params), torch.minimum(final_cost, best_cost)
