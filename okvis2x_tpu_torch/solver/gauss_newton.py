"""Batched Gauss-Newton / Levenberg-Marquardt with Schur landmark elimination.

Torch counterpart of ``okvis2x_tpu/solver/gauss_newton.py``:

  * every factor family is linearised in one ``vmap`` of ``jacfwd`` through
    the manifold retraction at zero increment;
  * frame/extrinsic Jacobian blocks are scattered into dense rows of a tall
    (n_res, P) matrix, so H_ff = J^T J is one matrix product;
  * landmark blocks are accumulated per landmark with ``index_add_`` and
    eliminated by a batched Schur complement with closed-form 3x3 inverses;
  * robustification is IRLS with the sqrt(rho') corrector;
  * the LM loop uses deferred accept/reject ("one linearisation per
    iteration") and an optional early exit on converged accepted steps.

Depth, GNSS, online-extrinsics and submap-ICP rows are not part of the port
yet: a problem that carries any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from okvis2x_tpu_torch.cameras.pinhole import Camera
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.factors import imu_factor, priors, reprojection, robust
from okvis2x_tpu_torch.imu.preintegration import ImuParams
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


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _check_ported(p: BAProblem):
    if bool(p.obs_depth_valid.any()):
        raise NotImplementedError("depth priors are not ported yet")
    if bool(p.gps_valid.any()):
        raise NotImplementedError("GNSS factors are not ported yet")
    if bool((~p.ext_fixed).any()) or bool(p.ext_prior_valid.any()):
        raise NotImplementedError("online extrinsics calibration is not ported yet")


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------


def _accumulate_blocks(H: torch.Tensor, b: torch.Tensor, r: torch.Tensor, blocks,
                       valid: torch.Tensor):
    """Add a factor family given as per-frame Jacobian blocks to the frame
    normal equations in place: H += J^T J, b -= J^T r, with J the rows
    (n, d, P) that the blocks [(J (n, d, 15), frame index (n,)), ...] span
    (blocks on the same frame add up).  Block products instead of the dense
    rows keep a pose graph of hundreds of nodes at O(n) work."""
    m = valid.to(r.dtype)
    r = r * m[:, None]
    ar = torch.arange(15, device=r.device)
    n = r.shape[0]
    for Ja, ia in blocks:
        Ja = Ja * m[:, None, None]
        rows = ia[:, None] * 15 + ar
        b.index_add_(0, rows.reshape(-1), -torch.einsum("nri,nr->ni", Ja, r).reshape(-1))
        for Jb, ib in blocks:
            Hab = torch.einsum("nri,nrj->nij", Ja, Jb * m[:, None, None])
            cols = ib[:, None] * 15 + ar
            H.index_put_(
                (rows[:, :, None].expand(n, 15, 15).reshape(-1),
                 cols[:, None, :].expand(n, 15, 15).reshape(-1)),
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
    return r, [(Ji, i), (Jj, j)], p.imu_valid


def _linearize_priors(p: BAProblem):
    dtype, dev = p.T_WS.dtype, p.T_WS.device
    z6 = torch.zeros(6, dtype=dtype, device=dev)

    def pose_one(T, Tp, si):
        def f(d):
            r = priors.pose_prior_residual(Tp, se3.retract(T, d), si)
            return r, r

        J, r = jacfwd(f, has_aux=True)(z6)
        return r, J

    ks = torch.arange(p.K, device=dev)
    with forward_ad.LOCK:
        r_pp, Jp = vmap(pose_one)(p.T_WS, p.pose_prior_T, p.pose_prior_sqrt_info)
    r_sb = priors.speed_bias_prior_residual(p.sb_prior, p.sb, p.sb_prior_sqrt_info)
    return ((r_pp, [(_pad15(Jp, 0), ks)], p.pose_prior_valid),
            (r_sb, [(_pad15(p.sb_prior_sqrt_info, 6), ks)], p.sb_prior_valid))


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
    return r, [(_pad15(Ji, 0), i), (_pad15(Jj, 0), j)], p.rel_valid


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

    # priors, IMU links and relative-pose edges: per-frame blocks added to
    # the frame system (the columns of frozen parameters are cleared by the
    # gauge fixing below)
    fams = list(_linearize_priors(p))
    if p.imu_i.shape[0]:
        fams.append(_linearize_imu(p, cfg))
    if p.rel_i.shape[0]:
        fams.append(_linearize_rel(p, cfg))
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
    _check_ported(p)
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
