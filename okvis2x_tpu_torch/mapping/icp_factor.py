"""Submap ICP (point-to-occupancy) factor (torch counterpart of
``okvis2x_tpu/mapping/icp_factor.py``; the reference's SubmapIcpError).

A point p_B measured at pose T_WB against the occupancy field of the submap
anchored at T_WA has the residual

    r = occ(T_WA^-1 T_WB p_B) / max(|grad occ|, g_min) / sigma

(the log-odds normalised by the local field gradient, approximately a
distance to the surface).  Points outside the grid, or where the gradient is
at most g_min, give zero residual and zero Jacobian.  Jacobians with respect
to both poses come from ``torch.func.jacfwd`` through the trilinear field and
the retraction (so through `grad_occupancy` as well), under
`utils/forward_ad.LOCK`.

Used for live frame-to-map rows and for map-to-map alignment, summarised as
a relative-pose edge by `make_alignment_edge`.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.mapping import submap as sm_mod
from okvis2x_tpu_torch.utils import forward_ad


def icp_residuals(sm: sm_mod.Submap, cfg: sm_mod.SubmapConfig, T_WA: torch.Tensor,
                  T_WB: torch.Tensor, p_B: torch.Tensor, valid: torch.Tensor,
                  sigma: float = 0.4, grad_min: float = 0.1):
    """(N,) whitened residuals of the points p_B (N, 3) and which of them
    count (valid, inside the grid, informative gradient).  The poses may
    carry leading batch dimensions matching the points'."""
    T_AB = se3.se3_multiply(se3.se3_inverse(T_WA), T_WB)
    p_K = se3.se3_apply(T_AB, p_B)
    occ, ok = sm_mod.interp_occupancy(sm, cfg, p_K)
    grad, _ = sm_mod.grad_occupancy(sm, cfg, p_K)
    gn = torch.linalg.norm(grad, dim=-1)
    r = occ / torch.clamp(gn, min=grad_min) / sigma
    use = valid & ok & (gn > grad_min)
    return torch.where(use, r, torch.zeros_like(r)), use


def linearize_icp(sm: sm_mod.Submap, cfg: sm_mod.SubmapConfig, T_WA: torch.Tensor,
                  T_WB: torch.Tensor, p_B: torch.Tensor, valid: torch.Tensor,
                  sigma: float = 0.4):
    """Residuals and Jacobians with respect to the minimal increments of
    both poses: (r (N,), J_a (N, 6), J_b (N, 6), use (N,))."""
    z6 = torch.zeros(6, dtype=T_WA.dtype, device=T_WA.device)

    def f(da, db):
        return icp_residuals(sm, cfg, se3.retract(T_WA, da), se3.retract(T_WB, db), p_B,
                             valid, sigma)[0]

    r, use = icp_residuals(sm, cfg, T_WA, T_WB, p_B, valid, sigma)
    with forward_ad.LOCK:
        Ja, Jb = jacfwd(f, argnums=(0, 1))(z6, z6)
    return r, Ja, Jb, use


def icp_align(sm: sm_mod.Submap, cfg: sm_mod.SubmapConfig, T_WA: torch.Tensor,
              T_WB0: torch.Tensor, p_B: torch.Tensor, valid: torch.Tensor,
              iterations: int = 8, sigma: float = 0.4, damping: float = 1e-4):
    """Gauss-Newton alignment of pose B against the submap (anchor fixed),
    damped relative to the trace of H (a plane constrains 1 of the 6 dofs:
    absolute damping would leave the steps along the others unbounded);
    returns (T_WB, final cost)."""
    T_WB = T_WB0
    for _ in range(iterations):
        r, _, Jb, use = linearize_icp(sm, cfg, T_WA, T_WB, p_B, valid, sigma)
        m = use.to(r.dtype)
        J = Jb * m[:, None]
        H = J.T @ J
        H = H + (damping * torch.trace(H) / 6.0 + 1e-9) * torch.eye(6, dtype=H.dtype,
                                                                     device=H.device)
        dx = torch.linalg.solve_ex(H, -(J.T @ (r * m)))[0]
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        T_WB = se3.retract(T_WB, dx)
    r, _ = icp_residuals(sm, cfg, T_WA, T_WB, p_B, valid, sigma)
    return T_WB, 0.5 * torch.sum(r * r)


def make_alignment_edge(sm: sm_mod.Submap, cfg: sm_mod.SubmapConfig, T_WA: torch.Tensor,
                        T_WB: torch.Tensor, p_B: torch.Tensor, valid: torch.Tensor,
                        sigma: float = 0.4):
    """Summarise the ICP residuals of the points p_B (measured at T_WB)
    against the submap anchored at T_WA as a relative-pose edge
    (T_AB, sqrt_info (6, 6), strength): the Gauss-Newton information of the
    residuals in the tangent of T_AB, its negative eigenvalues clamped to
    zero, its symmetric square root, and the sum of its eigenvalues."""
    r, use = icp_residuals(sm, cfg, T_WA, T_WB, p_B, valid, sigma)
    m = use.to(r.dtype)
    T_AB = se3.se3_multiply(se3.se3_inverse(T_WA), T_WB)

    def rel_fn(drel):
        T_WB_p = se3.se3_multiply(T_WA, se3.retract(T_AB, drel))
        return icp_residuals(sm, cfg, T_WA, T_WB_p, p_B, valid, sigma)[0]

    with forward_ad.LOCK:
        Jrel = jacfwd(rel_fn)(torch.zeros(6, dtype=T_WA.dtype, device=T_WA.device))
    Jrel = Jrel * m[:, None]
    H = Jrel.T @ Jrel
    e, U = torch.linalg.eigh(0.5 * (H + H.T))
    e = torch.clamp(e, min=0.0)
    sqrt_info = (U * torch.sqrt(e)[None, :]) @ U.T
    return T_AB, sqrt_info, torch.sum(e)
