"""Matrix-free pose-graph LM with preconditioned conjugate gradients (torch
counterpart of the single-device path of
``okvis2x_tpu/parallel/dist_posegraph.py``).

Dense normal equations grow as (6K)^2; this solver never forms them:

  * relative-pose edges are linearised with the closed-form minimal
    Jacobians of the window solver (`gauss_newton.rel_residual_jacobians`)
    and Huber-robustified by IRLS (scale 10 in whitened units);
  * each LM step solves (J^T J + lam I) dx = -J^T r by a fixed number of
    preconditioned CG iterations with matrix-free Hessian-vector products:
    edge gather, 6x6 block products, `index_add_` scatter onto the poses;
  * the preconditioner is block-Jacobi: the per-pose 6x6 diagonal blocks of
    J^T J + lam I, inverted once per LM step (fixed poses: the identity);
  * LM accepts a step when the robust cost falls (lambda x0.3), else
    rejects it (lambda x10), lambda clipped to [1e-10, 1e8].

Fixed poses have their Jacobian columns zeroed, so with b = 0 there PCG
never moves them.  Node and edge counts are padded to power-of-two buckets
with identity, fixed dummy nodes and zero-information edges, as the JAX
package pads them, and the CG iteration count follows the node bucket.
Nothing inside the LM and CG loops reads a value back to the host: every
branch on a tensor is a `torch.where`, so the loops could be captured in a
CUDA graph.

The edge-sharded solve over several devices (a `mesh`) is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.factors import robust
from okvis2x_tpu_torch.solver.gauss_newton import rel_residual_jacobians

# the LM schedule and the edges' Huber scale (whitened units)
INIT_LAMBDA, LAMBDA_UP, LAMBDA_DOWN = 1e-6, 10.0, 0.3
LOSS_SCALE = 10.0


def _linearize(T, ei, ej, eT, eS, free):
    """Per-edge whitened residuals and Jacobians, the columns of fixed poses
    zeroed: r (E, 6), Ji, Jj (E, 6, 6)."""
    r, Ji, Jj = rel_residual_jacobians(T[ei], T[ej], eT, eS)
    return r, Ji * free[ei][:, None, None], Jj * free[ej][:, None, None]


def _residual_only(T, ei, ej, eT, eS):
    return rel_residual_jacobians(T[ei], T[ej], eT, eS)[0]


def _guarded_div(num, den, tiny):
    """num / den, or 0 where |den| <= tiny (an exhausted search direction)."""
    ok = den.abs() > tiny
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _pcg(hvp, b, Minv, n_iter: int):
    """Fixed-iteration preconditioned CG on H x = b from x0 = 0.  b, x are
    (K, 6); Minv is the (K, 6, 6) block-Jacobi inverse.  The division guards
    make exhausted search directions a no-op instead of NaN (the iteration
    count may exceed the Krylov dimension of a small graph)."""
    tiny = 1e-30 if b.dtype == torch.float64 else 1e-18

    def precond(r):
        return torch.einsum("kij,kj->ki", Minv, r)

    x = torch.zeros_like(b)
    r = b
    p = precond(b)
    rz = torch.sum(b * p)
    for _ in range(n_iter):
        Hp = hvp(p)
        alpha = _guarded_div(rz, torch.sum(p * Hp), tiny)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + _guarded_div(rz_new, rz, tiny) * p
        rz = rz_new
    return x


def _core(T, fixed, ei, ej, eT, eS, evalid, iterations: int, cg_iterations: int):
    """One LM pose-graph solve over the whole (padded) edge set; returns the
    poses and the final robust cost, both on the device."""
    dtype, dev = T.dtype, T.device
    K = T.shape[0]
    free = (~fixed).to(dtype)
    ev = evalid.to(dtype)[:, None]
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def scatter(x, idx):
        return torch.zeros((K,) + x.shape[1:], dtype=dtype, device=dev).index_add_(0, idx, x)

    def cost_of(Tc):
        r = _residual_only(Tc, ei, ej, eT, eS) * ev
        s = torch.sum(r * r, dim=-1)
        return 0.5 * torch.sum(robust.rho(robust.HUBER, s, LOSS_SCALE))

    def step(Tc, lam, cost):
        r, Ji, Jj = _linearize(Tc, ei, ej, eT, eS, free)
        r = r * ev
        Ji = Ji * ev[..., None]
        Jj = Jj * ev[..., None]
        sw = torch.sqrt(robust.weight(robust.HUBER, torch.sum(r * r, dim=-1), LOSS_SCALE))
        r = r * sw[:, None]
        Ji = Ji * sw[:, None, None]
        Jj = Jj * sw[:, None, None]
        # gradient b = -J^T r scattered onto the poses
        b = -(scatter(torch.einsum("eri,er->ei", Ji, r), ei)
              + scatter(torch.einsum("eri,er->ei", Jj, r), ej))
        # block-Jacobi diagonal: sum_e J^T J + lam I, the identity at fixed poses
        B = (scatter(torch.einsum("eri,erj->eij", Ji, Ji), ei)
             + scatter(torch.einsum("eri,erj->eij", Jj, Jj), ej))
        B = B + (lam + 1e-12) * eye6
        B = torch.where(fixed[:, None, None], eye6, B)
        Minv = torch.linalg.inv(B)

        def hvp(v):
            u = (torch.einsum("eij,ej->ei", Ji, v[ei])
                 + torch.einsum("eij,ej->ei", Jj, v[ej]))
            y = (scatter(torch.einsum("eri,er->ei", Ji, u), ei)
                 + scatter(torch.einsum("eri,er->ei", Jj, u), ej))
            return y + lam * v

        dx = _pcg(hvp, b, Minv, cg_iterations)
        T_cand = se3.retract(Tc, dx * free[:, None])
        new_cost = cost_of(T_cand)
        accept = new_cost < cost
        T_new = torch.where(accept, T_cand, Tc)
        lam = torch.where(accept, lam * LAMBDA_DOWN, lam * LAMBDA_UP).clamp(1e-10, 1e8)
        return T_new, lam, torch.minimum(new_cost, cost)

    lam = torch.tensor(INIT_LAMBDA, dtype=dtype, device=dev)
    cost = cost_of(T)
    for _ in range(iterations):
        T, lam, cost = step(T, lam, cost)
    return T, cost


def bucket(n: int, base: int) -> int:
    """The least base * 2^k >= n: the capacity buckets of nodes and edges."""
    c = base
    while c < n:
        c *= 2
    return c


def optimize_pose_graph_pcg(
    T_WS: np.ndarray,  # (K, 7)
    fixed: np.ndarray,  # (K,) bool
    edges_i: np.ndarray,
    edges_j: np.ndarray,
    edges_T: np.ndarray,  # (E, 7)
    edges_sqrt_info: np.ndarray,  # (E, 6, 6)
    iterations: int = 10,
    cg_iterations: Optional[int] = None,
    mesh=None,
    dtype=torch.float64,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Pose-graph LM with matrix-free PCG steps: returns the optimised (K, 7)
    poses as numpy and the final cost.  Nodes are padded to Kp = 64 * 2^k
    and edges to 256 * 2^k; `cg_iterations` None is max(128, Kp), since the
    block-Jacobi PCG carries a correction about one node an iteration along
    a chain.  `device` None is the first CUDA device.  A `mesh` (the
    edge-sharded solve over several devices) raises NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError("the edge-sharded multi-device pose-graph solve is not "
                                  "ported yet")
    device = default_device() if device is None else torch.device(device)
    E = len(edges_i)
    ev = np.ones(E, bool)
    ei = np.asarray(edges_i, np.int64)
    ej = np.asarray(edges_j, np.int64)
    eT = np.asarray(edges_T, np.float64)
    eS = np.asarray(edges_sqrt_info, np.float64)
    T = np.asarray(T_WS, np.float64)
    fx = np.asarray(fixed, bool)
    id7 = np.array([0, 0, 0, 0, 0, 0, 1.0])

    K0 = T.shape[0]
    Kp = bucket(K0, 64)
    if cg_iterations is None:
        cg_iterations = max(128, Kp)
    if Kp > K0:
        T = np.concatenate([T, np.tile(id7, (Kp - K0, 1))])
        fx = np.concatenate([fx, np.ones(Kp - K0, bool)])
    Ep = bucket(E, 256)
    if Ep > E:
        pe = Ep - E
        ei = np.concatenate([ei, np.zeros(pe, np.int64)])
        ej = np.concatenate([ej, np.zeros(pe, np.int64)])
        eT = np.concatenate([eT, np.tile(id7, (pe, 1))])
        eS = np.concatenate([eS, np.zeros((pe, 6, 6))])
        ev = np.concatenate([ev, np.zeros(pe, bool)])

    F = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    I = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    T_opt, cost = _core(F(T), I(fx), I(ei), I(ej), F(eT), F(eS), I(ev), iterations,
                        cg_iterations)
    return T_opt[:K0].cpu().numpy().astype(np.float64), float(cost)
