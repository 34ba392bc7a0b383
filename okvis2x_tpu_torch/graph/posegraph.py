"""Pose-graph utilities (torch counterpart of
``okvis2x_tpu/graph/posegraph.py``):

  * `max_spanning_tree` — Kruskal maximum spanning tree over the
    covisibility graph, which picks the two-pose edges marginalisation
    creates;
  * `optimize_pose_graph` — LM over relative-pose edges only (a BAProblem
    with no observations or IMU links), used after loop closures and by the
    final BA's pose-graph stage.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.cameras import distortion as dist
from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.factors import robust
from okvis2x_tpu_torch.solver import gauss_newton as gn
from okvis2x_tpu_torch.solver import problem as prb


class DisjointSet:
    def __init__(self):
        self.parent: Dict[int, int] = {}

    def find(self, x: int) -> int:
        while self.parent.setdefault(x, x) != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def max_spanning_tree(
    edges: Sequence[Tuple[int, int, float]]
) -> List[Tuple[int, int, float]]:
    """Kruskal MST maximising total weight; edges (i, j, weight)."""
    ds = DisjointSet()
    out = []
    for i, j, w in sorted(edges, key=lambda e: -e[2]):
        if ds.union(i, j):
            out.append((i, j, w))
    return out


def optimize_pose_graph(
    T_WS: np.ndarray,  # (K, 7) initial poses
    fixed: np.ndarray,  # (K,) bool
    edges_i: np.ndarray,
    edges_j: np.ndarray,
    edges_T: np.ndarray,  # (R, 7)
    edges_sqrt_info: np.ndarray,  # (R, 6, 6)
    iterations: int = 10,
    dtype=torch.float64,
    device=None,
):
    """Pose-graph LM with Huber (scale 10) on the edges: one inconsistent
    high-information edge must not fold the graph.  Returns the optimised
    (K, 7) poses as numpy and the final cost.  `device` None is the first
    CUDA device (`okvis2x_tpu_torch.default_device`).

    The graph is padded as the JAX package pads it, to K = 64 nodes or a
    multiple of 256, so the solver takes the same branch: the reduced
    system (P = 15K + 10) is inverted at K = 64 and solved by conjugate
    gradients at K >= 256, whatever the number of real nodes."""
    device = default_device() if device is None else torch.device(device)
    K0 = T_WS.shape[0]
    R0 = len(edges_i)
    K = 64 if K0 <= 64 else 256 * ((K0 + 255) // 256)
    R = 2 * K if R0 <= 2 * K else 256 * ((R0 + 255) // 256)
    id7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
    T_full = np.concatenate([np.asarray(T_WS, np.float64), np.tile(id7, (K - K0, 1))])
    fix_full = np.concatenate([np.asarray(fixed, bool), np.ones(K - K0, bool)])
    valid = np.zeros(K, bool)
    valid[:K0] = True
    ei = np.zeros(R, np.int64)
    ej = np.zeros(R, np.int64)
    eT = np.tile(id7, (R, 1))
    eS = np.zeros((R, 6, 6))
    rv = np.zeros(R, bool)
    ei[:R0], ej[:R0], eT[:R0], eS[:R0], rv[:R0] = (
        edges_i, edges_j, edges_T, edges_sqrt_info, True)
    F = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    I = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    p = prb.empty_problem(K=K, L=1, C=1, N=1, M=1, R=R, dtype=dtype, device=device)
    p = p._replace(
        T_WS=F(T_full), frame_valid=I(valid), pose_fixed=I(fix_full),
        sb_fixed=torch.ones(K, dtype=torch.bool, device=device),
        rel_i=I(ei), rel_j=I(ej), rel_T=F(eT), rel_sqrt_info=F(eS), rel_valid=I(rv),
    )
    cams = gn.stack_cameras([pinhole.make_pinhole(
        1.0, 1.0, 0.0, 0.0, 2, 2, model=dist.NONE, dtype=dtype, device=device)])
    cfg = gn.SolverConfig(max_iterations=iterations, estimate_landmarks=False,
                          rel_loss=robust.HUBER, rel_loss_scale=10.0)
    p_opt, cost = gn.optimize(p, cams, cfg)
    return p_opt.T_WS[:K0].cpu().numpy().astype(np.float64), float(cost)
