"""Vectorised RANSAC pose solvers (torch counterpart of
``okvis2x_tpu/frontend/ransac.py``).

Every hypothesis is solved and scored at once (batched 3x3 algebra and
einsums) instead of the sequential sample-test loop.  Each solver comes in
two parts:

  * ``<solver>_core(idx, ...)`` takes the (n_hyp, sample_size) sample-index
    matrix and is deterministic, so it can be held against the JAX package
    fed the same indices;
  * ``<solver>(..., generator=None)`` draws that matrix with
    `sample_indices` from a `torch.Generator` and calls the core.

The JAX package draws its indices from ``jax.random``; torch cannot
reproduce that stream, so only the cores agree exactly.

`absolute_pose_noncentral` (the loop-closure verifier) also takes a leading
batch dimension: candidates verified together share one set of launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

from okvis2x_tpu_torch.core import se3


class RansacResult(NamedTuple):
    T: torch.Tensor  # best model: pose (7,) or quaternion-only encoded in T[3:7]
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int64


def sample_indices(generator: Optional[torch.Generator], n_hyp: int,
                   sample_size: int, n, device=None) -> torch.Tensor:
    """(..., n_hyp, sample_size) int64 random indices below `n` (an int, or
    an int tensor of batch shape), de-duplicated within a row by the JAX
    package's linear-probing offsets.  Drawn on the generator's device (the
    CPU by default) and moved to `device`."""
    n = torch.as_tensor(n, dtype=torch.int64)
    gdev = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand(n.shape + (n_hyp, sample_size), generator=generator,
                   dtype=torch.float64, device=gdev)
    nn = n.to(gdev)[..., None, None]
    base = torch.minimum((u * nn).to(torch.int64), nn - 1)
    offs = torch.arange(sample_size, device=gdev) * 7919
    return ((base + offs) % nn).to(device or gdev)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (..., N, d), idx (..., H, s) -> (..., H, s, d)."""
    flat = idx.reshape(idx.shape[:-2] + (-1, 1))
    return torch.take_along_dim(a, flat, dim=-2).reshape(idx.shape + a.shape[-1:])


def _pick(a: torch.Tensor, best: torch.Tensor, tail: int) -> torch.Tensor:
    """a (..., H, *tail dims) at hypothesis `best` (...,)."""
    ix = best.reshape(best.shape + (1,) * (tail + 1))
    return torch.take_along_dim(a, ix, dim=-(tail + 1)).squeeze(-(tail + 1))


def _kabsch(H3: torch.Tensor) -> torch.Tensor:
    """Rotation R = U diag(1, 1, det(U Vt)) Vt of a batch of 3x3
    correlations.  The sign fix makes R independent of the signs the SVD
    picks for its singular vectors."""
    U, _S, Vt = torch.linalg.svd(H3)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def absolute_pose_known_rotation_core(
    idx: torch.Tensor,  # (H, 2)
    q_WC: torch.Tensor,  # (4,) known/predicted camera orientation
    rays_C: torch.Tensor,  # (N, 3) unit bearing vectors in the camera frame
    pts_W: torch.Tensor,  # (N, 3) corresponding world points
    mask: torch.Tensor,  # (N,)
    threshold_rad: float = 0.012,
) -> RansacResult:
    """Position RANSAC with known rotation: each 2-point sample gives the
    linear system [r]_x t = [r]_x X for the camera position, solved by
    normal equations; scored by the angle between predicted and measured
    bearings."""
    C_WC = se3.quat_to_matrix(q_WC)
    rays_W = rays_C @ C_WC.T
    r = rays_W[idx]  # (H, 2, 3)
    X = pts_W[idx]
    A = se3.cross_matrix(r)  # (H, 2, 3, 3)
    b = torch.einsum("hpij,hpj->hpi", A, X)
    AtA = torch.einsum("hpij,hpik->hjk", A, A)
    Atb = torch.einsum("hpij,hpi->hj", A, b)
    eye = torch.eye(3, dtype=rays_C.dtype, device=rays_C.device)
    t = torch.linalg.solve(AtA + 1e-9 * eye, Atb[..., None])[..., 0]  # (H, 3)
    d = pts_W[None, :, :] - t[:, None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.einsum("hnj,nj->hn", d, rays_W)
    inl = (cosang > math.cos(threshold_rad)) & mask[None, :]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    return RansacResult(T=torch.cat([t[best], q_WC]), inliers=inl[best],
                        num_inliers=scores[best])


def absolute_pose_known_rotation(q_WC, rays_C, pts_W, mask, n_hyp: int = 256,
                                 threshold_rad: float = 0.012, generator=None):
    idx = sample_indices(generator, n_hyp, 2, rays_C.shape[0], rays_C.device)
    return absolute_pose_known_rotation_core(idx, q_WC, rays_C, pts_W, mask,
                                             threshold_rad)


def absolute_pose_p3p_refined_core(
    idx: torch.Tensor,  # (H, 3)
    rays_C: torch.Tensor,  # (N, 3) unit bearings
    pts_W: torch.Tensor,  # (N, 3)
    mask: torch.Tensor,
    depth_guess: torch.Tensor,  # (N,) rough depths
    threshold_rad: float = 0.012,
) -> RansacResult:
    """Full 6-dof RANSAC: 3 points placed at the guessed depths along their
    rays, Kabsch alignment C<-W per hypothesis, angular scoring."""
    Pc = rays_C[idx] * depth_guess[idx][..., None]  # (H, 3, 3)
    Pw = pts_W[idx]
    cc = Pc.mean(dim=1, keepdim=True)
    cw = Pw.mean(dim=1, keepdim=True)
    R = _kabsch(torch.einsum("hpi,hpj->hij", Pc - cc, Pw - cw))  # C<-W
    t = cc[:, 0] - torch.einsum("hij,hj->hi", R, cw[:, 0])
    pc = torch.einsum("hij,nj->hni", R, pts_W) + t[:, None, :]
    pcn = pc / torch.clamp(torch.linalg.norm(pc, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.einsum("hni,ni->hn", pcn, rays_C)
    inl = (cosang > math.cos(threshold_rad)) & mask[None, :] & (pc[..., 2] > 0)
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    T_CW = torch.cat([t[best], se3.matrix_to_quat(R[best])])
    return RansacResult(T=se3.se3_inverse(T_CW), inliers=inl[best],
                        num_inliers=scores[best])


def absolute_pose_p3p_refined(rays_C, pts_W, mask, depth_guess, n_hyp: int = 512,
                              threshold_rad: float = 0.012, generator=None):
    idx = sample_indices(generator, n_hyp, 3, rays_C.shape[0], rays_C.device)
    return absolute_pose_p3p_refined_core(idx, rays_C, pts_W, mask, depth_guess,
                                          threshold_rad)


def _consensus(R, t, rays_S, origins_S, pts_W, mask, cos_thr):
    """Angular inliers about each ray's own origin at pose (R, t) S<-W:
    returns (inlier mask, depth of each point along its ray)."""
    v = pts_W @ R.transpose(-1, -2) + t[..., None, :] - origins_S
    depth = (v * rays_S).sum(-1)
    vn = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    return ((vn * rays_S).sum(-1) > cos_thr) & mask & (depth > 0), depth


def absolute_pose_noncentral_core(
    idx: torch.Tensor,  # (..., H, 3)
    rays_S: torch.Tensor,  # (..., N, 3) unit bearings in the body frame
    origins_S: torch.Tensor,  # (..., N, 3) per-ray camera centres in the body frame
    pts_W: torch.Tensor,  # (..., N, 3) corresponding world points
    mask: torch.Tensor,  # (..., N)
    depth_guess: torch.Tensor,  # (..., N) rough depths along each ray
    threshold_rad: float = 0.012,
) -> RansacResult:
    """Generalised (non-central) absolute pose over a multi-camera rig:
    3 correspondences (possibly from different cameras) placed at
    origin + depth * ray in the body frame, batched Kabsch onto the world
    points, angular scoring about each ray's own origin; then 8 rounds of
    refinement that alternate depth-consistent placement of the points on
    their rays with a weighted Kabsch over the current inliers."""
    cos_thr = math.cos(threshold_rad)
    Ps = _rows(origins_S, idx) + _rows(rays_S, idx) * _rows(depth_guess[..., None], idx)
    Pw = _rows(pts_W, idx)  # (..., H, 3, 3)
    cc = Ps.mean(dim=-2, keepdim=True)
    cw = Pw.mean(dim=-2, keepdim=True)
    R = _kabsch(torch.einsum("...hpi,...hpj->...hij", Ps - cc, Pw - cw))  # S<-W
    t = cc[..., 0, :] - torch.einsum("...hij,...hj->...hi", R, cw[..., 0, :])

    ps = torch.einsum("...hij,...nj->...hni", R, pts_W) + t[..., :, None, :]
    v = ps - origins_S[..., None, :, :]
    depth = torch.einsum("...hni,...ni->...hn", v, rays_S)
    vn = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.einsum("...hni,...ni->...hn", vn, rays_S)
    inl = (cosang > cos_thr) & mask[..., None, :] & (depth > 0)
    best = torch.argmax(inl.sum(dim=-1), dim=-1)
    R_c, t_c = _pick(R, best, 2), _pick(t, best, 1)

    one = torch.ones((), dtype=pts_W.dtype, device=pts_W.device)
    for _ in range(8):
        w_b, d1 = _consensus(R_c, t_c, rays_S, origins_S, pts_W, mask, cos_thr)
        w = w_b.to(pts_W.dtype)
        P_s = origins_S + rays_S * d1[..., None]
        wsum = torch.maximum(w.sum(-1), one)[..., None]
        cc1 = (P_s * w[..., None]).sum(-2) / wsum
        cw1 = (pts_W * w[..., None]).sum(-2) / wsum
        H1 = torch.einsum("...ni,...nj->...ij", (P_s - cc1[..., None, :]) * w[..., None],
                          pts_W - cw1[..., None, :])
        R_n = _kabsch(H1)
        t_n = cc1 - (R_n @ cw1[..., None])[..., 0]
        # a degenerate consensus (fewer than 4 inliers) keeps the old pose
        ok = w.sum(-1) >= 4
        R_c = torch.where(ok[..., None, None], R_n, R_c)
        t_c = torch.where(ok[..., None], t_n, t_c)

    inl_f, _ = _consensus(R_c, t_c, rays_S, origins_S, pts_W, mask, cos_thr)
    T_SW = torch.cat([t_c, se3.matrix_to_quat(R_c)], dim=-1)
    return RansacResult(T=se3.se3_inverse(T_SW), inliers=inl_f,
                        num_inliers=inl_f.sum(-1))


def absolute_pose_noncentral(rays_S, origins_S, pts_W, mask, depth_guess,
                             n_hyp: int = 512, threshold_rad: float = 0.012,
                             generator=None):
    """Callers pad to a fixed capacity with the valid rows as a prefix:
    hypotheses draw from the first max(sum(mask), 3) rows only."""
    n_eff = torch.clamp(mask.sum(-1), min=3).cpu()
    idx = sample_indices(generator, n_hyp, 3, n_eff, rays_S.device)
    return absolute_pose_noncentral_core(idx, rays_S, origins_S, pts_W, mask,
                                         depth_guess, threshold_rad)


def relative_rotation_2pt_core(
    idx: torch.Tensor,  # (H, 2)
    rays_a: torch.Tensor,  # (N, 3) unit bearings frame A
    rays_b: torch.Tensor,  # (N, 3) matched bearings frame B
    mask: torch.Tensor,
    threshold_rad: float = 0.01,
) -> RansacResult:
    """Rotation-only relative pose (2-point Wahba per hypothesis), a = R b."""
    R = _kabsch(torch.einsum("hpi,hpj->hij", rays_a[idx], rays_b[idx]))
    pred = torch.einsum("hij,nj->hni", R, rays_b)
    cosang = torch.einsum("hni,ni->hn", pred, rays_a)
    inl = (cosang > math.cos(threshold_rad)) & mask[None, :]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    T = torch.cat([torch.zeros(3, dtype=rays_a.dtype, device=rays_a.device),
                   se3.matrix_to_quat(R[best])])
    return RansacResult(T=T, inliers=inl[best], num_inliers=scores[best])


def relative_rotation_2pt(rays_a, rays_b, mask, n_hyp: int = 128,
                          threshold_rad: float = 0.01, generator=None):
    idx = sample_indices(generator, n_hyp, 2, rays_a.shape[0], rays_a.device)
    return relative_rotation_2pt_core(idx, rays_a, rays_b, mask, threshold_rad)
