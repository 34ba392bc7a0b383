"""Multi-view depth with uncertainty (torch counterpart of
``okvis2x_tpu/models/mvs.py``): the reference frame, source frames with
known relative poses and shared intrinsics -> depth and sigma of the
reference frame, to be fused with the stereo depth by inverse variance
(``stereo.fuse_depths``).

Two engines:
  * `plane_sweep`: each source warped onto fronto-parallel planes at
    inverse-depth-spaced hypotheses, the absolute difference of
    locally normalised images box-aggregated and averaged over the sources,
    winner takes all with parabolic refinement in inverse depth, and a
    curvature sigma;
  * the trained `MvsNet` (``mvs_net.py``) with the JAX package's shipped
    weights, used only for the source count it was trained with.

`mvs_depth` dispatches as the JAX package does: ``auto`` takes the net when
its artifact exists, its source count matches and its recorded held-out
RMSE beats the plane sweep's; ``net`` demands it; ``classical`` never loads
it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.models import mvs_net
from okvis2x_tpu_torch.models.stereo import _box
from okvis2x_tpu_torch.utils.linspace import linspace


class MvsDepth(NamedTuple):
    depth: torch.Tensor  # (H, W) metres; 0 where invalid
    sigma: torch.Tensor  # (H, W); inf where invalid
    valid: torch.Tensor  # (H, W) bool


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample (H, W) at continuous (x, y): (values, inside)."""
    H, W = img.shape
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * W + xx]

    v = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
         + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
    return v, inb


def _normalise(img: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit-variance over a 7x7 neighbourhood: (..., H, W)."""
    m = _box(img, 3)
    var = _box(img * img, 3) - m * m
    return (img - m) / torch.sqrt(torch.clamp(var, min=1e-6))


def plane_sweep(ref: torch.Tensor, srcs: torch.Tensor, K: torch.Tensor, T_ref_src: torch.Tensor,
                min_depth: float = 0.5, max_depth: float = 20.0,
                num_depths: int = 48) -> MvsDepth:
    """ref (H, W), srcs (S, H, W), K (3, 3), T_ref_src (S, 7) the pose of each
    source in the reference camera frame."""
    H, W = ref.shape
    dt, dev = ref.dtype, ref.device
    refn = _normalise(ref)
    srcn = _normalise(srcs)
    inv_d = linspace(1.0 / max_depth, 1.0 / min_depth, num_depths, dtype=dt, device=dev)
    depths = 1.0 / inv_d

    ys = torch.arange(H, dtype=dt, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=dt, device=dev)[None, :].expand(H, W)
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    rays = pix @ torch.linalg.inv(K).T  # (H, W, 3)
    T_src_ref = se3.se3_inverse(T_ref_src.to(dt))
    R_sr = se3.quat_to_matrix(se3.se3_q(T_src_ref))
    t_sr = T_src_ref[:, :3]

    costs, covs = [], []
    for i in range(num_depths):
        p_ref = rays * depths[i]
        acc = torch.zeros((H, W), dtype=dt, device=dev)
        cnt = torch.zeros((H, W), dtype=dt, device=dev)
        for s in range(srcs.shape[0]):
            p_src = p_ref @ R_sr[s].T + t_sr[s]
            uvw = p_src @ K.T
            zc = torch.clamp(uvw[..., 2], min=1e-6)
            val, inb = _bilinear(srcn[s], uvw[..., 0] / zc, uvw[..., 1] / zc)
            ok = inb & (p_src[..., 2] > 1e-3)
            acc = acc + torch.where(ok, (val - refn).abs(), torch.zeros_like(acc))
            cnt = cnt + ok.to(dt)
        costs.append(torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0),
                                 torch.full_like(acc, 10.0)))
        covs.append(cnt > 0)
    vol = _box(torch.stack(costs), 2)  # (D, H, W)
    any_cov = torch.stack(covs).any(0)

    best = vol.argmin(0)
    d0 = torch.clamp(best, 1, num_depths - 2)

    def take(dd):
        return torch.gather(vol, 0, dd[None])[0]

    cm, cc, cp = take(d0 - 1), take(d0), take(d0 + 1)
    denom = cm - 2 * cc + cp
    curved = denom.abs() > 1e-6
    offs = torch.where(curved, 0.5 * (cm - cp) / torch.where(curved, denom,
                                                              torch.ones_like(denom)),
                       torch.zeros_like(denom))
    idx = best.to(dt) + torch.clamp(offs, -0.5, 0.5)
    # interpolated in inverse depth
    i0 = torch.clamp(torch.floor(idx).to(torch.int64), 0, num_depths - 2)
    fi = idx - i0
    inv = inv_d[i0] * (1 - fi) + inv_d[i0 + 1] * fi
    depth = 1.0 / torch.clamp(inv, min=1e-6)
    # sigma from the curvature in inverse-depth units, carried to depth
    step = inv_d[1] - inv_d[0]
    sigma_inv = torch.clamp(0.7 / torch.sqrt(torch.clamp(denom, min=1e-4)), 0.3, 4.0) * step
    sigma = sigma_inv * depth * depth
    valid = any_cov & (cc < 0.8) & (best > 0) & (best < num_depths - 1)
    return MvsDepth(depth=torch.where(valid, depth, torch.zeros_like(depth)),
                    sigma=torch.where(valid, sigma, torch.full_like(sigma, float("inf"))),
                    valid=valid)


def mvs_depth(ref: torch.Tensor, srcs: torch.Tensor, K: torch.Tensor, T_ref_src: torch.Tensor,
              engine: str = "auto", min_depth: float = 0.5, max_depth: float = 20.0,
              num_depths: int = 48, weights=mvs_net.DEFAULT_WEIGHTS) -> MvsDepth:
    """Depth of `ref` from the sources with engine dispatch (`weights`: the
    net's artifact; the plane sweep's range and hypotheses as given)."""
    net = mvs_net.trained(str(weights), str(ref.device)) if engine in ("auto", "net") else None
    if net is not None and int(net[1].get("n_src", srcs.shape[0])) != srcs.shape[0]:
        net = None  # trained for another source count
    if engine == "net" and net is None:
        raise FileNotFoundError(
            f"engine='net' requested but no trained MVS artifact for {srcs.shape[0]} sources "
            f"exists at {weights} (tools/train_mvs.py writes it)")
    if net is not None and engine == "auto":
        meta = net[1]
        if meta.get("rmse_net", float("inf")) >= meta.get("rmse_plane_sweep", 0.0):
            net = None
    if net is None:
        return plane_sweep(ref, srcs, K, T_ref_src, min_depth=min_depth, max_depth=max_depth,
                           num_depths=num_depths)
    mod = net[0]
    fxfycxcy = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    # the net takes homogeneous ref-cam -> src-cam transforms
    T_sr7 = se3.se3_inverse(T_ref_src)
    M = torch.eye(4, dtype=ref.dtype, device=ref.device).repeat(srcs.shape[0], 1, 1)
    M[:, :3, :3] = se3.quat_to_matrix(se3.se3_q(T_sr7))
    M[:, :3, 3] = T_sr7[:, :3]
    with torch.no_grad():
        depth, sigma = mod(ref, srcs, fxfycxcy, M)
    valid = (depth > mod.d_min + 1e-3) & (depth < mod.d_max - 1e-3)
    return MvsDepth(depth=torch.where(valid, depth, torch.zeros_like(depth)),
                    sigma=torch.where(valid, sigma, torch.full_like(sigma, float("inf"))),
                    valid=valid)
