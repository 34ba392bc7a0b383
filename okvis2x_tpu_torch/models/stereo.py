"""Stereo depth with uncertainty (torch counterpart of
``okvis2x_tpu/models/stereo.py``): rectified pair -> disparity and sigma ->
metric depth and sigma, for the depth priors and the occupancy submaps.

Two engines:
  * `census_stereo`: census-transform block matching (5x5 census bits as
    int64 masks, SWAR popcount of the XOR, box aggregation), winner takes
    all with parabolic subpixel refinement, a curvature sigma, a uniqueness
    test and a left-right check;
  * the trained `StereoNet` (``stereo_net.py``) with the JAX package's
    shipped weights.

`stereo_depth` dispatches: ``auto`` takes the net only when its artifact
exists and its recorded held-out RMSE beats census's; ``net`` demands the
artifact; ``census`` never loads it.  Depth: z = fx b / d, sigma_z =
z^2 / (fx b) sigma_d.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from okvis2x_tpu_torch.models import stereo_net


class StereoDepth(NamedTuple):
    depth: torch.Tensor  # (H, W) metres; 0 where invalid
    sigma: torch.Tensor  # (H, W) depth stdev; inf where invalid
    disparity: torch.Tensor  # (H, W) px
    valid: torch.Tensor  # (H, W) bool


def census(img: torch.Tensor, win: int = 5) -> torch.Tensor:
    """(H, W) int64 bitfield: bit k set where the k-th neighbour of the
    win x win window (row-major, centre skipped) is brighter than the
    centre; edges replicated."""
    H, W = img.shape
    r = win // 2
    pad = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    bits = torch.zeros((H, W), dtype=torch.int64, device=img.device)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx == 0 and dy == 0:
                continue
            nb = pad[r + dy: r + dy + H, r + dx: r + dx + W]
            bits = bits | ((nb > img).to(torch.int64) << k)
            k += 1
    return bits


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of int64 values, exact."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _box(img: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over a (2r+1)^2 window, zeros outside: (..., H, W)."""
    k = torch.full((1, 1, 2 * r + 1, 2 * r + 1), 1.0 / (2 * r + 1) ** 2, dtype=img.dtype,
                   device=img.device)
    shape = img.shape
    with stereo_net.full_precision():
        out = F.conv2d(img.reshape(-1, 1, *shape[-2:]), k, padding=r)
    return out.reshape(shape)


def cost_volumes(left, right, max_disp: int = 64, census_win: int = 5, agg_radius: int = 3):
    """The aggregated census costs of both directions: (left->right (D, H,
    W), right->left (D, H, W)); wrapped columns cost 1e4."""
    H, W = left.shape
    cl, cr = census(left, census_win), census(right, census_win)
    xs = torch.arange(W, device=left.device)
    big = torch.tensor(1e4, dtype=left.dtype, device=left.device)

    def vol(a, b, sign, ok):
        return _box(torch.stack([
            torch.where(ok(d), popcount32(a ^ torch.roll(b, sign * d, dims=1)).to(left.dtype), big)
            for d in range(max_disp)]), agg_radius)

    return (vol(cl, cr, 1, lambda d: xs >= d),  # right pixel x - d matches left x
            vol(cr, cl, -1, lambda d: xs < W - d))


def census_stereo(left, right, max_disp: int = 64, census_win: int = 5, agg_radius: int = 3,
                  lr_tol: float = 1.5, uniq_ratio: float = 0.9):
    """(disparity (H, W), sigma_d (H, W), valid (H, W))."""
    H, W = left.shape
    vol, vol_r = cost_volumes(left, right, max_disp, census_win, agg_radius)
    cmin, best = vol.min(0)  # the first of equal minima
    d0 = torch.clamp(best, 1, max_disp - 2)

    def take(dd):
        return torch.gather(vol, 0, dd[None])[0]

    cm, cc, cp = take(d0 - 1), take(d0), take(d0 + 1)
    denom = cm - 2 * cc + cp
    curved = denom.abs() > 1e-6
    offset = torch.where(curved, 0.5 * (cm - cp) / torch.where(curved, denom,
                                                                torch.ones_like(denom)),
                         torch.zeros_like(denom))
    disp = best.to(left.dtype) + torch.clamp(offset, -0.5, 0.5)
    # sigma_d from the cost curvature: a sharper minimum, a smaller sigma
    sigma_d = torch.clamp(3.0 / torch.sqrt(torch.clamp(denom, min=1e-3)), 0.1, 5.0)

    # uniqueness: the best outside +-1 disparity must be clearly worse
    ds = torch.arange(max_disp, device=left.device)[:, None, None]
    c2 = torch.where((ds - best[None]).abs() <= 1, torch.full_like(vol, float("inf")),
                     vol).amin(0)
    unique = cmin < uniq_ratio * c2

    # left-right consistency against the right image's own disparities
    best_r = vol_r.argmin(0)
    xs = torch.arange(W, device=left.device)[None, :]
    xr = torch.clamp(xs - best, 0, W - 1)
    lr_ok = (best - torch.gather(best_r, 1, xr)).abs() <= lr_tol

    valid = (best > 0) & (best < max_disp - 1) & unique & lr_ok & (cmin < 1e3)
    return disp, sigma_d, valid


def disparity_to_depth(disp, sigma_d, valid, fx: float, baseline: float,
                       min_depth: float = 0.1, max_depth: float = 50.0) -> StereoDepth:
    """Depth and its propagated sigma; invalid outside (min_depth,
    max_depth)."""
    fb = fx * baseline
    z = fb / torch.clamp(disp, min=1e-3)
    sigma_z = z * z / fb * sigma_d
    ok = valid & (z > min_depth) & (z < max_depth)
    return StereoDepth(depth=torch.where(ok, z, torch.zeros_like(z)),
                       sigma=torch.where(ok, sigma_z, torch.full_like(z, float("inf"))),
                       disparity=disp, valid=ok)


def stereo_depth(left: torch.Tensor, right: torch.Tensor, fx: float, baseline: float,
                 max_disp: int = 64, engine: str = "auto",
                 weights=stereo_net.DEFAULT_WEIGHTS) -> StereoDepth:
    """Depth of the left image with engine dispatch (`weights`: the net's
    artifact)."""
    net = (stereo_net.trained(str(weights), max_disp, str(left.device))
           if engine in ("auto", "net") else None)
    if engine == "net" and net is None:
        raise FileNotFoundError(
            f"engine='net' requested but no trained stereo artifact exists at {weights} "
            "(tools/train_stereo.py writes it)")
    if net is not None and engine == "auto":
        meta = net[1]
        if meta.get("rmse_net", float("inf")) > meta.get("rmse_census", 0.0):
            net = None
    if net is not None:
        with torch.no_grad():
            disp, sigma_d = net[0](left, right)
        # the net's output is dense: gated by the disparity range only
        valid = (disp > 0.5) & (disp < max_disp - 1)
        return disparity_to_depth(disp, sigma_d, valid, fx, baseline)
    return disparity_to_depth(*census_stereo(left, right, max_disp=max_disp), fx, baseline)


def fuse_depths(d1, s1, d2, s2):
    """Inverse-variance fusion of two depth maps (0 = invalid): (depth,
    sigma), sigma inf where neither is valid."""
    w1 = torch.where(d1 > 0, 1.0 / torch.clamp(s1 * s1, min=1e-12), torch.zeros_like(s1))
    w2 = torch.where(d2 > 0, 1.0 / torch.clamp(s2 * s2, min=1e-12), torch.zeros_like(s2))
    wsum = w1 + w2
    any_w = wsum > 0
    d = torch.where(any_w, (d1 * w1 + d2 * w2) / torch.clamp(wsum, min=1e-12),
                    torch.zeros_like(wsum))
    s = torch.where(any_w, torch.sqrt(1.0 / torch.clamp(wsum, min=1e-12)),
                    torch.full_like(wsum, float("inf")))
    return d, s
