"""Multi-scale Harris keypoint detection (torch counterpart of
``okvis2x_tpu/frontend/detector.py``).

  * image pyramid by 2x average pooling (`octaves` levels);
  * Harris response per level from Sobel structure tensors;
  * 3x3 non-max suppression;
  * spatial uniformity: the best response in each fine grid cell;
  * global top-N by score into a fixed-capacity table with a validity mask;
  * quadratic subpixel refinement on the response surface.

The filters are written as the same shift-and-add sums, in the same order,
as the JAX package, so the float32 responses agree bit for bit.  The global
top-N is a stable descending sort: equal scores keep their cell order.
Coordinates are level-0 pixels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    uv: torch.Tensor  # (N, 2) float32 full-res pixel coords (x, y)
    score: torch.Tensor  # (N,) Harris response
    level: torch.Tensor  # (N,) int64 pyramid level
    valid: torch.Tensor  # (N,) bool


def _conv2(img: torch.Tensor, kernel) -> torch.Tensor:
    """Same-padding 2D cross-correlation by a small constant kernel as a sum
    of shifted, weighted copies (zero padding)."""
    kh, kw = len(kernel), len(kernel[0])
    ph, pw = kh // 2, kw // 2
    H, W = img.shape
    p = F.pad(img, (pw, pw, ph, ph))
    out = None
    for dy in range(kh):
        for dx in range(kw):
            w = float(kernel[dy][dx])
            if w == 0.0:
                continue
            term = p[dy:dy + H, dx:dx + W] * w
            out = term if out is None else out + term
    return out


def _sep_conv(img: torch.Tensor, taps) -> torch.Tensor:
    """Separable same-padding convolution (symmetric 1D taps)."""
    taps = [float(t) for t in taps]
    r = len(taps) // 2
    H, W = img.shape
    p = F.pad(img, (r, r, 0, 0))
    out = None
    for d, w in enumerate(taps):
        term = p[:, d:d + W] * w
        out = term if out is None else out + term
    p = F.pad(out, (0, 0, r, r))
    out = None
    for d, w in enumerate(taps):
        term = p[d:d + H, :] * w
        out = term if out is None else out + term
    return out


_G5 = [t / 16.0 for t in (1.0, 4.0, 6.0, 4.0, 1.0)]
_SOBEL_X = [[-1 / 8, 0.0, 1 / 8], [-2 / 8, 0.0, 2 / 8], [-1 / 8, 0.0, 1 / 8]]
_SOBEL_Y = [list(r) for r in zip(*_SOBEL_X)]


def gauss5(img: torch.Tensor) -> torch.Tensor:
    return _sep_conv(img, _G5)


def harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris corner response (img float in [0,1], shape (H, W))."""
    ix = _conv2(img, _SOBEL_X)
    iy = _conv2(img, _SOBEL_Y)
    ixx = gauss5(ix * ix)
    iyy = gauss5(iy * iy)
    ixy = gauss5(ix * iy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """Zero out non-maxima in each 3x3 neighbourhood."""
    H, W = resp.shape
    p = F.pad(resp, (1, 1, 1, 1), value=float("-inf"))
    mx = resp
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            mx = torch.maximum(mx, p[dy:dy + H, dx:dx + W])
    return torch.where(resp >= mx, resp, torch.zeros_like(resp))


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    x = img[: h2 * 2, : w2 * 2]
    s = ((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]
    return s / 4.0


def _subpixel_offsets(resp: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Quadratic 1D fits in x and y around integer maxima."""
    H, W = resp.shape

    def grab(dy, dx):
        return resp[(ys + dy).clamp(0, H - 1), (xs + dx).clamp(0, W - 1)]

    c = grab(0, 0)
    l, r, u, d = grab(0, -1), grab(0, 1), grab(-1, 0), grab(1, 0)
    denom_x = l - 2 * c + r
    denom_y = u - 2 * c + d
    okx = denom_x.abs() > 1e-12
    oky = denom_y.abs() > 1e-12
    one = torch.ones_like(c)
    dx = torch.where(okx, 0.5 * (l - r) / torch.where(okx, denom_x, one), torch.zeros_like(c))
    dy = torch.where(oky, 0.5 * (u - d) / torch.where(oky, denom_y, one), torch.zeros_like(c))
    return dx.clamp(-0.5, 0.5), dy.clamp(-0.5, 0.5)


def detect(
    img: torch.Tensor,
    max_keypoints: int = 768,
    octaves: int = 3,
    cell: int = 32,
    per_cell: int = 8,
    threshold: float = 1e-7,
    border: int = 20,
) -> Keypoints:
    """Detect up to `max_keypoints` multi-scale Harris corners; `threshold`
    is the absolute response floor."""
    img = img.to(torch.float32)
    dev = img.device
    all_uv, all_score, all_level = [], [], []
    level_img = img
    cf = max(int(cell / max(math.ceil(math.sqrt(max(per_cell, 1))), 1)), 4)
    for lvl in range(octaves):
        resp = _nms3(harris_response(level_img))
        h, w = resp.shape
        b = max(border // (1 << lvl), 3)
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        inb = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
        resp = torch.where(inb, resp, torch.zeros_like(resp))

        # spatial uniformity: the best response in each fine cell
        ch, cw = h // cf, w // cf
        cells = resp[: ch * cf, : cw * cf].reshape(ch, cf, cw, cf)
        cells = cells.permute(0, 2, 1, 3).reshape(ch * cw, cf * cf)
        scores = cells.max(dim=1).values
        best = torch.argmax(cells, dim=1)
        ncell = torch.arange(ch * cw, device=dev)
        pys = ncell // cw * cf + best // cf
        pxs = ncell % cw * cf + best % cf
        dx, dy = _subpixel_offsets(resp, pys, pxs)
        scale = float(1 << lvl)
        uv = torch.stack(
            [(pxs.to(torch.float32) + dx) * scale + (scale - 1) * 0.5,
             (pys.to(torch.float32) + dy) * scale + (scale - 1) * 0.5],
            dim=-1,
        )
        all_uv.append(uv)
        all_score.append(scores)
        all_level.append(torch.full(scores.shape, lvl, dtype=torch.int64, device=dev))
        if lvl + 1 < octaves:
            level_img = _downsample2(level_img)

    uv = torch.cat(all_uv)
    score = torch.cat(all_score)
    level = torch.cat(all_level)
    n = min(max_keypoints, score.shape[0])
    top_scores, top_idx = torch.sort(score, descending=True, stable=True)
    top_scores, top_idx = top_scores[:n], top_idx[:n]
    uv, level = uv[top_idx], level[top_idx]
    valid = top_scores > threshold
    if n < max_keypoints:
        pad = max_keypoints - n
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=uv.dtype, device=dev)])
        top_scores = torch.cat([top_scores, torch.zeros((pad,), dtype=score.dtype, device=dev)])
        level = torch.cat([level, torch.zeros((pad,), dtype=level.dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return Keypoints(uv=uv, score=top_scores, level=level, valid=valid)
