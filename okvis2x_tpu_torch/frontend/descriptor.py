"""BRISK-style binary descriptor, gravity-alignable (torch counterpart of
``okvis2x_tpu/frontend/descriptor.py``).

A fixed pattern of 60 points on concentric rings (regenerated here from the
same seed) is rotated per keypoint by the extraction direction and scaled by
the pyramid level; intensities of the Gaussian-smoothed image are sampled
bilinearly and 384 fixed point pairs are compared.  The bits are packed
LSB-first into 12 words, returned as int32.

The JAX package samples with one-hot bf16 matmuls on the TPU's matrix unit;
that rounds the row weights and the intensities to bf16 before the products.
The rounding changes which bits come out, so it is reproduced here exactly:
each row value is the float32 sum of two bf16 x bf16 products (exact in
float32), and the column interpolation is two float32 products and one sum.
"""

from __future__ import annotations

import numpy as np
import torch

from okvis2x_tpu_torch.frontend.detector import gauss5

DESC_BITS = 384
DESC_WORDS = DESC_BITS // 32


def make_pattern():
    """(points (60, 2) float32, pair_a (384,), pair_b (384,)) — the BRISK-like
    ring geometry and the seeded choice of short-distance pairs."""
    rng = np.random.default_rng(42)
    radii = [0.0, 2.9, 4.9, 7.4, 10.8]
    counts = [1, 10, 14, 15, 20]
    pts = []
    for r, c in zip(radii, counts):
        ang = np.arange(c) / c * 2 * np.pi + (r * 1.7)
        pts.append(np.stack([r * np.cos(ang), r * np.sin(ang)], -1))
    pts = np.concatenate(pts)
    n = len(pts)
    ii, jj = np.triu_indices(n, 1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=-1)
    short = np.nonzero(d < 9.75)[0]
    sel = rng.permutation(short)[:DESC_BITS]
    if len(sel) != DESC_BITS:
        raise ValueError(f"only {len(short)} short pairs")
    return pts.astype(np.float32), ii[sel].astype(np.int64), jj[sel].astype(np.int64)


PATTERN_PTS, PAIR_A, PAIR_B = make_pattern()
_ON_DEVICE = {}


def pattern(device):
    """(points, pair_a, pair_b) as tensors on `device`, copied there once: a
    copy from the host in every call would make the host wait for the
    device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _ON_DEVICE:
        _ON_DEVICE[device] = tuple(torch.as_tensor(x, device=device)
                                   for x in (PATTERN_PTS, PAIR_A, PAIR_B))
    return _ON_DEVICE[device]


def _bilinear_bf16(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (H, W) at xy (..., 2) with the bf16 rounding
    of the row weights and intensities described in the module docstring."""
    H, W = img.shape
    x = xy[..., 0].clamp(0.0, W - 1.001)
    y = xy[..., 1].clamp(0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    img_b = bf(img)
    wy0, wy1 = bf(1.0 - fy), bf(fy)

    def row(xi):
        return img_b[y0, xi] * wy0 + img_b[y0 + 1, xi] * wy1

    return row(x0) * (1.0 - fx) + row(x0 + 1) * fx


def extract(
    img: torch.Tensor,  # (H, W) float in [0, 1]
    uv: torch.Tensor,  # (N, 2) float32 full-res pixel coords
    angle: torch.Tensor,  # (N,) float32 extraction direction [rad]
    level: torch.Tensor,  # (N,) int pyramid level (scales the pattern)
    valid: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    """(N, 12) int32 packed descriptors; invalid keypoints get zero bits."""
    dev = img.device
    img = gauss5(img.to(torch.float32))
    ang = angle.to(torch.float32)
    ca, sa = torch.cos(ang), torch.sin(ang)
    pts, pa, pb = pattern(dev)
    scale = (1.0 + level.to(torch.float32))[:, None]
    px, py = pts[None, :, 0], pts[None, :, 1]
    off_x = (ca[:, None] * px + (-sa)[:, None] * py) * scale
    off_y = (sa[:, None] * px + ca[:, None] * py) * scale
    sample_xy = uv.to(torch.float32)[:, None, :] + torch.stack([off_x, off_y], dim=-1)
    vals = _bilinear_bf16(img, sample_xy)  # (N, 60)
    bits = (vals[:, pa] > vals[:, pb]) & valid[:, None]
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = (bits.reshape(-1, DESC_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)
