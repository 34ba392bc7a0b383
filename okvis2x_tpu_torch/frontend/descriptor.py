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

The sample positions are reproduced bit for bit too, since an ulp there can
flip a bf16-rounded weight: the extraction direction's cosine and sine are
those of the C library's ``cosf`` / ``sinf`` that XLA calls on the CPU
(`sincosf`, evaluated in float64 with its constants), and the rotation of the
pattern is XLA's dot over two columns, the first product rounded and the
second fused into it (one multiply-add, emulated in float64).
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


# glibc's sinf / cosf (sysdeps/ieee754/flt-32: s_sinf.c, s_cosf.c and the
# __sincosf_table of s_sincosf_data.c), which XLA's CPU code calls
_COS_POLY = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16"))
_SIN_POLY = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_HPI_INV_2P24 = float.fromhex("0x1.45F306DC9C883p+23")  # 2 / pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")
_EXP_PIO4 = 0x3F4  # the top 12 bits (sign cleared) of float32 pi / 4
_EXP_2M12 = 0x39800000 >> 20  # ... and of 2^-12


def sincosf(angle: torch.Tensor):
    """(sin, cos) of float32 angles as the C library's sinf and cosf give
    them for |angle| < 120 (the fast range reduction): the polynomials in
    float64 on the angle reduced to [-pi/4, pi/4], rounded once to float32;
    below 2^-12 sin is the angle and cos is 1."""
    y = angle.to(torch.float32)
    top = (y.view(torch.int32) >> 20) & 0x7FF
    small, tiny = top < _EXP_PIO4, top < _EXP_2M12
    x = y.to(torch.float64)
    n = ((x * _HPI_INV_2P24).to(torch.int32) + 0x800000) >> 24
    n = torch.where(small, torch.zeros_like(n), n)
    xr = torch.where(small, x, x - n.to(torch.float64) * _HPI)
    # the second table negates the cosine polynomial (quadrants 2 and 3)
    cs = torch.where((n & 2) != 0, -1.0, 1.0).to(torch.float64)
    sign = torch.where(((n + 1) & 2) != 0, -1.0, 1.0).to(torch.float64)  # 1, -1, -1, 1
    xs = torch.where(small, xr, xr * sign)
    x2 = xr * xr
    x3 = xs * x2
    sin_p = (xs + x3 * _SIN_POLY[0]) + (x3 * x2) * (_SIN_POLY[1] + x2 * _SIN_POLY[2])
    c = _COS_POLY
    x4 = x2 * x2
    cos_p = ((cs * c[0] + x2 * (cs * c[1])) + x4 * (cs * c[2])) \
        + (x4 * x2) * (cs * c[3] + x2 * (cs * c[4]))
    odd = (n & 1) == 1
    s = torch.where(odd, cos_p, sin_p).to(torch.float32)
    co = torch.where(odd, sin_p, cos_p).to(torch.float32)
    return torch.where(tiny, y, s), torch.where(tiny, torch.ones_like(y), co)


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
    sa, ca = sincosf(angle)
    pts, pa, pb = pattern(dev)
    scale = (1.0 + level.to(torch.float32))[:, None]
    px, py = pts[None, :, 0], pts[None, :, 1]
    # x = fma(-sin, py, cos * px), y = fma(cos, py, sin * px): the float32
    # products of two float32 values are exact in float64, so one rounding of
    # the float64 sum is the fused multiply-add (but for a double rounding
    # within 2^-50 of a float32 midpoint)
    py64 = py.to(torch.float64)
    off_x = ((-sa).to(torch.float64)[:, None] * py64
             + (ca[:, None] * px).to(torch.float64)).to(torch.float32) * scale
    off_y = (ca.to(torch.float64)[:, None] * py64
             + (sa[:, None] * px).to(torch.float64)).to(torch.float32) * scale
    sample_xy = uv.to(torch.float32)[:, None, :] + torch.stack([off_x, off_y], dim=-1)
    vals = _bilinear_bf16(img, sample_xy)  # (N, 60)
    bits = (vals[:, pa] > vals[:, pb]) & valid[:, None]
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = (bits.reshape(-1, DESC_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)
