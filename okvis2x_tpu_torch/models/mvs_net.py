"""Learned multi-view-stereo depth network (torch counterpart of
``okvis2x_tpu/models/mvs_net.py``): one feature CNN shared by the reference
and the source frames, a plane-sweep cost volume of per-hypothesis metadata
(mean correlation and absolute difference over the sources that see the
pixel, the fraction that see it, and optional sparse-depth hints) reduced
by a small MLP, 2-D aggregation, soft-argmin over inverse depth, a log-sigma
head and bilinear upsampling.  The hypotheses, the depth range and the
source count come from the artifact's meta (``okvis2x_tpu/resources/
mvs_net.npz``: 32 inverse depths from 0.25 m to 8 m, two sources).

The features are float32; the hypotheses, the warp and everything after it
are float64, as the JAX package computes them in its float64 (x64)
configuration, where the float64 hypotheses promote the cost volume and
flax runs the layers after it at the input's precision (the weights are
widened, exactly).  The output differs from a float32 volume by up to tenths
of a metre on ambiguous pixels, so the precision is part of the result.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from okvis2x_tpu_torch.models.stereo_net import (
    AggregationNet, FeatureNet, SigmaHead, full_precision, load_params, upsample)
from okvis2x_tpu_torch.utils.linspace import linspace

DEFAULT_WEIGHTS = (Path(__file__).resolve().parents[2] / "okvis2x_tpu" / "resources"
                   / "mvs_net.npz")


def _warp_features(feat_src: torch.Tensor, fxfycxcy4: torch.Tensor, T_sr: torch.Tensor,
                   depths: torch.Tensor):
    """Back-project every quarter-resolution reference pixel at each
    hypothesis depth, move it into the source camera (T_sr (4, 4)) and
    sample the source features (c, h, w) bilinearly: ((D, c, h, w) warped,
    (D, h, w) valid)."""
    c, h, w = feat_src.shape
    fx, fy, cx, cy = fxfycxcy4.unbind(-1)
    dt, dev = feat_src.dtype, feat_src.device
    ys = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=dt, device=dev)[None, :].expand(h, w)
    d = depths[:, None, None]
    X = (xs - cx) / fx * d
    Y = (ys - cy) / fy * d
    Z = d.expand_as(X)
    P = torch.stack([X, Y, Z, torch.ones_like(X)], dim=-1)  # (D, h, w, 4)
    Q = P @ T_sr.T.to(P.dtype)
    z = torch.clamp(Q[..., 2], min=1e-6)
    u = Q[..., 0] / z * fx + cx
    v = Q[..., 1] / z * fy + cy
    valid = (Q[..., 2] > 1e-4) & (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u = torch.clamp(u, 0.0, w - 1.0)
    v = torch.clamp(v, 0.0, h - 1.0)
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.floor(v).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = (u - x0)[:, None]
    wy = (v - y0)[:, None]
    flat = feat_src.reshape(c, h * w)

    def at(yy, xx):  # (D, h, w) indices -> (D, c, h, w)
        return flat[:, (yy * w + xx).reshape(-1)].reshape(c, *yy.shape).transpose(0, 1)

    warped = (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy)
              + at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy)
    return warped, valid


class Dense(nn.Linear):
    """flax ``nn.Dense``: the parameters take the input's dtype when it is
    wider."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class MatchingMlp(nn.Module):
    """Per (pixel, hypothesis) metadata (..., 5) -> matching score (...)."""

    def __init__(self, n_in: int = 5, hidden: int = 16):
        super().__init__()
        self.Dense_0 = Dense(n_in, hidden)
        self.Dense_1 = Dense(hidden, hidden)
        self.Dense_2 = Dense(hidden, 1)

    def forward(self, x):
        return self.Dense_2(F.relu(self.Dense_1(F.relu(self.Dense_0(x)))))[..., 0]


# the same residual refinement as the stereo net's, under the JAX module name
CostAggregation = AggregationNet


class MvsNet(nn.Module):
    """(ref (H, W), sources (S, H, W), fxfycxcy (4,), T_sr (S, 4, 4)
    ref-cam -> src-cam, [sparse depth hints (H, W), 0 = none]) ->
    (depth, sigma) at full resolution."""

    def __init__(self, n_depths: int = 32, d_min: float = 0.25, d_max: float = 8.0,
                 channels: int = 64):
        super().__init__()
        self.n_depths, self.d_min, self.d_max = n_depths, d_min, d_max
        self.FeatureNet_0 = FeatureNet(channels)
        self.MatchingMlp_0 = MatchingMlp()
        self.CostAggregation_0 = CostAggregation(n_depths)
        self.SigmaHead_0 = SigmaHead()

    def forward(self, ref: torch.Tensor, sources: torch.Tensor, fxfycxcy: torch.Tensor,
                T_sr: torch.Tensor, sparse_depth: Optional[torch.Tensor] = None):
        H, W = ref.shape
        dt, dev = torch.float64, ref.device
        with full_precision():
            f_ref = self.FeatureNet_0(ref[None, None])[0]  # (c, h, w)
            f_srcs = self.FeatureNet_0(sources[:, None])  # (S, c, h, w)
            c, h, w = f_ref.shape
            k4 = fxfycxcy / 4.0
            inv = linspace(1.0 / self.d_max, 1.0 / self.d_min, self.n_depths, dtype=dt, device=dev)
            depths = 1.0 / inv
            corr_s, mad_s, valid_s = [], [], []
            for s in range(sources.shape[0]):
                warped, valid = _warp_features(f_srcs[s], k4, T_sr[s], depths)
                corr_s.append((f_ref * warped).mean(1))
                mad_s.append((f_ref - warped).abs().mean(1))
                valid_s.append(valid.to(ref.dtype))
            corr, mad, valid = torch.stack(corr_s), torch.stack(mad_s), torch.stack(valid_s)
            nv = torch.clamp(valid.sum(0), min=1.0)
            corr_m = (corr * valid).sum(0) / nv
            mad_m = (mad * valid).sum(0) / nv
            vfrac = valid.mean(0)
            if sparse_depth is not None:
                hint4 = F.interpolate(sparse_depth[None, None], size=(h, w),
                                      mode="nearest-exact")[0, 0]
                hint_ok = (hint4 > 1e-3).to(ref.dtype)
                hint_err = hint_ok * (1.0 / torch.clamp(hint4, min=1e-3)
                                      - 1.0 / depths[:, None, None]).abs()
                hint_ok = hint_ok.expand_as(hint_err)
            else:
                hint_err = hint_ok = torch.zeros_like(vfrac)
            meta = torch.stack([x.to(dt) for x in (corr_m, mad_m, vfrac, hint_err, hint_ok)],
                               dim=-1)  # (D, h, w, 5)
            vol = self.MatchingMlp_0(meta)  # (D, h, w)
            vol = self.CostAggregation_0(vol[None])[0]
            att = torch.softmax(vol, dim=0)
            inv_d = (att * inv[:, None, None]).sum(0)
            depth4 = 1.0 / torch.clamp(inv_d, min=1.0 / self.d_max)
            ent = -(att * torch.log(torch.clamp(att, min=1e-9))).sum(0)
            log_sigma4 = self.SigmaHead_0(torch.stack([depth4, ent, vol.amax(0)])[None])[0]
        depth = upsample(depth4, H, W)
        sigma = torch.exp(upsample(log_sigma4, H, W)) + 0.01
        return depth, sigma


@functools.lru_cache(maxsize=8)
def trained(path: str, device: str):
    """The trained `MvsNet` on `device` with its meta, or None without the
    artifact."""
    state, meta = load_params(path)
    if state is None:
        return None
    net = MvsNet(n_depths=int(meta.get("n_depths", 32)), d_min=meta.get("d_min", 0.25),
                 d_max=meta.get("d_max", 8.0))
    net.load_state_dict(state)
    return net.to(device).eval().requires_grad_(False), meta
