"""Learned correlation-volume stereo network (torch counterpart of
``okvis2x_tpu/models/stereo_net.py``): a feature CNN per image, a
correlation cost volume over D/4 disparities at quarter resolution, 2-D
aggregation, soft-argmin disparity, a log-sigma head, and bilinear
upsampling to full resolution.

The modules carry the flax parameter names (``FeatureNet_0.Conv_0`` ...), so
the weights that ship with the JAX package (``okvis2x_tpu/resources/
stereo_net.npz``, flat '/'-joined flax paths) load by `state_dict_from_flax`:
conv kernels (kh, kw, in, out) -> (out, in, kh, kw), dense kernels
(in, out) -> (out, in).  flax's ``SAME`` padding of a stride-2 3x3 conv pads
(0, 1) on an even side and (1, 1) on an odd one (`pad_same`), not the
symmetric padding of ``Conv2d(padding=1)``.  The nets compute their
convolutions and products in full float32 on a card (`full_precision`), as
the JAX package runs them at ``highest`` precision.
"""

from __future__ import annotations

import contextlib
import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_WEIGHTS = (Path(__file__).resolve().parents[2] / "okvis2x_tpu" / "resources"
                   / "stereo_net.npz")


@contextlib.contextmanager
def full_precision():
    """No TF32 in cuDNN convolutions or cuBLAS products inside the block
    (restored after it)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax/XLA ``SAME`` padding of an (N, C, H, W) input for a k x k conv
    of stride s: the total padding split low = total // 2, high the rest."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with ``SAME`` padding (3x3 kernels); as in flax,
    the parameters take the input's dtype when it is wider."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride=stride)

    def forward(self, x):
        return F.conv2d(pad_same(x, 3, self.stride[0]), self.weight.to(x.dtype),
                        self.bias.to(x.dtype), self.stride)


class FeatureNet(nn.Module):
    """(N, 1, H, W) -> (N, c, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2))."""

    def __init__(self, channels: int = 64):
        super().__init__()
        c = channels
        self.Conv_0 = Conv(1, c // 2, stride=2)
        self.Conv_1 = Conv(c // 2, c // 2)
        self.Conv_2 = Conv(c // 2, c, stride=2)
        self.Conv_3 = Conv(c, c)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        return self.Conv_3(x)


class AggregationNet(nn.Module):
    """Residual refinement of an (N, D, h, w) cost volume."""

    def __init__(self, depth: int, channels: int = 32):
        super().__init__()
        self.Conv_0 = Conv(depth, channels)
        self.Conv_1 = Conv(channels, channels)
        self.Conv_2 = Conv(channels, depth)

    def forward(self, vol):
        x = F.relu(self.Conv_0(vol))
        x = F.relu(self.Conv_1(x))
        return vol + self.Conv_2(x)


class SigmaHead(nn.Module):
    """(N, 3, h, w) volume statistics -> (N, h, w) log sigma."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 32)
        self.Conv_1 = Conv(32, 1)

    def forward(self, feats):
        return self.Conv_1(F.relu(self.Conv_0(feats)))[:, 0]


def upsample(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(h, w) -> (H, W) bilinear with half-pixel centres, edges clamped
    (``jax.image.resize(..., "bilinear")`` when upsampling)."""
    return F.interpolate(x[None, None], size=(H, W), mode="bilinear", align_corners=False)[0, 0]


class StereoNet(nn.Module):
    """(left, right) grayscale (H, W) in [0, 1] -> (disparity, sigma_d) at
    full resolution; two feature nets with weights of their own."""

    def __init__(self, max_disp: int = 64, channels: int = 64):
        super().__init__()
        self.max_disp = max_disp
        self.FeatureNet_0 = FeatureNet(channels)
        self.FeatureNet_1 = FeatureNet(channels)
        self.AggregationNet_0 = AggregationNet(max_disp // 4)
        self.SigmaHead_0 = SigmaHead()

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        H, W = left.shape
        with full_precision():
            fl = self.FeatureNet_0(left[None, None])[0]  # (c, h, w)
            fr = self.FeatureNet_1(right[None, None])[0]
            d4 = self.max_disp // 4
            # correlation volume (D, h, w); a shift wraps and is masked
            xs = torch.arange(fl.shape[-1], device=fl.device)
            vol = torch.stack([
                torch.where(xs >= d, (fl * torch.roll(fr, d, dims=2)).mean(0),
                            torch.full_like(fl[0], -30.0))
                for d in range(d4)])
            vol = self.AggregationNet_0(vol[None])[0]
            att = torch.softmax(vol, dim=0)
            ds = torch.arange(d4, dtype=left.dtype, device=left.device)
            disp4 = (att * ds[:, None, None]).sum(0)
            ent = -(att * torch.log(torch.clamp(att, min=1e-9))).sum(0)
            log_sigma4 = self.SigmaHead_0(torch.stack([disp4, ent, vol.amax(0)])[None])[0]
        disp = 4.0 * upsample(disp4, H, W)
        # log sigma clipped so that a cold head cannot overflow exp()
        sigma = torch.exp(torch.clamp(upsample(log_sigma4, H, W), -4.0, 4.0)) + 0.1
        return disp, sigma


def state_dict_from_flax(flat) -> dict:
    """Flat flax parameters ('/'-joined paths, with or without the leading
    'params') -> a torch ``state_dict`` of modules named as above."""
    out = {}
    for key, v in flat.items():
        parts = [p for p in key.split("/") if p]
        if parts[0] == "params":
            parts = parts[1:]
        a = np.array(v, np.float32)  # a copy: jax arrays are read-only
        if parts[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            parts[-1] = "weight"
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_params(path) -> tuple:
    """Read a flat npz artifact (the stereo or the MVS net's): its weights as
    a ``state_dict`` and its meta {name: float} (held-out RMSEs, shapes), or
    (None, {}) when the file does not exist."""
    if not Path(path).exists():
        return None, {}
    params, meta = {}, {}
    with np.load(path) as raw:
        for k in raw.files:
            if k.startswith("__meta_"):
                meta[k[7:]] = float(raw[k])
            else:
                params[k] = raw[k]
    return state_dict_from_flax(params), meta


@functools.lru_cache(maxsize=8)
def trained(path: str, max_disp: int, device: str):
    """The trained `StereoNet` on `device` and its meta, or None when the
    artifact does not exist or was trained for another disparity range
    (the cost volume's width is in its kernels)."""
    state, meta = load_params(path)
    if state is None or int(meta.get("max_disp", 64)) != max_disp:
        return None
    net = StereoNet(max_disp=max_disp)
    net.load_state_dict(state)
    return net.to(device).eval().requires_grad_(False), meta
