"""Keypoint classification by semantic segmentation (torch counterpart of
``okvis2x_tpu/models/segmentation.py``): keypoints on dynamic content
(person, class 11) or on texture-less infinity (sky, class 10) get larger
observation sigmas.

`FastSCNN` is the compact fast-scnn topology (learning to downsample, a
global feature extractor with a global-mean broadcast, a fusion with the
1/8 skip, a classifier), its modules named as the flax ones
(``Conv_0``, ``_DSConv_0.Conv_1`` ...), so the weights that ship with the
JAX package (``okvis2x_tpu/resources/fast_scnn.npz``, read in place as a data
file) load through `stereo_net.state_dict_from_flax`.  The depthwise 3x3
convs are flax's ``feature_group_count=C``, here ``groups=C`` (kernel
(3, 3, 1, C) -> (C, 1, 3, 3)); padding is flax's ``SAME``
(`stereo_net.pad_same`); both resizes upsample, as ``jax.image.resize``
bilinear does with half-pixel centres and clamped edges
(``align_corners=False``).  The net runs in float32 without TF32.

`sky_heuristic_weights` is the training-free fallback of the JAX package:
bright, flat keypoints in the upper 40% of the image.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from okvis2x_tpu_torch.models import stereo_net

NUM_CLASSES = 19  # Cityscapes
SKY = 10
PERSON = 11

DEFAULT_WEIGHTS = (Path(__file__).resolve().parents[2] / "okvis2x_tpu" / "resources"
                   / "fast_scnn.npz")


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` (k x k, stride, feature groups) with ``SAME``
    padding."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, k, stride=stride, groups=groups)

    def forward(self, x):
        return F.conv2d(stereo_net.pad_same(x, self.kernel_size[0], self.stride[0]),
                        self.weight, self.bias, self.stride, groups=self.groups)


class DSConv(nn.Module):
    """Depthwise 3x3 (stride s) and pointwise 1x1, each followed by a ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, cin, 3, stride, groups=cin)
        self.Conv_1 = Conv(cin, cout)

    def forward(self, x):
        return F.relu(self.Conv_1(F.relu(self.Conv_0(x))))


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, *size), bilinear upsampling as
    ``jax.image.resize``."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class FastSCNN(nn.Module):
    """Grayscale images in [0, 1], (H, W) or (N, H, W) float32 -> logits
    (H, W, NUM_CLASSES) or (N, H, W, NUM_CLASSES), channels last as flax's."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.Conv_0 = Conv(1, 32, 3, 2)
        self._DSConv_0 = DSConv(32, 48, 2)
        self._DSConv_1 = DSConv(48, 64, 2)
        self._DSConv_2 = DSConv(64, 64, 2)
        self._DSConv_3 = DSConv(64, 96, 2)
        self._DSConv_4 = DSConv(96, 128, 1)
        self.Conv_1 = Conv(128, 128)
        self.Conv_2 = Conv(128, 64)
        self.Conv_3 = Conv(64, 64)
        self._DSConv_5 = DSConv(64, 64)
        self.Conv_4 = Conv(64, num_classes)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        H, W = img.shape[-2:]
        with stereo_net.full_precision():
            x = F.relu(self.Conv_0(img.reshape(-1, 1, H, W)))
            skip = x = self._DSConv_1(self._DSConv_0(x))  # 1/8
            x = self._DSConv_4(self._DSConv_3(self._DSConv_2(x)))  # 1/32
            x = x + self.Conv_1(x.mean(dim=(2, 3), keepdim=True))
            x = _resize(x, skip.shape[-2:])
            x = F.relu(self.Conv_2(x) + self.Conv_3(skip))
            logits = _resize(self.Conv_4(self._DSConv_5(x)), (H, W))
        return logits.permute(0, 2, 3, 1).reshape(*img.shape, -1)


def nearest_pixels(uv: torch.Tensor, H: int, W: int):
    """Nearest pixel (x, y) of each keypoint, clamped to the image: round
    half to even, as jnp.round."""
    x = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
    return x, y


def sample_classes(logits: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(N,) int32 class at each keypoint of uv (N, 2): the argmax (first
    index on ties) of the logits (H, W, K) at its nearest pixel."""
    x, y = nearest_pixels(uv, *logits.shape[:2])
    return torch.argmax(logits[y, x], dim=-1).to(torch.int32)


def keypoint_weights_from_classes(classes: torch.Tensor) -> torch.Tensor:
    """Sigma multipliers (float32): sky 5, person 3, everything else 1."""
    w = torch.ones(classes.shape, dtype=torch.float32, device=classes.device)
    w = torch.where(classes == SKY, torch.full_like(w, 5.0), w)
    return torch.where(classes == PERSON, torch.full_like(w, 3.0), w)


def sky_heuristic_weights(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Training-free fallback: keypoints that are bright (> 0.8), flat
    (|dx| + |dy| < 0.02, backward differences, 0 on the first row and
    column) and in the upper 40% of the image (H, W) get 5, the rest 1."""
    H, W = img.shape
    gx = torch.diff(img, dim=1, prepend=img[:, :1]).abs()
    gy = torch.diff(img, dim=0, prepend=img[:1]).abs()
    grad = gx + gy
    x, y = nearest_pixels(uv, H, W)
    sky = (img[y, x] > 0.8) & (grad[y, x] < 0.02) & (uv[:, 1] < 0.4 * H)
    return torch.where(sky, 5.0, 1.0).to(torch.float32)


def load_params(path=DEFAULT_WEIGHTS) -> tuple:
    """The artifact's weights as a ``state_dict`` and its meta {name: float}
    (held-out IoUs, keypoint recall and false alarms), or (None, {}) when
    the file does not exist."""
    return stereo_net.load_params(path)


def trained_net(device):
    """The shipped `FastSCNN` on `device` (frozen, eval) and its meta, or
    None when the artifact does not exist; loaded once a device ("cuda"
    and "cuda:0" are one device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _trained_net(str(device))


@functools.lru_cache(maxsize=4)
def _trained_net(device: str):
    state, meta = load_params()
    if state is None:
        return None
    net = FastSCNN()
    net.load_state_dict(state)
    return net.to(device).eval().requires_grad_(False), meta


def keypoint_weights(imgs: torch.Tensor, uv: torch.Tensor, engine: str = "auto") -> torch.Tensor:
    """Per-keypoint sigma multipliers (float32) of images (H, W) or (C, H, W)
    at keypoints uv (N, 2) or (C, N, 2).  Engine "auto" runs the shipped
    `FastSCNN` when the artifact exists, else the sky heuristic; "net"
    demands the artifact; "heuristic" never runs the net."""
    single = imgs.dim() == 2
    imgs, uv = (imgs[None], uv[None]) if single else (imgs, uv)
    net = trained_net(imgs.device) if engine in ("auto", "net") else None
    if engine == "net" and net is None:
        raise FileNotFoundError(
            f"engine='net' requested but no trained segmentation artifact exists at "
            f"{DEFAULT_WEIGHTS} (tools/train_segmentation.py writes it)")
    if net is not None:
        with torch.no_grad():
            logits = net[0](imgs)
        w = torch.stack([keypoint_weights_from_classes(sample_classes(lg, u))
                         for lg, u in zip(logits, uv)])
    else:
        w = torch.stack([sky_heuristic_weights(im, u) for im, u in zip(imgs, uv)])
    return w[0] if single else w
