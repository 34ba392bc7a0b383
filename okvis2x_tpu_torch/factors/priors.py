"""Unary and binary prior factors (torch counterpart of
``okvis2x_tpu/factors/priors.py``): whitened differences on the manifold.
Functions broadcast over leading batch dimensions."""

from __future__ import annotations

import torch

from okvis2x_tpu_torch.core import se3


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def pose_prior_residual(T_prior, T, sqrt_info):
    """6-dim pose prior: W * (T ⊟ T_prior)."""
    return _mv(sqrt_info, se3.local_delta(T_prior, T))


def speed_bias_prior_residual(sb_prior, sb, sqrt_info):
    """9-dim speed/bias prior."""
    return _mv(sqrt_info, sb - sb_prior)


def relative_pose_residual(T_rel_meas, T_WA, T_WB, sqrt_info):
    """6-dim relative pose factor: W * ((T_WA^-1 T_WB) ⊟ T_rel_meas)."""
    T_AB = se3.se3_multiply(se3.se3_inverse(T_WA), T_WB)
    return _mv(sqrt_info, se3.local_delta(T_rel_meas, T_AB))


def homogeneous_point_prior_residual(hp_prior, hp, sqrt_info):
    """3-dim landmark prior on the xyz part."""
    return _mv(sqrt_info, hp[..., :3] - hp_prior[..., :3])
