"""Two-view midpoint triangulation, batched (torch counterpart of
``okvis2x_tpu/frontend/triangulation.py``).  Rays e_A from p_A and e_B from
p_B in a common frame A; returns homogeneous points in A with `valid` (rays
meet in front of both cameras) and `parallel` (degenerate parallax: the
bearing at infinity, w = 0, is returned)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Triangulation(NamedTuple):
    hp_A: torch.Tensor  # (..., 4)
    valid: torch.Tensor  # (...,) bool
    parallel: torch.Tensor  # (...,) bool


def triangulate(p_A, e_A, p_B, e_B, sigma: float = 1e-3) -> Triangulation:
    t = p_B - p_A
    b1 = torch.sum(t * e_A, dim=-1)
    b2 = torch.sum(t * e_B, dim=-1)
    c = torch.sum(e_A * e_B, dim=-1)
    denom = 1.0 - c * c
    parallel = denom < (sigma * sigma)
    denom_safe = torch.where(parallel, torch.ones_like(denom), denom)
    lambda_A = (b1 - b2 * c) / denom_safe
    lambda_B = (b1 * c - b2) / denom_safe
    xA = p_A + lambda_A[..., None] * e_A
    xB = p_B + lambda_B[..., None] * e_B
    mid = 0.5 * (xA + xB)
    bearing = 0.5 * (e_A + e_B)
    hp = torch.where(
        parallel[..., None],
        torch.cat([bearing, torch.zeros_like(b1)[..., None]], dim=-1),
        torch.cat([mid, torch.ones_like(b1)[..., None]], dim=-1),
    )
    gap = torch.linalg.norm(xA - xB, dim=-1)
    depth_ok = (lambda_A > 0) & (lambda_B > 0)
    agree = gap < 0.1 * torch.clamp(lambda_A.abs(), min=1.0)
    valid = torch.where(parallel, torch.ones_like(depth_ok), depth_ok & agree)
    return Triangulation(hp_A=hp, valid=valid, parallel=parallel)
