"""Robust loss correctors (Cauchy / Huber / Tukey), torch counterpart of
``okvis2x_tpu/factors/robust.py``.  For s = ||r||^2 the IRLS weight is
rho'(s); residual and Jacobian are scaled by sqrt(rho'(s))."""

from __future__ import annotations

import torch

CAUCHY = "cauchy"
HUBER = "huber"
TUKEY = "tukey"
NONE = "none"


def rho_prime(loss: str, s: torch.Tensor, scale: float) -> torch.Tensor:
    """d rho / d s for the loss with scale parameter (delta^2 = scale^2)."""
    a2 = scale * scale
    if loss == NONE:
        return torch.ones_like(s)
    if loss == CAUCHY:
        return 1.0 / (1.0 + s / a2)
    if loss == HUBER:
        return torch.where(
            s <= a2, torch.ones_like(s), scale / torch.sqrt(torch.clamp(s, min=1e-24))
        )
    if loss == TUKEY:
        w = 1.0 - s / a2
        return torch.where(s <= a2, w * w, torch.zeros_like(s))
    raise ValueError(loss)


def weight(loss: str, r_norm2: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-factor IRLS weight w = rho'(||r||^2)."""
    return rho_prime(loss, r_norm2, scale)


def rho(loss: str, s: torch.Tensor, scale: float) -> torch.Tensor:
    """Robustified cost rho(s) for s = ||r||^2."""
    a2 = scale * scale
    if loss == NONE:
        return s
    if loss == CAUCHY:
        return a2 * torch.log1p(s / a2)
    if loss == HUBER:
        sq = torch.sqrt(torch.clamp(s, min=1e-24))
        return torch.where(s <= a2, s, 2.0 * scale * sq - a2)
    if loss == TUKEY:
        w = 1.0 - s / a2
        return torch.where(
            s <= a2, (a2 / 3.0) * (1.0 - w**3), torch.full_like(s, a2 / 3.0)
        )
    raise ValueError(loss)
