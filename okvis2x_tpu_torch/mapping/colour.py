"""Per-voxel colour of a dense occupancy submap (torch counterpart of the
dense half of ``okvis2x_tpu/mapping/colour.py``, the reference's
``OccupancyColIdMap``): each integrated depth ray carries the colour of its
pixel into the voxel at its end point, accumulated as a weighted sum,

    colour(v) = col_sum(v) / max(w(v), 1),

in a store indexed like the grid (flat voxel index) with one trash row for
points outside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.mapping import submap as sm_mod


class ColourStore(NamedTuple):
    col: torch.Tensor  # (V+1, 3) weighted colour sums; the last row is trash
    w: torch.Tensor  # (V+1,) accumulation weights


def new_store(cfg: sm_mod.SubmapConfig, dtype=torch.float32, device=None) -> ColourStore:
    sm_mod.check_dense(cfg)
    V = cfg.dim ** 3
    return ColourStore(col=torch.zeros((V + 1, 3), dtype=dtype, device=device),
                       w=torch.zeros((V + 1,), dtype=dtype, device=device))


def _voxel_flat(cfg: sm_mod.SubmapConfig, p_K: torch.Tensor):
    """Flat store index of the voxel holding each point (the trash row
    outside the grid), and the in-grid mask."""
    vi, ok = sm_mod._nearest(cfg, p_K)
    return torch.where(ok, sm_mod._flat(cfg, vi), torch.full_like(vi[..., 0], cfg.dim ** 3)), ok


def splat(store: ColourStore, cfg: sm_mod.SubmapConfig, p_K: torch.Tensor, col: torch.Tensor,
          valid: torch.Tensor) -> ColourStore:
    """Accumulate per-ray colours (N, 3) in [0, 1] into the voxels of the
    end points (N, 3)."""
    flat, ok = _voxel_flat(cfg, p_K)
    ok = ok & valid
    col = torch.where(ok[:, None], col.to(store.col.dtype), torch.zeros_like(store.col[:1]))
    return ColourStore(col=store.col.index_add(0, flat, col),
                       w=store.w.index_add(0, flat, ok.to(store.w.dtype)))


def colour_at(store: ColourStore, cfg: sm_mod.SubmapConfig, p_K: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel colour at (..., 3) points; grey (0.5) where none was
    splatted."""
    flat, _ = _voxel_flat(cfg, p_K)
    w = store.w[flat]
    c = store.col[flat] / torch.clamp(w, min=1.0)[..., None]
    return torch.where(w[..., None] > 0, c, torch.full_like(c, 0.5))
