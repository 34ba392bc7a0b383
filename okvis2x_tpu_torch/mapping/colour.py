"""Per-voxel colour of an occupancy submap (torch counterpart of
``okvis2x_tpu/mapping/colour.py``, the reference's ``OccupancyColIdMap``):
each integrated depth ray carries the colour of its pixel into the voxel at
its end point, accumulated as a weighted sum,

    colour(v) = col_sum(v) / max(w(v), 1),

in a store indexed like the grid, with one trash row for points outside it:
the flat voxel index of a dense grid, or the pool index of a brick-sparse
one (table, then pool slot; points in unallocated bricks go to the trash
row, so splat after the occupancy integration has allocated them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.mapping import submap as sm_mod


class ColourStore(NamedTuple):
    col: torch.Tensor  # (V+1, 3) weighted colour sums; the last row is trash
    w: torch.Tensor  # (V+1,) accumulation weights


def _n_voxels(cfg) -> int:
    return cfg.pool_bricks * cfg.b3 if sm_mod.is_brick(cfg) else cfg.dim ** 3


def new_store(cfg, dtype=torch.float32, device=None) -> ColourStore:
    V = _n_voxels(cfg)
    return ColourStore(col=torch.zeros((V + 1, 3), dtype=dtype, device=device),
                       w=torch.zeros((V + 1,), dtype=dtype, device=device))


def _voxel_flat(cfg, p_K: torch.Tensor, sm=None):
    """Store index of the voxel holding each point (the trash row outside
    the grid or, for a brick grid `sm`, in an unallocated brick), and
    whether it has one."""
    vi, ok = sm_mod._nearest(cfg, p_K)
    if sm_mod.is_brick(cfg):
        from okvis2x_tpu_torch.mapping import brick

        flat, alloc = brick._lookup(sm, cfg, vi)
        ok = ok & alloc
    else:
        flat = sm_mod._flat(cfg, vi)
    return torch.where(ok, flat, torch.full_like(flat, _n_voxels(cfg))), ok


def splat(store: ColourStore, cfg, p_K: torch.Tensor, col: torch.Tensor, valid: torch.Tensor,
          sm=None) -> ColourStore:
    """Accumulate per-ray colours (N, 3) in [0, 1] into the voxels of the
    end points (N, 3); a brick grid needs its submap `sm`."""
    flat, ok = _voxel_flat(cfg, p_K, sm)
    ok = ok & valid
    col = torch.where(ok[:, None], col.to(store.col.dtype), torch.zeros_like(store.col[:1]))
    return ColourStore(col=store.col.index_add(0, flat, col),
                       w=store.w.index_add(0, flat, ok.to(store.w.dtype)))


def colour_at(store: ColourStore, cfg, p_K: torch.Tensor, sm=None) -> torch.Tensor:
    """Nearest-voxel colour at (..., 3) points; grey (0.5) where none was
    splatted; a brick grid needs its submap `sm`."""
    flat, _ = _voxel_flat(cfg, p_K, sm)
    w = store.w[flat]
    c = store.col[flat] / torch.clamp(w, min=1.0)[..., None]
    return torch.where(w[..., None] > 0, c, torch.full_like(c, 0.5))
