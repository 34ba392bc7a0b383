"""Brick-sparse occupancy submaps: fine-resolution grids on a pool of bricks
(torch counterpart of ``okvis2x_tpu/mapping/brick.py``).

The dense grid of ``mapping/submap.py`` is D^3 voxels; the reference's
25.6 m submap at 0.025 m (its ``config/euroc/se2.yaml``) is 1024^3, 8 GB
dense.  Here a submap is two levels:

  * a dense **brick table** (T^3 int32, T = dim / brick): brick -> pool
    slot, -1 where no brick is allocated (log-odds 0 there, unknown space);
  * a flat **brick pool** ((P * b^3 + 1,) float32 log-odds and weights):
    the voxels of the allocated bricks, slot by slot, and one trailing trash
    voxel that takes the samples with nowhere to go.

Allocation runs on the device with no host round trip: mark the bricks this
batch touches, number the newly needed ones by a prefix sum in table order,
and hand them the next free slots up to `pool_bricks` (the rest stay
unallocated and their samples go to the trash voxel).  So the table, the
slots' brick coordinates and the allocated count are the JAX package's
exactly.  Reads go through two chained gathers (table, then pool).  The
voxel convention (a centred grid) and the ray sampling are the dense
module's, so the ICP factor, the colour store and the submapping interface
work on either grid through the dispatch in ``mapping/submap.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.mapping import submap as dense


class BrickConfig(NamedTuple):
    table_dim: int = 128  # bricks per side (dim = table_dim * brick)
    brick: int = 8  # voxels per brick side
    res: float = 0.025  # metres per voxel
    pool_bricks: int = 8192  # allocated brick capacity
    log_odd_occ: float = 0.85
    log_odd_free: float = -0.25
    log_odd_min: float = -5.0
    log_odd_max: float = 5.0
    surface_band: float = 0.3
    samples_per_ray: int = 48
    band_samples: int = 8

    @property
    def dim(self) -> int:
        return self.table_dim * self.brick

    @property
    def b3(self) -> int:
        return self.brick ** 3


class BrickSubmap(NamedTuple):
    T_WK: torch.Tensor  # (7,) anchor pose, re-anchored on loop closure
    table: torch.Tensor  # (T^3,) int32: brick -> pool slot, -1 unallocated
    brick_xyz: torch.Tensor  # (P, 3) int32 brick coordinates of each slot
    pool_lo: torch.Tensor  # (P * b^3 + 1,) log-odds; the last voxel is trash
    pool_w: torch.Tensor  # (P * b^3 + 1,) integration counts
    n_alloc: torch.Tensor  # () int32 allocated bricks


def new_submap(T_WK, cfg: BrickConfig, dtype=torch.float32, device=None) -> BrickSubmap:
    P, V = cfg.pool_bricks, cfg.pool_bricks * cfg.b3 + 1
    return BrickSubmap(
        T_WK=torch.as_tensor(T_WK, dtype=dtype, device=device).clone(),
        table=torch.full((cfg.table_dim ** 3,), -1, dtype=torch.int32, device=device),
        brick_xyz=torch.zeros((P, 3), dtype=torch.int32, device=device),
        pool_lo=torch.zeros((V,), dtype=dtype, device=device),
        pool_w=torch.zeros((V,), dtype=dtype, device=device),
        n_alloc=torch.zeros((), dtype=torch.int32, device=device))


def _table_flat(cfg: BrickConfig, bc: torch.Tensor) -> torch.Tensor:
    T = cfg.table_dim
    return (bc[..., 0] * T + bc[..., 1]) * T + bc[..., 2]


def _pool_flat(cfg: BrickConfig, slot: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    b = cfg.brick
    return slot * cfg.b3 + (inner[..., 0] * b + inner[..., 1]) * b + inner[..., 2]


def _lookup(sm: BrickSubmap, cfg: BrickConfig, vi: torch.Tensor):
    """(pool index, allocated) of integer voxels vi (..., 3) inside the
    grid; the index of an unallocated voxel is that of slot 0."""
    bc = torch.div(vi, cfg.brick, rounding_mode="floor")
    slot = sm.table[_table_flat(cfg, bc)].to(torch.int64)
    return _pool_flat(cfg, torch.clamp(slot, min=0), vi - bc * cfg.brick), slot >= 0


def _fetch(sm: BrickSubmap, cfg: BrickConfig, vi: torch.Tensor) -> torch.Tensor:
    """Log-odds at integer voxels vi (..., 3) inside the grid; 0 in
    unallocated bricks (unknown)."""
    flat, alloc = _lookup(sm, cfg, vi)
    val = sm.pool_lo[flat]
    return torch.where(alloc, val, torch.zeros_like(val))


def _fetch_weight(sm: BrickSubmap, cfg: BrickConfig, vi: torch.Tensor) -> torch.Tensor:
    flat, alloc = _lookup(sm, cfg, vi)
    w = sm.pool_w[flat]
    return torch.where(alloc, w, torch.zeros_like(w))


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


def _scatter_updates(sm: BrickSubmap, cfg: BrickConfig, pts_K: torch.Tensor, upd: torch.Tensor,
                     ok: torch.Tensor) -> BrickSubmap:
    """Allocate the bricks that the valid samples pts_K (..., 3) touch and
    move each voxel by the mean of its samples' updates upd (...), clipped;
    the weights count the samples."""
    vi, inb = dense._nearest(cfg, pts_K)
    okf = (ok & inb).reshape(-1)
    bc = torch.div(vi, cfg.brick, rounding_mode="floor").reshape(-1, 3)
    tflat = _table_flat(cfg, bc)
    T3, P = cfg.table_dim ** 3, cfg.pool_bricks
    dev = sm.table.device

    # allocation: the touched bricks without a slot, numbered in table order
    touched = torch.zeros(T3 + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(okf, tflat, torch.full_like(tflat, T3)), True)[:T3]
    need = touched & (sm.table < 0)
    order = torch.cumsum(need, 0, dtype=torch.int32)
    new_slot = sm.n_alloc + order - 1
    table = torch.where(need & (new_slot < P), new_slot, sm.table)
    n_new = order[-1]
    n_alloc = torch.clamp(sm.n_alloc + n_new, max=P)
    # slot s of this batch went to the brick of rank s - n_alloc + 1: the
    # first table index where the prefix sum reaches that rank
    rank = torch.arange(1, P + 1, dtype=torch.int32, device=dev) - sm.n_alloc
    fresh = (rank >= 1) & (rank <= n_new)
    src = torch.searchsorted(order, torch.clamp(rank, 1, T3)).clamp(max=T3 - 1)
    T = cfg.table_dim
    xyz = torch.stack([src // (T * T), (src // T) % T, src % T], dim=-1).to(torch.int32)
    brick_xyz = torch.where(fresh[:, None], xyz, sm.brick_xyz)

    # the per-voxel mean of this batch's updates
    slot = table[tflat].to(torch.int64)
    trash = sm.pool_lo.shape[0] - 1
    flat = _pool_flat(cfg, torch.clamp(slot, min=0),
                      vi.reshape(-1, 3) - bc * cfg.brick)
    flat = torch.where(okf & (slot >= 0), flat, torch.full_like(flat, trash))
    okv = okf.to(sm.pool_lo.dtype)
    u = torch.where(okf, upd.reshape(-1).to(sm.pool_lo.dtype), torch.zeros_like(okv))
    sum_upd = torch.zeros_like(sm.pool_lo).index_add_(0, flat, u)
    cnt = torch.zeros_like(sm.pool_lo).index_add_(0, flat, okv)
    pool_lo = torch.clamp(sm.pool_lo + sum_upd / torch.clamp(cnt, min=1.0), cfg.log_odd_min,
                          cfg.log_odd_max)
    pool_lo[trash] = 0.0
    pool_w = sm.pool_w + cnt
    pool_w[trash] = 0.0
    return sm._replace(table=table, brick_xyz=brick_xyz, pool_lo=pool_lo, pool_w=pool_w,
                       n_alloc=n_alloc)


def integrate_rays(sm: BrickSubmap, cfg: BrickConfig, origin_K: torch.Tensor,
                   end_K: torch.Tensor, valid: torch.Tensor, sigma=0.1) -> BrickSubmap:
    """Batch ray integration with the dense module's sampling profile,
    scattered through the brick table."""
    pts, upd, ok = dense._ray_samples(cfg, origin_K, end_K, valid, sigma, sm.pool_lo.dtype)
    return _scatter_updates(sm, cfg, pts, upd, ok)


# ---------------------------------------------------------------------------
# the field: trilinear interpolation through the two-level gather
# ---------------------------------------------------------------------------


def _corners(sm: BrickSubmap, cfg: BrickConfig, p_K: torch.Tensor):
    """The 8 trilinear corner values g[dx][dy][dz] (...), the fractions
    (..., 3) and the in-grid mask of points p_K (..., 3), the corners
    fetched in one two-level gather."""
    v = dense._world_to_voxel(cfg, p_K)
    ok = dense._in_bounds(cfg, v)
    v = torch.clamp(v, 0.0, cfg.dim - 1.001)
    v0 = torch.floor(v).to(torch.int64)
    f = v - v0
    i = torch.arange(8, device=v0.device)
    corner = torch.stack([i >> 2, (i >> 1) & 1, i & 1], dim=-1)
    vals = _fetch(sm, cfg, v0[..., None, :] + corner)
    g = [[[vals[..., 4 * dx + 2 * dy + dz] for dz in (0, 1)] for dy in (0, 1)] for dx in (0, 1)]
    return g, f, ok


def interp_occupancy(sm: BrickSubmap, cfg: BrickConfig, p_K: torch.Tensor):
    """Trilinear log-odds at points (..., 3): (value, inside); 0 outside."""
    g, f, ok = _corners(sm, cfg, p_K)
    return dense._trilinear(g, f, ok)


def grad_occupancy(sm: BrickSubmap, cfg: BrickConfig, p_K: torch.Tensor):
    """Gradient of the trilinear field in metres (..., 3): (gradient,
    inside); 0 outside."""
    g, f, ok = _corners(sm, cfg, p_K)
    return dense._trilinear_grad(g, f, ok, cfg.res)


def observed_mask(sm: BrickSubmap, cfg: BrickConfig, p_K: torch.Tensor) -> torch.Tensor:
    """(...) bool: the point lands in a voxel with integration weight > 0."""
    vi, ok = dense._nearest(cfg, p_K)
    return (_fetch_weight(sm, cfg, vi) > 0) & ok


def occupied_point_list(sm: BrickSubmap, cfg: BrickConfig, threshold: float = 1.0,
                        max_points: int = 4096):
    """The first `max_points` occupied voxel centres in pool order (submap
    frame) and which are valid; the rows past the occupied count hold the
    centre of pool voxel 0, as the JAX package's fixed-size nonzero fills
    them."""
    occ = sm.pool_lo[:-1] > threshold
    idx = torch.nonzero(occ)[:max_points, 0]
    n = idx.shape[0]
    idx = torch.cat([idx, idx.new_zeros(max_points - n)])
    b = cfg.brick
    inner = idx % cfg.b3
    inner = torch.stack([inner // (b * b), (inner // b) % b, inner % b], dim=-1)
    vi = sm.brick_xyz[idx // cfg.b3].to(torch.int64) * b + inner
    centres = (vi.to(sm.pool_lo.dtype) + 0.5) * cfg.res - cfg.dim * cfg.res / 2.0
    valid = torch.arange(max_points, device=occ.device) < n
    return centres, valid
