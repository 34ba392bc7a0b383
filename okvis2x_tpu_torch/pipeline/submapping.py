"""Submapping: the life cycle of keyframe-anchored occupancy submaps, the
integration of depth images and LiDAR sweeps into them, and map-to-map
alignment edges (torch counterpart of ``okvis2x_tpu/pipeline/submapping.py``;
the reference's SubmappingInterface).

A keyframe's depth image or a sweep goes into the active submap, or starts a
new one when there is none, or when the active one has integrated enough
frames and either more than `new_submap_kf_count` keyframes or less than
`new_submap_overlap` of the measurement's points land in voxels it has
already observed (`decide_new_submap`).  A submap that closes hands an
alignment edge between the previous submap's anchor and its own to the
`align_callback`: its occupied voxels registered against the previous
submap's field, summarised as a relative-pose edge.  Submaps are re-anchored
when their anchor keyframe moves (`on_state_update`) and export their
occupied voxels as a PLY point cloud, coloured where colour was splatted, a
submap's marching-tetrahedra mesh as a PLY mesh (`export_mesh_ply`, dense
grids) and their bounding boxes as legacy VTK (`export_vtk_bboxes`).
The grids live on the interface's device, dense up to 256^3 and brick-sparse
beyond (`SubmappingConfig.from_se2`); pose bookkeeping runs on the host with
float32 anchors, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.mapping import colour as col_mod
from okvis2x_tpu_torch.mapping import icp_factor
from okvis2x_tpu_torch.mapping import submap as sm_mod


@dataclasses.dataclass
class SubmappingConfig:
    # the grid: dense `SubmapConfig`, or brick-sparse `mapping.brick.BrickConfig`
    submap: object = sm_mod.SubmapConfig()
    # the se2.yaml submap thresholds
    new_submap_overlap: float = 0.1
    new_submap_kf_count: int = 20
    min_frames_integrated: int = 4
    align_points: int = 200  # alignment points per submap pair
    sensor_sigma: float = 0.4
    depth_stride: int = 4
    max_depth: float = 20.0

    @classmethod
    def from_se2(cls, se2, pool_bricks: int = 8192) -> "SubmappingConfig":
        """The runtime config of a parsed se2.yaml (`io.config.SubMapConfig`)
        at its `map_res`: a dense grid up to 256 voxels a side, else the
        brick-sparse grid of 8^3 bricks with `pool_bricks` slots and up to
        192 free-space samples a ray; the band sampled at voxel pitch."""
        res = se2.map_res
        dim = int(round(max(se2.map_dim) / res))
        band = 0.3
        lo = dict(log_odd_min=se2.data.log_odd_min, log_odd_max=se2.data.log_odd_max,
                  surface_band=band, band_samples=max(8, int(1.5 * band / res) + 1))
        if dim <= 256:
            grid = sm_mod.SubmapConfig(dim=dim, res=res, **lo)
        else:
            from okvis2x_tpu_torch.mapping import brick

            b = 8
            grid = brick.BrickConfig(table_dim=-(-dim // b), brick=b, res=res,
                                     pool_bricks=pool_bricks,
                                     samples_per_ray=max(48, min(192, int(0.75 * dim / 8))),
                                     **lo)
        return cls(
            submap=grid,
            new_submap_overlap=se2.submap_overlap_ratio,
            new_submap_kf_count=se2.submap_kf_threshold,
            min_frames_integrated=se2.submap_min_frames,
            align_points=se2.num_submap_factors,
            sensor_sigma=max(se2.sensor_error, 0.01),
            depth_stride=max(1, se2.depth_image_res_downsampling),
            max_depth=se2.far_plane if se2.far_plane > 0 else 20.0,
        )


@dataclasses.dataclass
class SubmapEntry:
    sid: int
    anchor_fid: int  # the keyframe that anchors T_WK
    sm: object  # mapping.submap.Submap or mapping.brick.BrickSubmap
    n_frames: int = 0
    kf_ids: set = dataclasses.field(default_factory=set)
    finished: bool = False
    col: Optional[col_mod.ColourStore] = None  # per-voxel colour, once splatted


def _f32(T) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T, np.float64), dtype=torch.float32)


class SubmappingInterface:
    """Host orchestration of the occupancy submaps on `device` (None: the
    first CUDA device; raises without one); `align_callback` receives the
    map-to-map alignment edges."""

    def __init__(self, cfg: SubmappingConfig, align_callback: Optional[Callable] = None,
                 device=None):
        self.align_callback = align_callback
        self.cfg = cfg
        self.device = default_device() if device is None else torch.device(device)
        self.maps: List[SubmapEntry] = []
        self._next_sid = 0

    @property
    def active(self) -> Optional[SubmapEntry]:
        return self.maps[-1] if self.maps else None

    # ------------------------------------------------------------ life cycle
    def _overlap_fraction(self, entry: SubmapEntry, pts_W: torch.Tensor,
                          good: torch.Tensor) -> float:
        """Fraction of the good points (world frame, float32) that land in
        voxels the submap has observed."""
        n = int(good.sum())
        if n == 0:
            return 0.0
        seen = sm_mod.observed_mask(entry.sm, self.cfg.submap,
                                    self._to_submap_frame(entry, pts_W))
        return float(torch.sum(seen & good).to(torch.float32) / n)

    def _to_submap_frame(self, entry: SubmapEntry, pts_W: torch.Tensor) -> torch.Tensor:
        """World points (float32) into the submap's frame through its float32
        anchor."""
        return se3.se3_apply(se3.se3_inverse(entry.sm.T_WK), pts_W)

    def decide_new_submap(self, kf_fid: int, pts_W: torch.Tensor, good: torch.Tensor) -> bool:
        """New when there is none; else, once the active one has integrated
        `min_frames_integrated` frames, for a keyframe it has not seen: when
        more than `new_submap_kf_count` keyframes went in, or when less than
        `new_submap_overlap` of the points `pts_W` (those where `good`)
        land in observed voxels."""
        a = self.active
        if a is None:
            return True
        if a.n_frames < self.cfg.min_frames_integrated or kf_fid in a.kf_ids:
            return False
        if len(a.kf_ids) > self.cfg.new_submap_kf_count:
            return True
        return self._overlap_fraction(a, pts_W, good) < self.cfg.new_submap_overlap

    def start_submap(self, kf_fid: int, T_WK: np.ndarray) -> SubmapEntry:
        if self.active is not None:
            self.finish_submap()
        e = SubmapEntry(sid=self._next_sid, anchor_fid=kf_fid,
                        sm=sm_mod.new_submap(_f32(T_WK), self.cfg.submap, device=self.device))
        self._next_sid += 1
        self.maps.append(e)
        return e

    def finish_submap(self):
        """Close the active submap; with a callback, hand it the alignment
        edge between the previous submap and this one (when informative)."""
        a = self.active
        if a is None or a.finished:
            return
        a.finished = True
        if self.align_callback is not None and len(self.maps) >= 2:
            edge = self.make_alignment_edge(self.maps[-2], a)
            if edge is not None:
                self.align_callback(edge)

    def _anchor_to(self, entry: SubmapEntry, T_WX: np.ndarray) -> torch.Tensor:
        """T_KX (float32, on the device) from the float32 anchor and a float64
        pose, composed as the JAX package composes it."""
        T_KX = se3.se3_multiply(se3.se3_inverse(entry.sm.T_WK.cpu()).double(),
                                torch.as_tensor(np.asarray(T_WX, np.float64)))
        return T_KX.to(device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------ integrate
    def _decision_points(self, cam: pinhole.Camera, T_WC: np.ndarray, depth: torch.Tensor):
        """The points of a sparse pixel grid (every 4 * depth_stride
        pixels) in the world, float32 as the JAX package takes them, and
        which of them count (depth in (0.05, max_depth))."""
        s = self.cfg.depth_stride * 4
        H, W = depth.shape
        dev = self.device
        yy, xx = torch.meshgrid(torch.arange(0, H, s, device=dev),
                                torch.arange(0, W, s, device=dev), indexing="ij")
        cam = cam.to(device=dev)
        uv = torch.stack([xx, yy], dim=-1).reshape(-1, 2).to(cam.fxfycxcy.dtype)
        d = depth[::s, ::s].reshape(-1)
        ray, ok = pinhole.back_project(cam, uv)
        p_C = (ray / ray[:, 2:3] * d[:, None].to(ray.dtype)).to(torch.float32)
        good = ok & (d > 0.05) & (d < self.cfg.max_depth)
        p_C = torch.where(good[:, None], p_C, torch.zeros_like(p_C))
        return se3.se3_apply(_f32(T_WC).to(dev), p_C), good

    def integrate_depth(self, kf_fid: int, T_WK: np.ndarray, T_WC: np.ndarray,
                        cam: pinhole.Camera, depth, sigma=None, colour=None):
        """Integrate a metric depth image (H, W) taken at camera pose T_WC
        (0 / inf invalid; numpy or a tensor), with its sigma (default
        0.01 d^2); `colour` (H, W) grey or (H, W, 3) rgb in [0, 1] is
        splatted into the ray end points' voxels."""
        dev = self.device
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        sigma = (0.01 * depth * depth if sigma is None
                 else torch.as_tensor(sigma, dtype=torch.float32, device=dev))
        pts_W, good = self._decision_points(cam, T_WC, depth)
        if self.decide_new_submap(kf_fid, pts_W, good):
            self.start_submap(kf_fid, T_WK)
        a = self.active
        T_KC = self._anchor_to(a, T_WC)
        cfg = self.cfg
        a.sm = sm_mod.integrate_depth_image(a.sm, cfg.submap, cam, T_KC, depth, sigma,
                                            stride=cfg.depth_stride, max_depth=cfg.max_depth)
        a.n_frames += 1
        a.kf_ids.add(kf_fid)
        if colour is not None:
            col = torch.as_tensor(np.asarray(colour), dtype=torch.float32, device=dev)
            if col.ndim == 2:
                col = col[..., None].expand(*col.shape, 3)
            if a.col is None:
                a.col = col_mod.new_store(cfg.submap, device=dev)
            _, p_K, ok = sm_mod.depth_rays(cam, T_KC, depth, cfg.depth_stride, cfg.max_depth)
            s = cfg.depth_stride
            a.col = col_mod.splat(a.col, cfg.submap, p_K, col[::s, ::s].reshape(-1, 3), ok,
                                  sm=a.sm)

    def integrate_lidar(self, kf_fid: int, T_WK: np.ndarray, T_WS: np.ndarray, pts_S,
                        sigma: float = 0.1):
        """Integrate a (deskewed, downsampled) sweep of points pts_S (N, 3) in
        the sensor frame at pose T_WS into the active submap, starting one
        when `decide_new_submap` says so, with `sigma` as the rays' noise."""
        dev = self.device
        pts_S = torch.as_tensor(np.asarray(pts_S), dtype=torch.float32, device=dev)
        good = torch.ones(pts_S.shape[0], dtype=torch.bool, device=dev)
        pts_W = se3.se3_apply(_f32(T_WS).to(dev), pts_S)
        if self.decide_new_submap(kf_fid, pts_W, good):
            self.start_submap(kf_fid, T_WK)
        a = self.active
        T_KS = self._anchor_to(a, T_WS)
        a.sm = sm_mod.integrate_rays(a.sm, self.cfg.submap, T_KS[:3],
                                     se3.se3_apply(T_KS, pts_S), good, sigma)
        a.n_frames += 1
        a.kf_ids.add(kf_fid)

    def make_alignment_edge(self, a: SubmapEntry, b: SubmapEntry) -> Optional[dict]:
        """Map-to-map alignment: up to `align_points` of submap b's occupied
        voxels (a seeded draw when there are more) registered against
        submap a's field, summarised as a relative-pose edge between the two
        anchors (`icp_factor.make_alignment_edge`); None with fewer than 20
        occupied voxels or a strength below 1."""
        cfgs, npts = self.cfg.submap, self.cfg.align_points
        centres, occ = sm_mod.occupied_point_list(b.sm, cfgs, max_points=max(4096, npts))
        occ = occ.cpu().numpy()
        if occ.sum() < 20:
            return None
        pts_Kb = centres.cpu().numpy()[occ]
        if len(pts_Kb) > npts:
            pts_Kb = pts_Kb[np.random.default_rng(0).choice(len(pts_Kb), npts, replace=False)]
        return self._edge(a, b.anchor_fid, b.sm.T_WK, pts_Kb)

    def _edge(self, a: SubmapEntry, j: int, T_WB: torch.Tensor, pts_B: np.ndarray
              ) -> Optional[dict]:
        """The alignment edge from a's anchor to frame j (pose T_WB, float32)
        of the first `align_points` points pts_B against a's field (the JAX
        package pads them to that count: padded points add nothing)."""
        dev = self.device
        pts = torch.as_tensor(np.asarray(pts_B[:self.cfg.align_points], np.float32), device=dev)
        T_AB, sqrt_info, strength = icp_factor.make_alignment_edge(
            a.sm, self.cfg.submap, a.sm.T_WK, T_WB.to(dev), pts,
            torch.ones(len(pts), dtype=torch.bool, device=dev), self.cfg.sensor_sigma)
        strength = float(strength)
        if not np.isfinite(strength) or strength < 1.0:
            return None
        return dict(i=a.anchor_fid, j=j, T_ij=T_AB.cpu().numpy().astype(np.float64),
                    sqrt_info=sqrt_info.cpu().numpy().astype(np.float64))

    # ------------------------------------------------------------- updates
    def on_state_update(self, states: Dict[int, np.ndarray]):
        """Re-anchor the submaps whose anchor keyframe moved (loop-closure
        corrections)."""
        for e in self.maps:
            if e.anchor_fid in states:
                e.sm = e.sm._replace(T_WK=_f32(states[e.anchor_fid]).to(self.device))

    # -------------------------------------------------------------- export
    def export_occupied_ply(self, path: str, threshold: float = 1.0) -> int:
        """Write all submaps' occupied voxel centres (world frame) as an
        ASCII PLY, with per-vertex RGB (grey for submaps without colour)
        when colour was integrated; returns the vertex count."""
        all_pts, all_cols = [], []
        any_colour = any(e.col is not None for e in self.maps)
        for e in self.maps:
            centres, occ = sm_mod.occupied_point_list(e.sm, self.cfg.submap, threshold,
                                                      max_points=65536)
            pts_K = centres[occ]
            if not len(pts_K):
                continue
            all_pts.append(se3.se3_apply(e.sm.T_WK, pts_K).cpu().numpy())
            if any_colour:
                all_cols.append(
                    col_mod.colour_at(e.col, self.cfg.submap, pts_K, sm=e.sm).cpu().numpy()
                    if e.col is not None else np.full((len(pts_K), 3), 0.5, np.float32))
        pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
        cols = (np.clip(np.concatenate(all_cols) * 255, 0, 255).astype(np.uint8)
                if any_colour and all_cols else None)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n" f"element vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\n")
            if cols is not None:
                f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
            f.write("end_header\n")
            for i, p in enumerate(pts):
                if cols is not None:
                    f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                            f"{cols[i, 0]} {cols[i, 1]} {cols[i, 2]}\n")
                else:
                    f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        return len(pts)

    def export_mesh_ply(self, path: str, entry: SubmapEntry, iso: float = 0.0) -> int:
        """Write the marching-tetrahedra mesh of one submap's log-odds at
        `iso` (world frame) as an ASCII PLY mesh, with per-vertex RGB when
        colour was splatted; returns the triangle count.  Dense grids only:
        a brick grid has no dense log-odds to mesh (nor in the JAX package)."""
        from okvis2x_tpu_torch.mapping import mesh

        tris_K = mesh.submap_mesh(entry.sm, self.cfg.submap, iso)
        if len(tris_K) == 0:
            mesh.write_ply_mesh(path, tris_K)
            return 0
        verts_K = torch.as_tensor(tris_K.reshape(-1, 3), dtype=torch.float32, device=self.device)
        cols = None
        if entry.col is not None:
            cols = col_mod.colour_at(entry.col, self.cfg.submap, verts_K, sm=entry.sm).cpu().numpy()
        verts_W = se3.se3_apply(entry.sm.T_WK, verts_K).cpu().numpy()
        mesh.write_ply_mesh(path, verts_W.reshape(-1, 3, 3), colours=cols)
        return len(tris_K)

    def export_vtk_bboxes(self, path: str) -> str:
        """Write the submaps' bounding boxes as a legacy-VTK unstructured grid:
        one hexahedron (cell type 12) a submap, its corners the grid's extent
        centred on the anchor, in the world frame (float32 anchor, float64
        corners, as the JAX package composes them); returns the path."""
        D = float(self.cfg.submap.dim) * float(self.cfg.submap.res)
        h = (-D / 2, D / 2)
        local = torch.tensor([[dx, dy, dz] for dz in h for dy in h for dx in h],
                             dtype=torch.float64)
        pts = [se3.se3_apply(e.sm.T_WK.cpu().to(torch.float64), local).numpy() for e in self.maps]
        with open(path, "w") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write("okvis2x_tpu submap bounding boxes\nASCII\n")
            f.write("DATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {8 * len(pts)} float\n")
            for box in pts:
                for p in box:
                    f.write(f"{p[0]} {p[1]} {p[2]}\n")
            f.write(f"CELLS {len(pts)} {len(pts) * 9}\n")
            for i in range(len(pts)):
                o = 8 * i
                f.write("8 " + " ".join(str(o + k) for k in (0, 1, 3, 2, 4, 5, 7, 6)) + "\n")
            f.write(f"CELL_TYPES {len(pts)}\n")
            for _ in pts:
                f.write("12\n")
        return path
