"""Tightly-coupled LiDAR-visual-inertial pipeline (torch counterpart of
``okvis2x_tpu/pipeline/lidar_vio.py``; the reference's LiDAR path in
ThreadedSlam and SubmappingInterface).

Per sweep:
  1. deskew: each ray propagated through the raw IMU samples from the
     estimator state at or before the sweep start, into the frame of the
     state at or after its end; the geodesic interpolation between the two
     states when the IMU buffer does not cover the sweep;
  2. range gate (0.5 to 60 m), voxel filter and a seeded subsample;
  3. a live frame-to-map constraint against the active submap, before the
     sweep is integrated: per-point rows in the window solve when the
     estimator has `cap_icp` > 0, else one relative-pose edge (flagged
     "live", replacing the previous one);
  4. a new keyframe is requested when less than half of the sweep lands in
     observed voxels of the active submap;
  5. ray integration into the active submap; closing submaps hand their
     map-to-map alignment edges to the estimator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from okvis2x_tpu_torch.core import se3, se3np
from okvis2x_tpu_torch.mapping import lidar
from okvis2x_tpu_torch.pipeline.submapping import (SubmappingConfig, SubmappingInterface,
                                                    _f32)
from okvis2x_tpu_torch.pipeline.vio import VioPipeline


class LidarVioPipeline:
    """A `VioPipeline` and LiDAR submapping on the pipeline's device, one
    synchronous object."""

    def __init__(self, vio: VioPipeline, submapping_cfg: SubmappingConfig = SubmappingConfig(),
                 T_SL: Optional[np.ndarray] = None, voxel: float = 0.3,
                 max_points_per_sweep: int = 2048):
        self.vio = vio
        self.est = vio.est
        self.device = vio.device
        self.submapper = SubmappingInterface(submapping_cfg, align_callback=self._on_align_edge,
                                             device=vio.device)
        self.T_SL = np.array([0, 0, 0, 0, 0, 0, 1.0]) if T_SL is None else np.asarray(T_SL)
        self.voxel = voxel
        self.max_points = max_points_per_sweep
        self.request_keyframe = False

    def _on_align_edge(self, edge: dict):
        """A map-to-map alignment edge from the submapper into the estimator."""
        self.est.rel_edges.append(edge)

    def add_imu_measurement(self, t, gyr, acc):
        self.vio.add_imu_measurement(t, gyr, acc)

    def process_frame(self, t, images):
        """The visual-inertial frame; a keyframe when a sweep asked for one;
        then the submaps re-anchored on the window's poses."""
        info = self.vio.process_frame(t, images)
        if self.request_keyframe and not info["is_keyframe"]:
            self.est.set_keyframe(info["fid"], True)
            info["is_keyframe"] = True
            self.vio.last_kf_fid = info["fid"]
            self.request_keyframe = False
        self.submapper.on_state_update({f.fid: f.T_WS for f in self.est.frames})
        return info

    def _bracketing_states(self, t0: float, t1: float):
        frames = self.est.frames
        before = [f for f in frames if f.timestamp <= t0] or [frames[0]]
        after = [f for f in frames if f.timestamp >= t1] or [frames[-1]]
        return before[-1], after[0]

    def _deskew(self, sweep, fa, fb, pts_S: np.ndarray) -> np.ndarray:
        """The sweep's points in the frame of fb's time: IMU propagation
        when the raw buffer covers [fa, sweep end], else the two-state
        interpolation (float32, on the device)."""
        est = self.est
        t0, t1 = float(sweep.t_point[0]), float(sweep.t_point[-1])
        t_tgt = float(fb.timestamp)
        i0, i1 = est._imu_span(fa.timestamp, max(t1, t_tgt))
        if (i1 - i0 >= 2 and est.imu_t[i0] <= fa.timestamp + 1e-6
                and est.imu_t[i1 - 1] >= t1 - 1e-3):
            return lidar.deskew_imu(est.cfg.imu, est.imu_t[i0:i1], est.imu_gyr[i0:i1],
                                    est.imu_acc[i0:i1], fa, sweep.t_point, pts_S,
                                    t_end=t_tgt)[0]
        dev = self.device
        frac = np.clip((sweep.t_point - t0) / max(t1 - t0, 1e-6), 0, 1)
        return lidar.deskew(_f32(fa.T_WS).to(dev), _f32(fb.T_WS).to(dev),
                            torch.as_tensor(frac, dtype=torch.float32, device=dev),
                            torch.as_tensor(pts_S, dtype=torch.float32, device=dev)
                            ).cpu().numpy()

    def process_lidar_sweep(self, sweep) -> dict:
        """Consume an `io.xdataset.LidarSweep`: returns whether it was
        integrated, its points after filtering and whether a live
        constraint was made."""
        est = self.est
        if not est.frames:
            return dict(integrated=False)
        fa, fb = self._bracketing_states(float(sweep.t_point[0]), float(sweep.t_point[-1]))
        R_SL = se3np.quat_to_matrix(self.T_SL[3:7])
        pts_S = self._deskew(sweep, fa, fb, np.asarray(sweep.pts) @ R_SL.T + self.T_SL[:3])

        rng = np.linalg.norm(pts_S, axis=-1)
        pts_S = lidar.voxel_downsample(pts_S[(rng > 0.5) & (rng < 60.0)], self.voxel)
        if len(pts_S) > self.max_points:
            pts_S = pts_S[np.random.default_rng(0).choice(len(pts_S), self.max_points,
                                                          replace=False)]
        if len(pts_S) < 10:
            return dict(integrated=False)

        host_kf = self.vio.last_kf_fid
        if host_kf is None:
            host_kf = est.frames[-1].fid
        try:
            T_WK = est.get_state(host_kf).T_WS
        except KeyError:
            host_kf = est.frames[-1].fid
            T_WK = est.get_state(host_kf).T_WS

        # the live constraint against the pre-sweep field: a drifted sweep
        # cannot pull its own correction target along
        made_edge = False
        a = self.submapper.active
        sub_cfg = self.submapper.cfg
        if a is not None and a.n_frames >= 2 and a.anchor_fid != fb.fid \
                and any(f.fid == a.anchor_fid for f in est.frames):
            if est.cfg.cap_icp > 0:
                est.set_icp_map(a.sm, sub_cfg.submap)
                est.set_live_icp_points(a.anchor_fid, fb.fid, pts_S, sub_cfg.sensor_sigma)
                made_edge = True
            else:
                edge = self.submapper._edge(a, fb.fid, _f32(fb.T_WS), pts_S)
                if edge is not None:
                    edge["live"] = True
                    est.rel_edges = [e for e in est.rel_edges if not e.get("live")]
                    est.rel_edges.append(edge)
                    made_edge = True

        if a is not None and a.n_frames >= 2:
            dev = self.device
            p = torch.as_tensor(pts_S, dtype=torch.float32, device=dev)
            if self.submapper._overlap_fraction(
                    a, se3.se3_apply(_f32(fb.T_WS).to(dev), p),
                    torch.ones(len(pts_S), dtype=torch.bool, device=dev)) < 0.5:
                self.request_keyframe = True

        self.submapper.integrate_lidar(host_kf, T_WK, fb.T_WS, pts_S, 0.1)
        return dict(integrated=True, n_points=len(pts_S), live_edge=made_edge)
