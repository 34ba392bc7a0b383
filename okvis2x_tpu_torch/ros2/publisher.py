"""Estimator-output publisher (≙ okvis::ros2::Publisher,
okvis_ros2/src/Publisher.cpp:197-440 / Publisher.hpp:70-251).

Counterpart of ``okvis2x_tpu/ros2/publisher.py``; host numpy throughout.

Consumes the optimised-graph callback and publishes:

* odometry + TF (`<prefix>/odometry`, `<prefix>/transform`),
* the keyframe path (`<prefix>/path`),
* matched landmarks as a point cloud (`<prefix>/points_matched`),
* per-submap meshes as triangle-list markers (`<prefix>/submap_meshes`,
  ≙ publishSubmapsAsCallback + submapMeshLookup_ with re-publish on
  change + z-cutoff),
* submap-alignment point clouds (`<prefix>/points_alignment`),
* debug images (`<prefix>/image/<name>`),
* rate-limited realtime IMU propagation between estimator updates
  (≙ publishRealTimePropagation + odometryPublishingRate_),
* optional trajectory CSV (EuRoC or RPG format, ≙ setCsvFile).

Everything is published on the caller's thread.  The reference's
ThreadedPublisher decoupling (Publisher.hpp:202-204) belongs to the live
rclpy node, which has no counterpart here yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np

from okvis2x_tpu_torch.api import State, Trajectory
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.ros2 import messages as m
from okvis2x_tpu_torch.ros2.transport import Transport


class Publisher:
    def __init__(
        self,
        transport: Transport,
        prefix: str = "okvis",
        odometry_rate: Optional[float] = None,
        world_frame: str = "world",
        body_frame: str = "body",
        mesh_z_cutoff: Optional[float] = None,
    ):
        self.transport = transport
        self.prefix = prefix
        self.world_frame = world_frame
        self.body_frame = body_frame
        self.odometry_rate = odometry_rate
        self.mesh_z_cutoff = mesh_z_cutoff
        self._pub = {
            name: transport.advertise(f"{prefix}/{name}")
            for name in (
                "odometry", "transform", "path", "points_matched",
                "points_alignment", "submap_meshes", "propagated_odometry",
            )
        }
        self._img_pubs: Dict[str, object] = {}
        self._path_t: list = []
        self._path_T: list = []
        self._trajectory = Trajectory()
        self._last_prop_t = -np.inf
        self._mesh_lookup: Dict[int, m.MeshMarker] = {}
        self._csv_file = None
        self._csv_rpg = False
        self._lock = threading.Lock()

    # -- config (≙ setCsvFile / setMeshesZCutoff) ----------------------------
    def set_csv_file(self, path: str, rpg: bool = False):
        self._csv_file = open(path, "w")
        self._csv_rpg = rpg
        if not rpg:
            self._csv_file.write(
                "# timestamp, p_WS_W_x, p_WS_W_y, p_WS_W_z, "
                "q_WS_x, q_WS_y, q_WS_z, q_WS_w\n"
            )

    # -- main estimator callback (≙ publishEstimatorUpdate) ------------------
    def process_state_update(
        self,
        state: State,
        tracking_state=None,
        updated_states: Optional[Iterable[State]] = None,
        landmarks: Optional[np.ndarray] = None,
    ):
        self._trajectory.update(state)
        odom = m.Odometry(
            header=m.Header(state.timestamp, self.world_frame),
            child_frame_id=self.body_frame,
            T_WB=np.asarray(state.T_WS, np.float64),
            v_W=np.asarray(state.v_W, np.float64),
            omega_B=np.asarray(state.omega_S, np.float64),
        )
        self._publish_odometry(odom)

        with self._lock:
            self._path_t.append(state.timestamp)
            self._path_T.append(np.asarray(state.T_WS, np.float64))
            # rewrite history with updated (loop-closed) states
            if updated_states:
                by_t = {s.timestamp: s for s in updated_states}
                for i, t in enumerate(self._path_t):
                    if t in by_t:
                        self._path_T[i] = np.asarray(
                            by_t[t].T_WS, np.float64
                        )
            path = m.Path(
                header=m.Header(state.timestamp, self.world_frame),
                stamps=np.asarray(self._path_t),
                poses=np.stack(self._path_T),
            )
        self._pub["path"].publish(path)

        if landmarks is not None and len(landmarks):
            pts = np.asarray(landmarks, np.float64)
            if pts.shape[1] == 4:  # homogeneous
                w = np.where(np.abs(pts[:, 3]) > 1e-12, pts[:, 3], 1.0)
                pts = pts[:, :3] / w[:, None]
            self._pub["points_matched"].publish(
                m.PointCloud(
                    header=m.Header(state.timestamp, self.world_frame),
                    points=pts,
                )
            )
        if self._csv_file is not None:
            T = state.T_WS
            if self._csv_rpg:
                self._csv_file.write(
                    f"{state.timestamp} {T[0]} {T[1]} {T[2]} "
                    f"{T[3]} {T[4]} {T[5]} {T[6]}\n"
                )
            else:
                self._csv_file.write(
                    f"{int(state.timestamp * 1e9)}, {T[0]}, {T[1]}, {T[2]}, "
                    f"{T[3]}, {T[4]}, {T[5]}, {T[6]}\n"
                )
            self._csv_file.flush()

    def _publish_odometry(self, odom: m.Odometry):
        self._pub["odometry"].publish(odom)
        self._pub["transform"].publish(
            m.TransformStamped(
                header=odom.header,
                child_frame_id=odom.child_frame_id,
                T=odom.T_WB,
            )
        )

    # -- realtime propagation (≙ publishRealTimePropagation) ----------------
    def add_imu_measurement(self, t: float, gyr, acc):
        """High-rate odometry between estimator updates, rate-limited to
        `odometry_rate` (≙ odometryPublishingRate_)."""
        self._trajectory.add_imu_measurement(t, gyr, acc)
        if self.odometry_rate is None or self.odometry_rate <= 0:
            return
        if t - self._last_prop_t < 1.0 / self.odometry_rate:
            return
        s = self._trajectory.get_state(t)
        if s is None:
            return
        self._last_prop_t = t
        self._pub["propagated_odometry"].publish(
            m.Odometry(
                header=m.Header(t, self.world_frame),
                child_frame_id=self.body_frame,
                T_WB=s.T_WS,
                v_W=s.v_W,
                omega_B=s.omega_S,
            )
        )

    # -- submap meshes (≙ publishSubmapsAsCallback + republishMeshes) -------
    def publish_submaps(self, submap_poses: Dict[int, np.ndarray],
                        meshes: Dict[int, tuple], t: float = 0.0):
        """submap_poses: id -> (7,) anchor pose; meshes: id ->
        (vertices (V,3), triangles (F,3)[, colors (V,3) uint8])."""
        markers = []
        for sid, T in submap_poses.items():
            mesh = meshes.get(sid)
            if mesh is None:
                continue
            verts, tris = np.asarray(mesh[0]), np.asarray(mesh[1])
            colors = (
                np.asarray(mesh[2]) if len(mesh) > 2 and mesh[2] is not None
                else None
            )
            if self.mesh_z_cutoff is not None and len(verts):
                keep_v = verts[:, 2] <= self.mesh_z_cutoff
                keep_f = keep_v[tris].all(axis=1)
                tris = tris[keep_f]
            mk = m.MeshMarker(
                header=m.Header(t, self.world_frame),
                ns="submaps", marker_id=int(sid),
                T=np.asarray(T, np.float64),
                vertices=verts, triangles=tris, colors=colors,
            )
            self._mesh_lookup[int(sid)] = mk
            markers.append(mk)
        self._pub["submap_meshes"].publish(m.MarkerArray(markers))

    def republish_meshes(self):
        """Re-send every cached submap mesh (≙ republishMeshes, used when
        the publishing mode or anchor poses changed)."""
        self._pub["submap_meshes"].publish(
            m.MarkerArray(list(self._mesh_lookup.values()))
        )

    # -- alignment points (≙ publishAlignmentPointsAsCallback) --------------
    def publish_alignment_points(self, t: float, T_WS: np.ndarray,
                                 points_S: np.ndarray):
        pts_W = se3np.se3_apply(np.asarray(T_WS, np.float64), np.asarray(points_S, np.float64))
        self._pub["points_alignment"].publish(
            m.PointCloud(header=m.Header(t, self.world_frame), points=pts_W)
        )

    # -- debug images (≙ publishImages) --------------------------------------
    def publish_images(self, images: Dict[str, np.ndarray], t: float = 0.0):
        for name, img in images.items():
            pub = self._img_pubs.get(name)
            if pub is None:
                pub = self.transport.advertise(f"{self.prefix}/image/{name}")
                self._img_pubs[name] = pub
            enc = "mono8" if img.ndim == 2 else "rgb8"
            pub.publish(
                m.Image(header=m.Header(t, "camera"), data=img, encoding=enc)
            )

    def close(self):
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None
