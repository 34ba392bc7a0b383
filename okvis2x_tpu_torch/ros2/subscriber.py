"""Sensor-topic subscriber (≙ okvis::ros2::Subscriber,
okvis_ros2/src/Subscriber.cpp:89-106): subscribes IMU / per-camera image /
depth / LiDAR / GNSS topics on a transport, synchronises multi-camera
frames, and forwards to any estimator-like target exposing the
ViInterface-style add-measurement surface (`on_imu`, `on_images`,
`on_depth`, `on_lidar`, `on_gps` — PipelineNodeCore in
``okvis2x_tpu_torch/apps/okvis2x_node.py``).  Counterpart of
``okvis2x_tpu/ros2/subscriber.py``."""

from __future__ import annotations

from typing import Optional

from okvis2x_tpu_torch.pipeline.queues import FrameSynchronizer
from okvis2x_tpu_torch.ros2 import messages as m
from okvis2x_tpu_torch.ros2.transport import Transport


class Subscriber:
    def __init__(
        self,
        transport: Transport,
        target,
        num_cams: int = 2,
        prefix: str = "",
        image_topics=None,
        imu_topic: Optional[str] = None,
        depth_topic: Optional[str] = None,
        lidar_topic: Optional[str] = None,
        gps_topic: Optional[str] = None,
        sync_tolerance: float = 0.005,
    ):
        self.target = target
        self.num_cams = num_cams
        self._sync = FrameSynchronizer(num_cams, tolerance=sync_tolerance)
        self._pending_depth = {}

        p = (prefix + "/") if prefix else ""
        image_topics = image_topics or [
            f"{p}cam{i}/image" for i in range(num_cams)
        ]
        for i, topic in enumerate(image_topics):
            transport.subscribe(topic, self._make_image_cb(i))
        transport.subscribe(imu_topic or f"{p}imu", self._imu_cb)
        if depth_topic is not None:
            transport.subscribe(depth_topic, self._depth_cb)
        if lidar_topic is not None:
            transport.subscribe(lidar_topic, self._lidar_cb)
        if gps_topic is not None:
            transport.subscribe(gps_topic, self._gps_cb)

    def _make_image_cb(self, cam: int):
        def cb(msg: m.Image):
            for bundle in self._sync.add(cam, msg.header.stamp, msg.data):
                imgs = [
                    bundle["images"].get(i) for i in range(self.num_cams)
                ]
                if any(im is None for im in imgs):
                    continue  # incomplete flushed bundle
                depth = self._pending_depth.pop(round(bundle["t"], 6), None)
                self.target.on_images(bundle["t"], imgs, depth_images=depth)

        return cb

    def _imu_cb(self, msg: m.Imu):
        self.target.on_imu(msg.header.stamp, msg.gyr, msg.acc)

    def _depth_cb(self, msg: m.Image):
        if hasattr(self.target, "on_depth"):
            self.target.on_depth(msg.header.stamp, msg.data)
        else:
            self._pending_depth[round(msg.header.stamp, 6)] = [msg.data]

    def _lidar_cb(self, msg: m.PointCloud):
        if hasattr(self.target, "on_lidar"):
            self.target.on_lidar(msg.header.stamp, msg.points,
                                 msg.intensities)

    def _gps_cb(self, msg: m.NavSat):
        if hasattr(self.target, "on_gps"):
            self.target.on_gps(msg.header.stamp, msg.position, msg.sigma)
