"""Sensor-stream re-publisher (≙ okvis::ros2::RePublisher,
okvis_ros2/src/RePublisher.cpp): forwards raw camera / IMU / depth streams
under a namespace, plus the network-processor depth + sigma outputs — used
by the network nodes so downstream consumers (mapping, visualisation)
receive the same streams the estimator consumed.  Counterpart of
``okvis2x_tpu/ros2/republisher.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from okvis2x_tpu_torch.ros2 import messages as m
from okvis2x_tpu_torch.ros2.transport import Transport


class RePublisher:
    def __init__(self, transport: Transport, prefix: str = "okvis",
                 num_cams: int = 2):
        self.transport = transport
        self.prefix = prefix
        self._cam_pubs = [
            transport.advertise(f"{prefix}/cam{i}/image")
            for i in range(num_cams)
        ]
        self._imu_pub = transport.advertise(f"{prefix}/imu")
        self._depth_pub = transport.advertise(f"{prefix}/depth")
        self._sigma_pub = transport.advertise(f"{prefix}/depth_sigma")

    def republish_images(self, t: float, images):
        for i, img in enumerate(images):
            if img is None or i >= len(self._cam_pubs):
                continue
            enc = "mono8" if np.asarray(img).ndim == 2 else "rgb8"
            self._cam_pubs[i].publish(
                m.Image(header=m.Header(t, f"cam{i}"), data=np.asarray(img),
                        encoding=enc)
            )

    def republish_imu(self, t: float, gyr, acc):
        self._imu_pub.publish(
            m.Imu(header=m.Header(t, "imu"), gyr=np.asarray(gyr),
                  acc=np.asarray(acc))
        )

    def republish_network_depth(self, t: float, depth: np.ndarray,
                                sigma: Optional[np.ndarray] = None):
        """≙ Publisher::setupNetworkTopics "<topic>Depth"/"<topic>Sigma"
        (Publisher.cpp:431-437)."""
        self._depth_pub.publish(
            m.Image(header=m.Header(t, "cam0"), data=np.asarray(depth),
                    encoding="32FC1")
        )
        if sigma is not None:
            self._sigma_pub.publish(
                m.Image(header=m.Header(t, "cam0"), data=np.asarray(sigma),
                        encoding="32FC1")
            )
