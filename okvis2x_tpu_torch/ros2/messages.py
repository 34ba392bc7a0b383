"""Middleware-independent message types for the ROS2 layer.

Counterpart of ``okvis2x_tpu/ros2/messages.py``: plain-numpy analogues of the message families the reference publishes
(okvis_ros2/include/okvis/ros2/Publisher.hpp:207-226: nav_msgs Odometry &
Path, geometry_msgs TransformStamped, sensor_msgs PointCloud2 & Image,
visualization_msgs Marker/MarkerArray).  The in-process transport passes
them through, so every publisher and subscriber path runs without a ROS
installation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Header:
    stamp: float  # seconds
    frame_id: str = "world"


@dataclasses.dataclass
class Odometry:
    """≙ nav_msgs/Odometry (pose + twist in child frame)."""

    header: Header
    child_frame_id: str
    T_WB: np.ndarray  # (7,) [t, q]
    v_W: np.ndarray  # (3,)
    omega_B: np.ndarray  # (3,)


@dataclasses.dataclass
class TransformStamped:
    header: Header
    child_frame_id: str
    T: np.ndarray  # (7,)


@dataclasses.dataclass
class Path:
    """≙ nav_msgs/Path: timestamped poses."""

    header: Header
    stamps: np.ndarray  # (N,)
    poses: np.ndarray  # (N, 7)


@dataclasses.dataclass
class PointCloud:
    """≙ sensor_msgs/PointCloud2 (xyz [+ intensity / rgb])."""

    header: Header
    points: np.ndarray  # (N, 3)
    intensities: Optional[np.ndarray] = None  # (N,)
    colors: Optional[np.ndarray] = None  # (N, 3) uint8


@dataclasses.dataclass
class Image:
    header: Header
    data: np.ndarray  # (H, W) or (H, W, 3)
    encoding: str = "mono8"


@dataclasses.dataclass
class Imu:
    header: Header
    gyr: np.ndarray  # (3,)
    acc: np.ndarray  # (3,)


@dataclasses.dataclass
class NavSat:
    """≙ sensor_msgs/NavSatFix reduced to local-cartesian position + std."""

    header: Header
    position: np.ndarray  # (3,) local cartesian (ENU) or geodetic-converted
    sigma: float = 1.0


@dataclasses.dataclass
class MeshMarker:
    """≙ visualization_msgs/Marker TRIANGLE_LIST for one submap mesh."""

    header: Header
    ns: str
    marker_id: int
    T: np.ndarray  # (7,) anchor pose
    vertices: np.ndarray  # (V, 3)
    triangles: np.ndarray  # (F, 3) int
    colors: Optional[np.ndarray] = None  # (V, 3) uint8
    action: str = "add"  # add | delete


@dataclasses.dataclass
class MarkerArray:
    markers: List[MeshMarker] = dataclasses.field(default_factory=list)
