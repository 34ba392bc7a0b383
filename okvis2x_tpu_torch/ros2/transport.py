"""Pluggable pub/sub transport for the ROS2 layer.

Counterpart of ``okvis2x_tpu/ros2/transport.py``: the `Transport` base (a
topic registry with local dispatch to subscribers) and two backends:

* `LocalTransport` — the in-process loopback with per-topic history that
  makes the whole publisher/subscriber stack deterministic and runnable
  without a ROS installation (the reference cannot run any of okvis_ros2
  without a full ROS2 stack);
* `RclpyTransport` — converts the numpy message types (``ros2/messages.py``)
  to real ROS2 messages and publishes them through an rclpy node; the ROS
  message modules are imported only inside the conversion, so the module
  imports without ROS.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

import numpy as np

from okvis2x_tpu_torch.ros2 import messages as m


class TopicPublisher:
    def __init__(self, transport: "Transport", topic: str):
        self._transport = transport
        self.topic = topic

    def publish(self, msg):
        self._transport._dispatch(self.topic, msg)


class Transport:
    """Base: topic registry + local dispatch to subscribers."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self._lock = threading.Lock()

    def advertise(self, topic: str, msg_type=None) -> TopicPublisher:
        return TopicPublisher(self, topic)

    def subscribe(self, topic: str, callback: Callable, msg_type=None):
        with self._lock:
            self._subs.setdefault(topic, []).append(callback)

    def _dispatch(self, topic: str, msg):
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for cb in subs:
            cb(msg)


class LocalTransport(Transport):
    """In-process transport recording full per-topic history."""

    def __init__(self, keep_history: bool = True):
        super().__init__()
        self.keep_history = keep_history
        self.history: Dict[str, List[Any]] = {}

    def _dispatch(self, topic: str, msg):
        if self.keep_history:
            with self._lock:
                self.history.setdefault(topic, []).append(msg)
        super()._dispatch(topic, msg)

    # test helpers ---------------------------------------------------------
    def last(self, topic: str):
        h = self.history.get(topic)
        return h[-1] if h else None

    def count(self, topic: str) -> int:
        return len(self.history.get(topic, ()))


class RclpyTransport(Transport):
    """rclpy-backed transport: numpy messages -> real ROS2 messages.

    Constructed by the live nodes once rclpy imports; the conversions cover
    the message families the reference publishes (Publisher.hpp:207-226)."""

    def __init__(self, node):
        super().__init__()
        self.node = node
        self._ros_pubs: Dict[str, Any] = {}

    # -- conversions --------------------------------------------------------
    @staticmethod
    def _stamp(builtin_time, t: float):
        builtin_time.sec = int(t)
        builtin_time.nanosec = int((t - int(t)) * 1e9)
        return builtin_time

    @staticmethod
    def _pose(pose, T):
        pose.position.x, pose.position.y, pose.position.z = map(float, T[:3])
        (pose.orientation.x, pose.orientation.y, pose.orientation.z,
         pose.orientation.w) = map(float, T[3:7])

    def _header(self, out, header):
        out.header.frame_id = header.frame_id
        self._stamp(out.header.stamp, header.stamp)

    def _to_ros(self, msg):
        """(ROS2 message, its type) of a numpy message."""
        import builtin_interfaces.msg  # noqa: F401
        from geometry_msgs.msg import PoseStamped, TransformStamped
        from nav_msgs.msg import Odometry, Path
        from sensor_msgs.msg import Image, Imu, PointCloud2, PointField

        if isinstance(msg, m.Odometry):
            out = Odometry()
            self._header(out, msg.header)
            out.child_frame_id = msg.child_frame_id
            self._pose(out.pose.pose, msg.T_WB)
            tw = out.twist.twist
            tw.linear.x, tw.linear.y, tw.linear.z = map(float, msg.v_W)
            tw.angular.x, tw.angular.y, tw.angular.z = map(float, msg.omega_B)
            return out, Odometry
        if isinstance(msg, m.TransformStamped):
            out = TransformStamped()
            self._header(out, msg.header)
            out.child_frame_id = msg.child_frame_id
            tr = out.transform
            tr.translation.x, tr.translation.y, tr.translation.z = map(float, msg.T[:3])
            (tr.rotation.x, tr.rotation.y, tr.rotation.z,
             tr.rotation.w) = map(float, msg.T[3:7])
            return out, TransformStamped
        if isinstance(msg, m.Path):
            out = Path()
            self._header(out, msg.header)
            for t, T in zip(msg.stamps, msg.poses):
                ps = PoseStamped()
                ps.header.frame_id = msg.header.frame_id
                self._stamp(ps.header.stamp, float(t))
                self._pose(ps.pose, T)
                out.poses.append(ps)
            return out, Path
        if isinstance(msg, m.PointCloud):
            out = PointCloud2()
            self._header(out, msg.header)
            pts = np.asarray(msg.points, np.float32)
            out.height, out.width = 1, len(pts)
            out.fields = [PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32, count=1)
                          for i, n in enumerate("xyz")]
            out.point_step, out.row_step = 12, 12 * len(pts)
            out.is_dense = True
            out.data = pts.tobytes()
            return out, PointCloud2
        if isinstance(msg, m.Image):
            out = Image()
            self._header(out, msg.header)
            data = np.ascontiguousarray(msg.data)
            out.height, out.width = data.shape[:2]
            out.encoding = msg.encoding
            out.step = data.strides[0]
            out.data = data.tobytes()
            return out, Image
        if isinstance(msg, m.Imu):
            out = Imu()
            self._header(out, msg.header)
            (out.angular_velocity.x, out.angular_velocity.y,
             out.angular_velocity.z) = map(float, msg.gyr)
            (out.linear_acceleration.x, out.linear_acceleration.y,
             out.linear_acceleration.z) = map(float, msg.acc)
            return out, Imu
        if isinstance(msg, (m.MeshMarker, m.MarkerArray)):
            return self._marker_to_ros(msg)
        raise TypeError(f"no ROS2 conversion for {type(msg)}")

    def _marker_to_ros(self, msg):
        from geometry_msgs.msg import Point
        from std_msgs.msg import ColorRGBA
        from visualization_msgs.msg import Marker, MarkerArray

        if isinstance(msg, m.MarkerArray):
            arr = MarkerArray()
            for mk in msg.markers:
                arr.markers.append(self._marker_to_ros(mk)[0])
            return arr, MarkerArray
        out = Marker()
        self._header(out, msg.header)
        out.ns, out.id = msg.ns, msg.marker_id
        out.type = Marker.TRIANGLE_LIST
        out.action = Marker.ADD if msg.action == "add" else Marker.DELETE
        self._pose(out.pose, msg.T)
        out.scale.x = out.scale.y = out.scale.z = 1.0
        out.color = ColorRGBA(r=0.7, g=0.7, b=0.7, a=1.0)
        v = np.asarray(msg.vertices)
        for tri in np.asarray(msg.triangles):
            for k in tri:
                out.points.append(Point(x=float(v[k, 0]), y=float(v[k, 1]), z=float(v[k, 2])))
                if msg.colors is not None:
                    c = msg.colors[k] / 255.0
                    out.colors.append(ColorRGBA(r=float(c[0]), g=float(c[1]), b=float(c[2]),
                                                a=1.0))
        return out, Marker

    def _dispatch(self, topic: str, msg):
        ros_msg, ros_type = self._to_ros(msg)
        pub = self._ros_pubs.get(topic)
        if pub is None:
            pub = self.node.create_publisher(ros_type, topic, 10)
            self._ros_pubs[topic] = pub
        pub.publish(ros_msg)
        super()._dispatch(topic, msg)
