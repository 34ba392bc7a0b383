"""The port's ROS2 node (subscriber mode).

Counterpart of ``apps/okvis2x_node.py`` (the reference's `okvis2x_node`,
okvis_ros2/src/okvis2x_node.cpp): `PipelineNodeCore` feeds sensor callbacks
into `VioPipeline` and hands states and landmarks out; `build_node_graph`
wires Subscriber -> PipelineNodeCore -> Publisher over any transport
(Publisher.cpp:197-440, Subscriber.cpp:89-106).  The synchronous node
(``okvis2x_node_synchronous.py``) and the tests drive this graph over the
in-process `LocalTransport`; `main` is the live node, which bridges real
ROS2 topics (``imu0``, ``cam<i>/image_raw``) onto the graph over an
`RclpyTransport`.

rclpy is optional: without it `main` prints where the graph is and returns
1.  With it:

    python -m okvis2x_tpu_torch.apps.okvis2x_node --ros-args \
        -p config:=okvis2.yaml [-p odometry_rate:=50.0] [-p device:=cpu]

The pipeline runs on the first CUDA device unless `device` names another.
"""

from __future__ import annotations

import sys

import numpy as np


class PipelineNodeCore:
    """Middleware-independent node core: feed sensor callbacks in, get
    state/landmark callbacks out (≙ okvis::ViInterface wiring in
    okvis2x_node.cpp)."""

    def __init__(self, cameras, T_SC, est_cfg=None, pipe_cfg=None,
                 on_state=None, on_landmarks=None, device=None):
        from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
        from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline

        self.pipe = VioPipeline(
            cameras, T_SC, est_cfg or EstimatorConfig(),
            pipe_cfg or PipelineConfig(), device=device,
        )
        self.on_state = on_state
        self.on_landmarks = on_landmarks

    # -- sensor inputs (≙ Subscriber callbacks) -----------------------------
    def on_imu(self, t, gyr, acc):
        self.pipe.add_imu_measurement(t, gyr, acc)

    def on_gps(self, t, pos, err):
        self.pipe.add_gps_measurement(t, pos, err)

    def on_images(self, t, images, depth_images=None):
        info = self.pipe.process_frame(t, images, depth_images=depth_images)
        if self.on_state is not None:
            f = self.pipe.est.get_state(info["fid"])
            self.on_state(t, f.T_WS, f.sb, info)
        if self.on_landmarks is not None:
            self.on_landmarks(self.pipe.est.hp_W.copy())
        return info


def build_node_graph(transport, cameras, T_SC, est_cfg=None, pipe_cfg=None,
                     prefix="okvis", in_prefix="", odometry_rate=None,
                     num_cams=2, device=None):
    """Wire Subscriber -> PipelineNodeCore -> Publisher over any transport.

    Returns (core, publisher, subscriber): the whole node minus the
    middleware."""
    from okvis2x_tpu_torch.api import State
    from okvis2x_tpu_torch.ros2 import Publisher, Subscriber

    pub = Publisher(transport, prefix=prefix, odometry_rate=odometry_rate)

    def on_state(t, T_WS, sb, info):
        # the state is the frame's, its keyframe flag the one process_frame
        # reports, which in the deferred mode belongs to an earlier frame:
        # the reference pairs them so (ROADMAP.md C-R4), kept for parity
        pub.process_state_update(
            State(
                id=info["fid"], timestamp=t, T_WS=T_WS, v_W=sb[:3],
                b_g=sb[3:6], b_a=sb[6:9], omega_S=np.zeros(3),
                is_keyframe=info["is_keyframe"],
            ),
        )

    core = PipelineNodeCore(
        cameras, T_SC, est_cfg=est_cfg, pipe_cfg=pipe_cfg,
        on_state=on_state,
        on_landmarks=lambda hp: None,
        device=device,
    )

    class _Target:
        def on_images(self, t, images, depth_images=None):
            core.on_images(t, images, depth_images=depth_images)

        def on_imu(self, t, gyr, acc):
            pub.add_imu_measurement(t, gyr, acc)
            core.on_imu(t, gyr, acc)

        def on_gps(self, t, pos, sigma):
            core.on_gps(t, pos, sigma)

    sub = Subscriber(transport, _Target(), num_cams=num_cams,
                     prefix=in_prefix, gps_topic=f"{in_prefix}/gps"
                     if in_prefix else "gps")
    return core, pub, sub


def bridge_ros_inputs(node, transport, num_cams: int):
    """Subscribe `node` to the live ROS2 sensor topics (``imu0``,
    ``cam<i>/image_raw`` mono8) and dispatch each message, as a numpy
    message, onto `transport`'s ``imu`` and ``cam<i>/image`` topics."""
    from sensor_msgs.msg import Image as RosImage, Imu as RosImu

    from okvis2x_tpu_torch.ros2 import messages as m

    def stamp(msg):
        return msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9

    def imu_cb(msg):
        transport._dispatch("imu", m.Imu(
            m.Header(stamp(msg), "imu"),
            np.array([msg.angular_velocity.x, msg.angular_velocity.y, msg.angular_velocity.z]),
            np.array([msg.linear_acceleration.x, msg.linear_acceleration.y,
                      msg.linear_acceleration.z])))

    def image_cb(cam):
        def cb(msg):
            img = np.frombuffer(msg.data, np.uint8).reshape(
                msg.height, msg.width).astype(np.float32) / 255.0
            transport._dispatch(f"cam{cam}/image",
                                m.Image(m.Header(stamp(msg), f"cam{cam}"), img))

        return cb

    node.create_subscription(RosImu, "imu0", imu_cb, 100)
    for i in range(num_cams):
        node.create_subscription(RosImage, f"cam{i}/image_raw", image_cb(i), 10)


def load_rig(cfg_path: str):
    """(cameras, T_SC) of the first two cameras of an okvis2.yaml."""
    from okvis2x_tpu_torch.io import config as cfg_mod

    vi = cfg_mod.load(cfg_path)
    return ([c.camera for c in vi.cameras[:2]],
            np.stack([c.T_SC for c in vi.cameras[:2]]))


def main():
    """The live node: rclpy's parameters `config`, `odometry_rate` and
    `device` ("cuda:0"); spins until rclpy stops, then finishes the
    pipeline.  Returns 1 without rclpy."""
    try:
        import rclpy
        from rclpy.node import Node
    except ImportError:
        print(
            "rclpy not available in this environment. The transport-"
            "independent graph (build_node_graph over LocalTransport) is "
            "importable from this module; wire it to your middleware of "
            "choice.",
            file=sys.stderr,
        )
        return 1

    import torch

    from okvis2x_tpu_torch.ros2.transport import RclpyTransport

    class Okvis2xNode(Node):
        def __init__(self):
            super().__init__("okvis2x_node")
            self.declare_parameter("config", "")
            self.declare_parameter("odometry_rate", 0.0)
            self.declare_parameter("device", "cuda:0")
            cameras, T_SC = load_rig(self.get_parameter("config").value)
            self.transport = RclpyTransport(self)
            rate = self.get_parameter("odometry_rate").value or None
            self.core, self.pub, self.sub = build_node_graph(
                self.transport, cameras, T_SC, odometry_rate=rate,
                num_cams=len(cameras),
                device=torch.device(self.get_parameter("device").value),
            )
            bridge_ros_inputs(self, self.transport, len(cameras))

    rclpy.init()
    node = Okvis2xNode()
    rclpy.spin(node)
    node.core.pipe.finish()  # the recognition worker stops with the node
    return 0


if __name__ == "__main__":
    sys.exit(main())
