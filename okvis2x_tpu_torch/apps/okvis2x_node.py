"""The node graph of the port's ROS2 node, without the middleware.

Counterpart of ``apps/okvis2x_node.py`` (the reference's `okvis2x_node`,
okvis_ros2/src/okvis2x_node.cpp) up to its rclpy `main`: `PipelineNodeCore`
feeds sensor callbacks into `VioPipeline` and hands states and landmarks
out; `build_node_graph` wires Subscriber -> PipelineNodeCore -> Publisher
over any transport (Publisher.cpp:197-440, Subscriber.cpp:89-106).  The
synchronous node (``okvis2x_node_synchronous.py``) and the tests drive this
graph over the in-process `LocalTransport`.  The live rclpy node is not
ported yet.

The pipeline runs on the first CUDA device unless `device` names another.
"""

from __future__ import annotations

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
