"""The port's ROS2 network node: stereo depth in the loop.

Counterpart of ``apps/okvis2x_network_node.py`` (the reference's
`okvis2x_network_node`, okvis_ros2/src/okvis2x_network_node.cpp, compiled as
the stereo / depth-fusion variants of
okvis_apps/src/okvis2x_app_network_synchronous.cpp): subscribes the stereo
image and IMU topics, computes the left image's depth from the pair
(``models/stereo.py``'s `stereo_depth`: census stereo at the node's disparity
range), feeds the RGB-D pipeline with it as cam0's depth image, and
re-publishes depth and sigma on ``<prefix>/network/depth`` and
``<prefix>/network/depth_sigma`` (≙ Publisher::setupNetworkTopics,
Publisher.cpp:431-437) through `RePublisher`.

Like the node of ``okvis2x_node.py``, the graph is middleware-independent
(`build_network_graph` over any Transport); `main` adds the rclpy bridge:

    python -m okvis2x_tpu_torch.apps.okvis2x_network_node --ros-args \\
        -p config:=okvis2.yaml [-p device:=cpu]

Without rclpy `main` prints where the graph is and returns 1.  The depth and
the pipeline run on the first CUDA device unless `device` names another.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def build_network_graph(transport, cameras, T_SC, est_cfg=None, pipe_cfg=None,
                        prefix="okvis", in_prefix="", num_cams=2, max_disp=32,
                        use_net=False, device=None):
    """Subscriber -> stereo depth -> RGB-D pipeline -> Publisher and
    RePublisher.  Returns (core, publisher, re-publisher, subscriber).

    `use_net` is accepted and not read, as in the JAX package (ROADMAP.md
    C-R18): `stereo_depth` picks its engine itself, which at the default
    range of 32 disparities is census stereo."""
    from okvis2x_tpu_torch import default_device
    from okvis2x_tpu_torch.api import State
    from okvis2x_tpu_torch.apps.okvis2x_node import PipelineNodeCore
    from okvis2x_tpu_torch.models import stereo as stereo_mod
    from okvis2x_tpu_torch.ros2 import Publisher, RePublisher, Subscriber

    device = default_device() if device is None else torch.device(device)
    pub = Publisher(transport, prefix=prefix)
    repub = RePublisher(transport, prefix=prefix + "/network", num_cams=num_cams)

    cam0 = cameras[0]
    fx = float(np.asarray(cam0.fxfycxcy)[0])
    baseline = float(np.linalg.norm(T_SC[1][:3] - T_SC[0][:3])) or 0.1

    def depth_fn(left, right):
        as_t = lambda img: torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)
        return stereo_mod.stereo_depth(as_t(left), as_t(right), fx, baseline,
                                       max_disp=max_disp)

    def on_state(t, T_WS, sb, info):
        # the keyframe flag of process_frame's report, paired with this
        # frame's state as the reference does (ROADMAP.md C-R4)
        pub.process_state_update(
            State(id=info["fid"], timestamp=t, T_WS=T_WS, v_W=sb[:3],
                  b_g=sb[3:6], b_a=sb[6:9], omega_S=np.zeros(3),
                  is_keyframe=info["is_keyframe"]),
        )

    core = PipelineNodeCore(cameras, T_SC, est_cfg=est_cfg, pipe_cfg=pipe_cfg,
                            on_state=on_state, device=device)

    class _Target:
        def on_images(self, t, images, depth_images=None):
            if depth_images is None and len(images) >= 2:
                sd = depth_fn(images[0], images[1])
                depth = sd.depth.cpu().numpy()
                sigma = sd.sigma.cpu().numpy()
                repub.republish_network_depth(t, depth, sigma)
                # depth prior for cam0 only (the network's reference view)
                depth_images = [depth] + [None] * (len(images) - 1)
            core.on_images(t, images, depth_images=depth_images)

        def on_imu(self, t, gyr, acc):
            pub.add_imu_measurement(t, gyr, acc)
            core.on_imu(t, gyr, acc)

    sub = Subscriber(transport, _Target(), num_cams=num_cams, prefix=in_prefix)
    return core, pub, repub, sub


def main():
    """The live network node: rclpy's parameters `config` and `device`
    ("cuda:0"); spins until rclpy stops, then finishes the pipeline.
    Returns 1 without rclpy."""
    try:
        import rclpy
        from rclpy.node import Node
    except ImportError:
        print("rclpy not available; use build_network_graph over a "
              "LocalTransport.", file=sys.stderr)
        return 1

    from okvis2x_tpu_torch.apps.okvis2x_node import bridge_ros_inputs, load_rig
    from okvis2x_tpu_torch.ros2.transport import RclpyTransport

    class NetworkNode(Node):
        def __init__(self):
            super().__init__("okvis2x_network_node")
            self.declare_parameter("config", "")
            self.declare_parameter("device", "cuda:0")
            cameras, T_SC = load_rig(self.get_parameter("config").value)
            self.transport = RclpyTransport(self)
            self.graph = build_network_graph(
                self.transport, cameras, T_SC, num_cams=len(cameras),
                device=torch.device(self.get_parameter("device").value))
            bridge_ros_inputs(self, self.transport, len(cameras))

    rclpy.init()
    node = NetworkNode()
    rclpy.spin(node)
    node.graph[0].pipe.finish()  # the recognition worker stops with the node
    return 0


if __name__ == "__main__":
    sys.exit(main())
