"""The port's Realsense raw-stream publisher node.

Counterpart of ``apps/okvis_node_realsense_publisher.py`` (the reference's
`okvis_node_realsense_publisher`, okvis_ros2/src/
okvis_node_realsense_publisher.cpp): opens the Realsense driver (or the
deterministic fake replaying a dataset) and publishes the raw IMU, camera
and depth streams through `RePublisher`; no estimation, just sensor
bridging for recording or remote processing.

    python -m okvis2x_tpu_torch.apps.okvis_node_realsense_publisher \\
        [--fake-dataset DIR] [--prefix realsense]

With rclpy it publishes on ROS2 topics and spins; without it the streams go
over the in-process `LocalTransport` until the fake dataset ends, and the
node prints how many messages it published.  Host work only: no device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def run_publisher(transport, driver, prefix="realsense", num_cams=2):
    """Wire a Realsense-like driver's callbacks onto RePublisher topics.
    Returns the RePublisher (topics: <prefix>/cam{i}/image, <prefix>/imu,
    <prefix>/depth)."""
    from okvis2x_tpu_torch.ros2 import RePublisher

    repub = RePublisher(transport, prefix=prefix, num_cams=num_cams)
    driver.set_imu_callback(lambda t, g, a: repub.republish_imu(t, g, a))
    driver.set_images_callback(lambda t, imgs: repub.republish_images(t, imgs))
    driver.set_depth_callback(lambda t, d: repub.republish_network_depth(t, np.asarray(d)))
    return repub


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fake-dataset", default=None,
                    help="replay a EuRoC-layout dataset as a fake device")
    ap.add_argument("--prefix", default="realsense")
    args = ap.parse_args(argv)

    from okvis2x_tpu_torch.io.realsense import FakeRealsense, Realsense

    if args.fake_dataset:
        from okvis2x_tpu_torch.io.euroc import EurocDataset

        driver = FakeRealsense(EurocDataset(args.fake_dataset))
    else:
        driver = Realsense()

    try:
        import rclpy
        from rclpy.node import Node

        from okvis2x_tpu_torch.ros2.transport import RclpyTransport

        rclpy.init()
        node = Node("okvis_node_realsense_publisher")
        transport = RclpyTransport(node)
        run_publisher(transport, driver, prefix=args.prefix)
        driver.start_streaming()
        rclpy.spin(node)
    except ImportError:
        from okvis2x_tpu_torch.ros2 import LocalTransport

        transport = LocalTransport()
        run_publisher(transport, driver, prefix=args.prefix)
        driver.start_streaming()
        if hasattr(driver, "wait_done"):
            driver.wait_done()
        driver.stop_streaming()
        total = sum(transport.count(t) for t in transport.history)
        print(f"published {total} messages on "
              f"{len(transport.history)} topics (local transport)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
