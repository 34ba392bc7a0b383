"""Synchronous ROS2 node of the port: replay a rosbag through the node graph.

Counterpart of ``apps/okvis2x_node_synchronous.py`` (the reference's
`okvis_node_synchronous`, okvis_ros2/src/okvis_node_synchronous.cpp):
instead of subscribing to live topics, it opens a rosbag (a ROS1 `.bag`, or a
ROS2 sqlite directory or `.db3` file, both through the port's pure-Python
readers ``io/rosbag1.py`` and ``io/rosbag2.py``), feeds every message to the
Subscriber -> PipelineNodeCore -> Publisher graph in bag order, blocking on
each frame (no frame is dropped, unlike the live node's latest-value
queues), publishes odometry / path / TF over the in-process transport, then
runs the final BA and writes TUM trajectories: ``okvis2_trajectory.csv``
(online, a row a frame) and ``okvis2_final_trajectory.csv``.

It runs on the first CUDA device unless ``--device`` names another
(``--device cpu``).

Usage:
  python -m okvis2x_tpu_torch.apps.okvis2x_node_synchronous --bag seq.bag \\
      --config okvis2.yaml [--imu-topic /imu0] \\
      [--cam-topics /cam0/image_raw /cam1/image_raw] [--gps-topic T] \\
      [--output out/] [--max-frames N] [--max-keypoints K] \\
      [--no-loop-closures] [--device D]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from okvis2x_tpu_torch import default_device


def open_bag(path: str):
    """Returns (reader, codec module) for ROS1 .bag files or ROS2 sqlite bags."""
    from okvis2x_tpu_torch.io import rosbag1, rosbag2

    if os.path.isdir(path) or path.endswith(".db3"):
        return rosbag2.Rosbag2Reader(path), rosbag2
    return rosbag1.Rosbag1Reader(path), rosbag1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bag", required=True)
    ap.add_argument("--config", required=True, help="okvis2.yaml config")
    ap.add_argument("--imu-topic", default="/imu0")
    ap.add_argument("--cam-topics", nargs="+",
                    default=["/cam0/image_raw", "/cam1/image_raw"])
    ap.add_argument("--gps-topic", default=None)
    ap.add_argument("--output", default="out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--max-keypoints", type=int, default=0,
                    help="override the keypoint budget (small CI runs)")
    ap.add_argument("--no-loop-closures", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    """Replay the bag of `argv` (sys.argv when None); returns 0."""
    args = parse_args(argv)
    device = default_device() if args.device is None else torch.device(args.device)

    from okvis2x_tpu_torch.apps.okvis2x_node import build_node_graph
    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
    from okvis2x_tpu_torch.io import config as cfg_mod
    from okvis2x_tpu_torch.io import trajectory_io
    from okvis2x_tpu_torch.io.xdataset import geodetic_to_enu
    from okvis2x_tpu_torch.pipeline.queues import FrameSynchronizer
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig
    from okvis2x_tpu_torch.ros2.transport import LocalTransport

    vi = cfg_mod.load(args.config)
    n_cams = min(len(vi.cameras), len(args.cam_topics))
    cameras = [c.camera for c in vi.cameras[:n_cams]]
    T_SC = np.stack([c.T_SC for c in vi.cameras[:n_cams]])
    oc = vi.camera.online_calibration
    est_cfg = EstimatorConfig(
        num_keyframes=vi.estimator.num_keyframes,
        num_imu_frames=vi.estimator.num_imu_frames,
        max_iterations=vi.estimator.realtime_max_iterations,
        imu=vi.imu,
        do_extrinsics=oc.do_extrinsics,
        do_extrinsics_final_ba=oc.do_extrinsics_final_ba,
    )
    pipe_kw = {}
    if args.max_keypoints:
        pipe_kw = dict(max_keypoints=args.max_keypoints, octaves=1)
    pipe_cfg = PipelineConfig(
        do_loop_closures=not args.no_loop_closures,
        async_loop_closure=not args.no_loop_closures,
        **pipe_kw,
    )

    transport = LocalTransport()
    core, pub, sub = build_node_graph(
        transport, cameras, T_SC, est_cfg=est_cfg, pipe_cfg=pipe_cfg,
        num_cams=n_cams, device=device,
    )

    reader, codec = open_bag(args.bag)
    cam_idx = {t: i for i, t in enumerate(args.cam_topics[:n_cams])}
    topics = list(cam_idx) + [args.imu_topic] + (
        [args.gps_topic] if args.gps_topic else []
    )
    sync = FrameSynchronizer(n_cams)
    n_frames = 0
    # the messages go to the node graph's subscriber target, as live ones
    # do once decoded: the IMU to the publisher's propagation and the
    # pipeline, each complete bundle to the pipeline, blocking
    gps_origin = None
    for msg in reader.messages(topics=topics):
        if msg.topic == args.imu_topic:
            m = codec.decode_imu(msg.raw)
            sub.target.on_imu(
                m.t_ns * 1e-9, np.asarray(m.gyr), np.asarray(m.acc)
            )
            continue
        if args.gps_topic and msg.topic == args.gps_topic:
            m = codec.decode_navsatfix(msg.raw)
            # geodetic -> local ENU about the first fix (exact ECEF
            # differencing on WGS-84)
            lla = np.array([m.latitude, m.longitude, m.altitude])
            if gps_origin is None:
                gps_origin = lla
            p_G = geodetic_to_enu(
                np.deg2rad(lla[0]), np.deg2rad(lla[1]), lla[2],
                np.deg2rad(gps_origin[0]), np.deg2rad(gps_origin[1]),
                gps_origin[2],
            )
            sigma = float(np.sqrt(max(m.position_covariance[0], 1e-4)))
            sub.target.on_gps(m.t_ns * 1e-9, p_G, sigma)
            continue
        m = codec.decode_image(msg.raw)
        img = np.asarray(m.data)
        if img.ndim == 3:  # colour -> grey (the pipeline takes mono)
            img = img.mean(axis=2).astype(img.dtype)
        for bundle in sync.add(cam_idx[msg.topic], m.t_ns * 1e-9, img):
            images = [bundle["images"].get(c) for c in range(n_cams)]
            if any(im is None for im in images):
                continue
            sub.target.on_images(bundle["t"], images)
            n_frames += 1
            if n_frames % 100 == 0:
                print(f"frame {n_frames}", file=sys.stderr, flush=True)
        if args.max_frames and n_frames >= args.max_frames:
            break

    vio = core.pipe
    vio.finish()
    os.makedirs(args.output, exist_ok=True)
    ts = np.array([s[0] for s in vio.states_log])
    Ts = np.stack([s[1] for s in vio.states_log]) if vio.states_log else \
        np.zeros((0, 7))
    trajectory_io.write_tum(
        os.path.join(args.output, "okvis2_trajectory.csv"), ts, Ts
    )
    vio.est.final_ba()
    fts, fTs = vio.est.full_trajectory()
    trajectory_io.write_tum(
        os.path.join(args.output, "okvis2_final_trajectory.csv"), fts, fTs
    )
    print(
        f"processed {n_frames} frames on {vio.device}, "
        f"{vio.n_loop_closures} loop closures; trajectories in "
        f"{args.output}/", file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
