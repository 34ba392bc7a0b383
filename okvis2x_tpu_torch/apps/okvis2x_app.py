"""Synchronous dataset app of the port: VIO or SLAM on EuRoC-layout (and
extended) datasets.

Counterpart of ``apps/okvis2x_app.py`` in its ``vio`` and ``slam`` modes
(the reference's okvis_apps/src/okvis_app_synchronous.cpp): reads an
okvis2.yaml-schema config and a dataset directory, runs `VioPipeline`
synchronously, writes TUM trajectories (online, and after the final BA in
``slam`` mode) and the debug CSVs when asked, and reports the ATE against
the ground truth when the dataset has one.  It runs on the first CUDA device
unless ``--device`` names another (``--device cpu``).

Usage:
  python -m okvis2x_tpu_torch.apps.okvis2x_app --dataset /path/to/MH_01 \\
      --config okvis2.yaml [--mode vio|slam] [--reader auto|euroc|xdataset|leica|rpg] \\
      [--output out/] [--max-frames N] [--imu-csv F] [--tracks-csv F] [--device D]
  python -m okvis2x_tpu_torch.apps.okvis2x_app --synthetic-test --mode slam --output out/
  python -m okvis2x_tpu_torch.apps.okvis2x_app --record DIR --dataset SRC

A dataset's GNSS fixes (``gps0/`` in the extended layout) go to the
estimator.  As in the JAX app, only the estimator fields of the config
(with the online calibration switches and sigmas) reach the pipeline
(`EstimatorConfig`); its frontend section is read but unused, and
`PipelineConfig` takes the package defaults plus the mode's loop-closure
switches.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from okvis2x_tpu_torch import default_device

# the modes of the JAX app that wait for unported parts (ROADMAP.md, A)
UNPORTED_MODES = {
    "depth": "the stereo depth network and submapping (A4, A5)",
    "rgbd": "depth input, the learned depth models and submapping (A3, A4, A5)",
    "lidar": "LiDAR submapping (A5)",
}


def pick_reader(name: str, ds_dir: str, num_cams: int):
    from okvis2x_tpu_torch.io import euroc, leica, rpg, xdataset

    if name == "auto":
        if os.path.exists(os.path.join(ds_dir, "imu_bottom.csv")):
            name = "leica"
        elif os.path.exists(os.path.join(ds_dir, "left_images.txt")):
            name = "rpg"
        elif any(os.path.exists(os.path.join(ds_dir, "mav0", s))
                 for s in ("depth0", "lidar0", "gps0")):
            name = "xdataset"
        else:
            name = "euroc"
    if name == "euroc":
        return euroc.EurocDataset(ds_dir, num_cams=num_cams)
    if name == "xdataset":
        return xdataset.XDataset(ds_dir, num_cams=num_cams)
    if name == "leica":
        return leica.LeicaDataset(ds_dir)
    if name == "rpg":
        return rpg.RpgDataset(ds_dir)
    raise ValueError(name)


def record_mode(args):
    """Dataset recorder (≙ okvis_apps/src/okvis_app_realsense_recorder.cpp):
    sensor callbacks -> DatasetWriter, EuRoC layout.  Uses the live Realsense
    when pyrealsense2 is present, else replays --dataset through the fake
    driver."""
    from okvis2x_tpu_torch.io.dataset_writer import DatasetWriter
    from okvis2x_tpu_torch.io.realsense import FakeRealsense, Realsense

    writer = DatasetWriter(args.record)
    if args.dataset:
        rs = FakeRealsense(pick_reader(args.reader, args.dataset, 2))
    else:
        rs = Realsense()
    rs.set_imu_callback(writer.add_imu)
    rs.set_images_callback(writer.add_images)
    rs.set_depth_callback(lambda t, d: writer.add_depth(t, d))
    rs.start_streaming()
    try:
        if args.dataset:
            rs.wait_done()  # the fake driver ends with its replay
            rs.stop_streaming()
        else:
            time.sleep(args.max_frames / 30.0 if args.max_frames else 10.0)
            rs.stop_streaming()
    finally:
        writer.close()
    print(f"recorded dataset at {args.record}")
    return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=False, help="dataset dir")
    ap.add_argument("--config", default=None, help="okvis2.yaml config")
    ap.add_argument("--mode", default="slam", choices=["vio", "slam", *UNPORTED_MODES])
    ap.add_argument("--reader", default="auto",
                    choices=["auto", "euroc", "xdataset", "leica", "rpg"])
    ap.add_argument("--output", default="out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--synthetic-test", action="store_true",
                    help="generate a synthetic dataset into --output/synth and run on it")
    ap.add_argument("--final-ba", action="store_true", default=True)
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="recorder mode: stream the live camera (or --dataset replay) into "
                    "an EuRoC-layout dataset at DIR, no estimation")
    ap.add_argument("--imu-csv", default=None, help="dump raw IMU to this CSV")
    ap.add_argument("--tracks-csv", default=None, help="dump cam0 keypoint tracks to this CSV")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the app on `argv` (sys.argv when None); returns the online ATE
    when the dataset has ground truth, else None."""
    args = parse_args(argv)
    if args.record:
        return record_mode(args)
    if args.mode in UNPORTED_MODES:
        raise NotImplementedError(f"--mode {args.mode} needs {UNPORTED_MODES[args.mode]}, "
                                  "not ported yet (ROADMAP.md)")
    device = default_device() if args.device is None else torch.device(args.device)

    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
    from okvis2x_tpu_torch.io import synthetic, trajectory_io
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline
    from okvis2x_tpu_torch.utils import timing

    os.makedirs(args.output, exist_ok=True)
    vi = None
    if args.synthetic_test:
        ds_dir = os.path.join(args.output, "synth")
        cam, T_SC, gt = synthetic.generate(ds_dir, duration=4.0)
        cameras = [cam, cam]
    else:
        if not args.dataset or not args.config:
            raise SystemExit("--dataset and --config are required (or use --synthetic-test)")
        from okvis2x_tpu_torch.io import config as cfg_mod

        ds_dir = args.dataset
        vi = cfg_mod.load(args.config)
        cameras = [c.camera for c in vi.cameras[:2]]
        T_SC = np.stack([c.T_SC for c in vi.cameras[:2]])
        gt = None

    ds = pick_reader(args.reader, ds_dir, len(cameras))
    if getattr(ds, "ground_truth", None) is not None:
        gt = ds.ground_truth

    if vi is not None:
        oc = vi.camera.online_calibration
        est_cfg = EstimatorConfig(
            num_keyframes=vi.estimator.num_keyframes,
            num_imu_frames=vi.estimator.num_imu_frames,
            max_iterations=vi.estimator.realtime_max_iterations,
            imu=vi.imu,
            do_extrinsics=oc.do_extrinsics,
            do_extrinsics_final_ba=oc.do_extrinsics_final_ba,
            extrinsics_sigma_r=oc.sigma_r,
            extrinsics_sigma_alpha=oc.sigma_alpha,
            extrinsics_sigma_r_final_ba=oc.sigma_r_final_ba,
            extrinsics_sigma_alpha_final_ba=oc.sigma_alpha_final_ba,
        )
    else:
        est_cfg = EstimatorConfig()
    pipe_cfg = PipelineConfig(
        do_loop_closures=(args.mode != "vio"),
        async_loop_closure=(args.mode != "vio"),
    )
    vio = VioPipeline(cameras, T_SC, est_cfg, pipe_cfg, device=device)
    if args.imu_csv:
        vio.set_imu_csv_file(args.imu_csv)
    if args.tracks_csv:
        vio.set_tracks_csv_file(0, args.tracks_csv)

    n = 0
    t0 = time.time()
    for kind, data in ds.events():
        if kind == "imu":
            vio.add_imu_measurement(*data)
            continue
        if kind == "gps":
            vio.add_gps_measurement(*data)
            continue
        if kind != "frames" or not data.paths[0]:
            continue  # depth and LiDAR streams feed only the unported modes
        images = [ds.load_image(p) for p in data.paths if p]
        with timing.Timer("1 ProcessFrame"):
            info = vio.process_frame(data.t, images)
        n += 1
        if n % 50 == 0:
            print(f"frame {n}  t={time.time() - t0:.1f}s  kf={info['is_keyframe']} "
                  f"map={info['n_map']}")
        if args.max_frames and n >= args.max_frames:
            break

    vio.finish()

    ts = np.array([s[0] for s in vio.states_log])
    Ts = np.stack([s[1] for s in vio.states_log])
    trajectory_io.write_tum(os.path.join(args.output, "trajectory.tum"), ts, Ts)
    if args.final_ba and args.mode != "vio":
        cost = vio.est.final_ba()
        print(f"final BA cost: {cost:.1f}")
        fts, fTs = vio.est.full_trajectory()
        trajectory_io.write_tum(os.path.join(args.output, "final_trajectory.tum"), fts, fTs)

    print(timing.report())
    if gt is not None:
        ate = trajectory_io.ate_rmse(ts, Ts[:, :3], gt[:, 0], gt[:, 1:4])
        print(f"ATE RMSE (online): {ate:.4f} m over {len(ts)} frames, "
              f"{vio.n_loop_closures} loop closures")
        return ate
    return None


if __name__ == "__main__":
    main()
