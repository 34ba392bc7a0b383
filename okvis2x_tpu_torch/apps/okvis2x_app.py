"""Synchronous dataset app of the port: VIO, SLAM, RGB-D, depth-network and
LiDAR mapping on EuRoC-layout (and extended) datasets.

Counterpart of ``apps/okvis2x_app.py`` (the reference's
okvis_app_synchronous.cpp, okvis2x_app_synchronous.cpp and
okvis2x_app_network_synchronous.cpp): reads
an okvis2.yaml-schema config and a dataset directory, runs `VioPipeline`
synchronously, writes TUM trajectories (online, and after the final BA
except in ``vio`` mode) and the debug CSVs when asked, and reports the ATE
against the ground truth when the dataset has one.  It runs on the first
CUDA device unless ``--device`` names another (``--device cpu``).

``rgbd``: the dataset's ``depth0/`` stream feeds per-keypoint depth priors;
on every keyframe the learned stereo depth and the learned multi-view depth
against the last two of the four keyframes kept are fused by inverse
variance and integrated into occupancy submaps.  ``depth``: the stereo
depth alone is integrated, with cam0's image as colour when the config's
``camera_type`` of cam0 is ``rgb``.  Both write the occupied voxels to
``map.ply``; ``--se2-config`` sets the grid: dense up to 256^3, brick-sparse
beyond (the reference's 25.6 m at 0.025 m is 1024^3).
``lidar``: the dataset's ``lidar0/`` sweeps are deskewed, filtered, held
against the active submap as a live constraint and integrated into
keyframe-anchored submaps whose map-to-map alignment edges join the window
(`LidarVioPipeline`); the submaps go to ``map.ply`` as well.

Usage:
  python -m okvis2x_tpu_torch.apps.okvis2x_app --dataset /path/to/MH_01 \\
      --config okvis2.yaml [--mode vio|slam|rgbd|depth|lidar] [--se2-config se2.yaml] \\
      [--reader auto|euroc|xdataset|leica|rpg] [--output out/] [--max-frames N] \\
      [--imu-csv F] [--tracks-csv F] [--device D]
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

MODES = ["vio", "slam", "depth", "rgbd", "lidar"]
MAPPING_MODES = ("depth", "rgbd", "lidar")
KF_HISTORY = 4  # keyframes kept for the multi-view depth, the last two its sources


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
    ap.add_argument("--se2-config", default=None,
                    help="se2.yaml submap config (its grid resolution is honoured: "
                    "dense up to 256^3, brick-sparse beyond)")
    ap.add_argument("--mode", default="slam", choices=MODES)
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


def submapping_config(args):
    from okvis2x_tpu_torch.pipeline.submapping import SubmappingConfig

    if args.se2_config:
        from okvis2x_tpu_torch.io.config import load_submap_config

        return SubmappingConfig.from_se2(load_submap_config(args.se2_config))
    return SubmappingConfig()


def fused_depth(left, right, fx: float, baseline: float, srcs, K, T_rs):
    """A keyframe's fused depth and sigma: the learned stereo depth of
    (left, right) and the learned multi-view depth of `left` against the
    sources `srcs` (their poses in the left camera T_rs, float32), fused by
    inverse variance."""
    from okvis2x_tpu_torch.models import mvs, stereo

    sd = stereo.stereo_depth(left, right, fx, baseline)
    md = mvs.mvs_depth(left, srcs, K, T_rs)
    return stereo.fuse_depths(torch.where(sd.valid, sd.depth, 0.0), sd.sigma,
                              torch.where(md.valid, md.depth, 0.0), md.sigma)


class DepthMapper:
    """The keyframe stage of the ``rgbd`` and ``depth`` modes: dense depth
    of cam0 from the learned nets, integrated into the occupancy submaps."""

    def __init__(self, mode: str, sub_cfg, cameras, T_SC, vio, device, cam0_is_colour: bool):
        from okvis2x_tpu_torch.pipeline.submapping import SubmappingInterface

        self.mode = mode
        self.submapper = SubmappingInterface(sub_cfg, device=device)
        self.cam = cameras[0]
        self.T_SC = T_SC
        self.vio = vio
        self.device = device
        self.colour = cam0_is_colour
        fx, fy, cx, cy = (float(v) for v in cameras[0].fxfycxcy)
        self.fx = fx
        self.baseline = float(np.linalg.norm(T_SC[1][:3] - T_SC[0][:3]))
        self.K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=torch.float32,
                              device=device)
        self.hist = []  # (cam0 image on the device, T_WC) of the last keyframes

    def keyframe(self, info: dict, images):
        from okvis2x_tpu_torch.core import se3np
        from okvis2x_tpu_torch.models import stereo
        from okvis2x_tpu_torch.utils import timing

        left, right = (torch.as_tensor(np.asarray(im, np.float32), device=self.device)
                       for im in images[:2])
        T_WC = se3np.se3_multiply(info["T_WS"], self.T_SC[0])
        # the keyframe's id; frame 0 counts as missing, as in the JAX app
        kf_fid = info.get("keyframe_fid") or info["fid"]
        try:
            T_WK = self.vio.est.get_state(kf_fid).T_WS
        except KeyError:
            T_WK = info["T_WS"]
        if self.mode == "rgbd":
            with timing.Timer("9 DepthFusionAndIntegrate"):
                if len(self.hist) >= 2:
                    srcs = torch.stack([h[0] for h in self.hist[-2:]])
                    # the pose of each source in the reference camera frame
                    T_rs = np.stack([se3np.se3_multiply(se3np.se3_inverse(T_WC), h[1])
                                     for h in self.hist[-2:]])
                    T_rs = torch.as_tensor(T_rs, dtype=torch.float32, device=self.device)
                    d, s = fused_depth(left, right, self.fx, self.baseline, srcs, self.K, T_rs)
                    self.submapper.integrate_depth(kf_fid, T_WK, T_WC, self.cam, d, s)
                self.hist.append((left, T_WC))
                del self.hist[:-KF_HISTORY]
        else:
            with timing.Timer("9 DepthAndIntegrate"):
                sd = stereo.stereo_depth(left, right, self.fx, self.baseline)
                col = None
                if self.colour:
                    col = np.asarray(images[0], np.float32)
                    if col.max() > 1.5:
                        col = col / 255.0
                self.submapper.integrate_depth(kf_fid, T_WK, T_WC, self.cam, sd.depth,
                                               sd.sigma, colour=col)


def main(argv=None):
    """Run the app on `argv` (sys.argv when None); returns the online ATE
    when the dataset has ground truth, else None."""
    args = parse_args(argv)
    if args.record:
        return record_mode(args)
    device = default_device() if args.device is None else torch.device(args.device)
    # the grid before anything is written: a malformed se2.yaml fails here
    sub_cfg = submapping_config(args) if args.mode in MAPPING_MODES else None

    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
    from okvis2x_tpu_torch.io import synthetic, trajectory_io
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline
    from okvis2x_tpu_torch.utils import timing

    os.makedirs(args.output, exist_ok=True)
    vi = None
    cam0_is_colour = False
    if args.synthetic_test:
        ds_dir = os.path.join(args.output, "synth")
        cam, T_SC, gt = synthetic.generate(ds_dir, duration=4.0,
                                           with_depth=(args.mode == "rgbd"),
                                           with_lidar=(args.mode == "lidar"))
        cameras = [cam, cam]
        if args.reader == "auto" and args.mode in ("rgbd", "lidar"):
            args.reader = "xdataset"
    else:
        if not args.dataset or not args.config:
            raise SystemExit("--dataset and --config are required (or use --synthetic-test)")
        from okvis2x_tpu_torch.io import config as cfg_mod

        ds_dir = args.dataset
        vi = cfg_mod.load(args.config)
        cameras = [c.camera for c in vi.cameras[:2]]
        T_SC = np.stack([c.T_SC for c in vi.cameras[:2]])
        cam0_is_colour = vi.cameras[0].is_colour
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

    mapper = submapper = None
    pipe = vio
    if args.mode in ("depth", "rgbd"):
        mapper = DepthMapper(args.mode, sub_cfg, cameras, T_SC, vio, device, cam0_is_colour)
        submapper = mapper.submapper
    elif args.mode == "lidar":
        from okvis2x_tpu_torch.pipeline.lidar_vio import LidarVioPipeline

        pipe = LidarVioPipeline(vio, sub_cfg)
        submapper = pipe.submapper
    depth_by_t = dict(getattr(ds, "depth_frames", [])) if args.mode == "rgbd" else {}

    n = 0
    t0 = time.time()
    for kind, data in ds.events():
        if kind == "imu":
            vio.add_imu_measurement(*data)
            continue
        if kind == "gps":
            vio.add_gps_measurement(*data)
            continue
        if kind == "lidar":
            if args.mode == "lidar":
                with timing.Timer("8 LidarSweep"):
                    pipe.process_lidar_sweep(data)
            continue
        if kind != "frames" or not data.paths[0]:
            continue  # the depth stream is read at its frame
        images = [ds.load_image(p) for p in data.paths if p]
        with timing.Timer("1 ProcessFrame"):
            if args.mode == "rgbd":
                dpath = depth_by_t.get(data.t)
                dimgs = [ds.load_depth(dpath) if dpath else None] + [None] * (len(images) - 1)
                info = vio.process_frame(data.t, images, depth_images=dimgs)
            else:
                info = pipe.process_frame(data.t, images)
        n += 1
        if mapper is not None and info["is_keyframe"] and len(images) >= 2:
            mapper.keyframe(info, images)
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
    if submapper is not None:
        submapper.export_occupied_ply(os.path.join(args.output, "map.ply"))

    print(timing.report())
    if gt is not None:
        ate = trajectory_io.ate_rmse(ts, Ts[:, :3], gt[:, 0], gt[:, 1:4])
        print(f"ATE RMSE (online): {ate:.4f} m over {len(ts)} frames, "
              f"{vio.n_loop_closures} loop closures")
        return ate
    return None


if __name__ == "__main__":
    main()
