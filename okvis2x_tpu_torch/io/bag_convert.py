"""ROS1-bag -> MRL/EuRoC-extended folder conversion (dataset tooling).

Counterpart of ``okvis2x_tpu/io/bag_convert.py``, the pure-Python
replacement for the reference's conversion scripts (tools/hilti_bag2mrl.py,
tools/vbr_bag2mrl.py): converts Hilti'22 / VBR rosbags into the folder
layout the dataset readers consume — cam*/data.csv + cam*/data/<t>.png,
imu0/data.csv, lidar0/data.csv with columns [#timestamp [ns], x, y, z,
Intensity, ring] — without any ROS installation (see ``io/rosbag1.py``).
The PNGs go through the port's own codec (``io/png.py``), not Pillow.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from okvis2x_tpu_torch.io import png, rosbag1


@dataclasses.dataclass(frozen=True)
class BagPreset:
    """Topic layout of one dataset family."""

    cameras: Dict[str, str]  # topic -> camN
    imu_topic: str
    lidar_topic: Optional[str] = None
    gps_topic: Optional[str] = None
    # per-point time field: 'timestamp' = absolute f64 seconds (Hesai),
    # 't' = u32 nanoseconds relative to the message header stamp (Ouster)
    lidar_time_field: str = "timestamp"
    drop_zero_points: bool = False


HILTI = BagPreset(
    cameras={f"/alphasense/cam{i}/image_raw": f"cam{i}" for i in range(5)},
    imu_topic="/alphasense/imu",
    lidar_topic="/hesai/pandar",
    lidar_time_field="timestamp",
)

VBR = BagPreset(
    cameras={
        "/camera_left/image_raw": "cam0",
        "/camera_right/image_raw": "cam1",
    },
    imu_topic="/imu/data",
    lidar_topic="/ouster/points",
    lidar_time_field="t",
    drop_zero_points=True,
)


def convert_bag(bag_path: str, out_dir: str, preset: BagPreset) -> dict:
    """Convert one bag; returns per-stream message counts."""
    os.makedirs(out_dir, exist_ok=True)
    for cam in preset.cameras.values():
        os.makedirs(os.path.join(out_dir, cam, "data"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "imu0"), exist_ok=True)
    if preset.lidar_topic:
        os.makedirs(os.path.join(out_dir, "lidar0"), exist_ok=True)
    if preset.gps_topic:
        os.makedirs(os.path.join(out_dir, "gps0"), exist_ok=True)

    cam_csv = {}
    for topic, cam in preset.cameras.items():
        f = open(os.path.join(out_dir, cam, "data.csv"), "w", newline="")
        w = csv.writer(f)
        w.writerow(["#timestamp [ns]", "filename"])
        cam_csv[topic] = (f, w)

    imu_f = open(os.path.join(out_dir, "imu0", "data.csv"), "w", newline="")
    imu_w = csv.writer(imu_f)
    imu_w.writerow(
        ["#timestamp [ns]",
         "w_RS_S_x [rad s^-1]", "w_RS_S_y [rad s^-1]", "w_RS_S_z [rad s^-1]",
         "a_RS_S_x [m s^-2]", "a_RS_S_y [m s^-2]", "a_RS_S_z [m s^-2]"]
    )

    lidar_f = lidar_w = None
    if preset.lidar_topic:
        lidar_f = open(
            os.path.join(out_dir, "lidar0", "data.csv"), "w", newline=""
        )
        lidar_w = csv.writer(lidar_f)
        lidar_w.writerow(["#timestamp [ns]", "x", "y", "z", "Intensity", "ring"])

    gps_f = gps_w = None
    if preset.gps_topic:
        gps_f = open(os.path.join(out_dir, "gps0", "data.csv"), "w", newline="")
        gps_w = csv.writer(gps_f)
        gps_w.writerow(
            ["#timestamp [ns]", "latitude", "longitude", "altitude",
             "hErr", "vErr"]
        )

    topics = (
        list(preset.cameras)
        + [preset.imu_topic]
        + ([preset.lidar_topic] if preset.lidar_topic else [])
        + ([preset.gps_topic] if preset.gps_topic else [])
    )
    counts = {"images": 0, "imu": 0, "lidar_points": 0, "gps": 0}

    reader = rosbag1.Rosbag1Reader(bag_path)
    for msg in reader.messages(topics=topics):
        if msg.topic in preset.cameras:
            img = rosbag1.decode_image(msg.raw)
            ts = img.t_ns
            cam = preset.cameras[msg.topic]
            name = f"{ts}.png"
            png.write(os.path.join(out_dir, cam, "data", name), rosbag1.to_mono8(img))
            cam_csv[msg.topic][1].writerow([str(ts), name])
            counts["images"] += 1
        elif msg.topic == preset.imu_topic:
            imu = rosbag1.decode_imu(msg.raw)
            imu_w.writerow(
                [str(imu.t_ns)]
                + [repr(float(v)) for v in imu.gyr]
                + [repr(float(v)) for v in imu.acc]
            )
            counts["imu"] += 1
        elif msg.topic == preset.lidar_topic:
            pc = rosbag1.decode_pointcloud2(msg.raw)
            arrays = pc.arrays()
            x = np.asarray(arrays["x"], np.float64)
            y = np.asarray(arrays["y"], np.float64)
            z = np.asarray(arrays["z"], np.float64)
            inten = np.asarray(
                arrays.get("intensity", np.zeros_like(x)), np.float64
            )
            ring = np.asarray(
                arrays.get("ring", np.zeros(len(x), np.int64)), np.int64
            )
            tf = preset.lidar_time_field
            if tf in arrays and tf == "timestamp":
                ts = (np.asarray(arrays[tf], np.float64) * 1e9).astype(np.int64)
            elif tf in arrays:
                ts = pc.t_ns + np.asarray(arrays[tf], np.int64)
            else:
                ts = np.full(len(x), pc.t_ns, np.int64)
            order = np.argsort(ts, kind="stable")
            keep = np.ones(len(x), bool)
            if preset.drop_zero_points:
                keep = (x != 0) | (y != 0) | (z != 0)
            for i in order:
                if not keep[i]:
                    continue
                lidar_w.writerow(
                    [str(int(ts[i])), repr(float(x[i])), repr(float(y[i])),
                     repr(float(z[i])), repr(float(inten[i])), int(ring[i])]
                )
                counts["lidar_points"] += 1
        elif msg.topic == preset.gps_topic:
            fix = rosbag1.decode_navsatfix(msg.raw)
            cov = fix.position_covariance
            gps_w.writerow(
                [str(fix.t_ns), repr(float(fix.latitude)),
                 repr(float(fix.longitude)), repr(float(fix.altitude)),
                 repr(float(np.sqrt(max(cov[0], 0.0)))),
                 repr(float(np.sqrt(max(cov[8], 0.0))))]
            )
            counts["gps"] += 1

    for f, _ in cam_csv.values():
        f.close()
    imu_f.close()
    if lidar_f:
        lidar_f.close()
    if gps_f:
        gps_f.close()
    return counts
