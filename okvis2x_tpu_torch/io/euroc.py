"""EuRoC ASL dataset reader.

Counterpart of ``okvis2x_tpu/io/euroc.py`` (the reference's `DatasetReader`,
okvis_multisensor_processing/src/DatasetReader.cpp): reads the EuRoC MAV
layout

    mav0/cam{i}/data.csv + data/<t>.png
    mav0/imu0/data.csv            (t[ns], gx, gy, gz, ax, ay, az)
    mav0/state_groundtruth_estimate0/data.csv   (optional, for ATE eval)

and yields timestamp-ordered sensor events from a plain synchronous
iterator.  Timestamps are float seconds relative to the first IMU sample.

As in the JAX package, the IMU file is read by `np.loadtxt` into float64,
so its nanosecond stamps (about 1.4e18, where float64 steps by 256 ns) are
off by up to 128 ns, while frame stamps are parsed as integers and stay
exact: an IMU sample written at a frame's stamp may come after that frame
in `events()`.  The port keeps this for parity (C-R9 in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from okvis2x_tpu_torch.io import png


@dataclasses.dataclass
class ImuData:
    t: np.ndarray  # (N,) seconds
    gyr: np.ndarray  # (N, 3)
    acc: np.ndarray  # (N, 3)


@dataclasses.dataclass
class FrameEvent:
    t: float
    paths: List[str]  # per-camera image path ("" if missing)


class EurocDataset:
    def __init__(self, path: str, num_cams: int = 2):
        self.path = path
        mav = os.path.join(path, "mav0")
        if os.path.isdir(mav):
            self.root = mav
        else:
            self.root = path

        imu_csv = np.loadtxt(
            os.path.join(self.root, "imu0", "data.csv"), delimiter=",", skiprows=1
        )
        self.t0_ns = int(imu_csv[0, 0])
        self.imu = ImuData(
            t=(imu_csv[:, 0] - self.t0_ns) * 1e-9,
            gyr=imu_csv[:, 1:4],
            acc=imu_csv[:, 4:7],
        )

        # camera image listings, synchronised by timestamp
        cam_lists = []
        for c in range(num_cams):
            csv = os.path.join(self.root, f"cam{c}", "data.csv")
            rows = []
            with open(csv) as f:
                next(f)
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) >= 2 and parts[0]:
                        rows.append((int(parts[0]), parts[1]))
            cam_lists.append(dict(rows))
        # intersect on timestamps present in cam0 (tolerate missing in others)
        self.frames: List[FrameEvent] = []
        for t_ns in sorted(cam_lists[0].keys()):
            paths = []
            for c in range(num_cams):
                fn = cam_lists[c].get(t_ns, "")
                paths.append(
                    os.path.join(self.root, f"cam{c}", "data", fn) if fn else ""
                )
            self.frames.append(FrameEvent(t=(t_ns - self.t0_ns) * 1e-9, paths=paths))

        gt_csv = os.path.join(
            self.root, "state_groundtruth_estimate0", "data.csv"
        )
        self.ground_truth: Optional[np.ndarray] = None
        if os.path.exists(gt_csv):
            gt = np.loadtxt(gt_csv, delimiter=",", skiprows=1)
            # columns: t[ns], p(3), q_wxyz(4), v(3), bg(3), ba(3)
            t = (gt[:, 0] - self.t0_ns) * 1e-9
            p = gt[:, 1:4]
            q_wxyz = gt[:, 4:8]
            q_xyzw = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
            self.ground_truth = np.concatenate([t[:, None], p, q_xyzw], axis=1)

    def load_image(self, path: str) -> np.ndarray:
        """Load a grayscale image as float32 in [0, 1]."""
        return png.decode_image(path).astype(np.float32) / 255.0

    def events(self) -> Iterator[Tuple[str, object]]:
        """Yield ('imu', (t, gyr, acc)) and ('frames', FrameEvent) in
        timestamp order (imu first at equal stamps)."""
        i = 0
        n_imu = len(self.imu.t)
        for fr in self.frames:
            while i < n_imu and self.imu.t[i] <= fr.t + 1e-9:
                yield "imu", (self.imu.t[i], self.imu.gyr[i], self.imu.acc[i])
                i += 1
            yield "frames", fr
        while i < n_imu:
            yield "imu", (self.imu.t[i], self.imu.gyr[i], self.imu.acc[i])
            i += 1
