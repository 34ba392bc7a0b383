"""Record sensor streams to EuRoC-layout datasets.

Counterpart of ``okvis2x_tpu/io/dataset_writer.py`` (the reference's
`DatasetWriter`, okvis_multisensor_processing/src/DatasetWriter.cpp): append
images / IMU / depth / LiDAR / GPS to the on-disk layout the readers
consume.  Pictures are written by the port's PNG codec (``io/png.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.io.xdataset import GNSS_LEAP_NS


class DatasetWriter:
    def __init__(self, out_dir: str, num_cams: int = 2, t0_ns: Optional[int] = None):
        self.root = os.path.join(out_dir, "mav0")
        self.num_cams = num_cams
        self.t0_ns = t0_ns if t0_ns is not None else 0
        os.makedirs(os.path.join(self.root, "imu0"), exist_ok=True)
        self._imu = open(os.path.join(self.root, "imu0", "data.csv"), "w")
        self._imu.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        self._cams = []
        for c in range(num_cams):
            os.makedirs(os.path.join(self.root, f"cam{c}", "data"), exist_ok=True)
            f = open(os.path.join(self.root, f"cam{c}", "data.csv"), "w")
            f.write("#timestamp [ns],filename\n")
            self._cams.append(f)
        self._lidar = None
        self._gps = None
        self._depth = None

    def _ns(self, t: float) -> int:
        return self.t0_ns + int(round(t * 1e9))

    def add_imu(self, t: float, gyr, acc):
        g, a = np.asarray(gyr), np.asarray(acc)
        self._imu.write(
            f"{self._ns(t)},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n"
        )

    def add_images(self, t: float, images):
        ns = self._ns(t)
        for c, img in enumerate(images[: self.num_cams]):
            name = f"{ns}.png"
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = np.clip(arr * 255, 0, 255).astype(np.uint8)
            png.write(os.path.join(self.root, f"cam{c}", "data", name), arr)
            self._cams[c].write(f"{ns},{name}\n")

    def add_depth(self, t: float, depth_m: np.ndarray):
        if self._depth is None:
            os.makedirs(os.path.join(self.root, "depth0", "data"), exist_ok=True)
            self._depth = open(
                os.path.join(self.root, "depth0", "data.csv"), "w"
            )
            self._depth.write("#timestamp [ns],filename\n")
        ns = self._ns(t)
        name = f"{ns}.png"
        mm = np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16)
        png.write(os.path.join(self.root, "depth0", "data", name), mm)
        self._depth.write(f"{ns},{name}\n")

    def add_lidar_points(self, t_points, pts, intensity=None):
        if self._lidar is None:
            os.makedirs(os.path.join(self.root, "lidar0"), exist_ok=True)
            self._lidar = open(os.path.join(self.root, "lidar0", "data.csv"), "w")
            self._lidar.write("#timestamp [ns],x,y,z,intensity\n")
        pts = np.asarray(pts)
        inten = np.ones(len(pts)) if intensity is None else np.asarray(intensity)
        for t, p, i in zip(np.asarray(t_points), pts, inten):
            self._lidar.write(
                f"{self._ns(float(t))},{p[0]},{p[1]},{p[2]},{i}\n"
            )

    def add_gps(self, t: float, pos, err):
        if self._gps is None:
            os.makedirs(os.path.join(self.root, "gps0"), exist_ok=True)
            self._gps = open(os.path.join(self.root, "gps0", "data.csv"), "w")
            self._gps.write("#timestamp [ns],x,y,z,err_x,err_y,err_z\n")
        p, e = np.asarray(pos), np.asarray(err)
        self._gps.write(
            f"{self._ns(t) + GNSS_LEAP_NS},{p[0]},{p[1]},{p[2]},{e[0]},{e[1]},{e[2]}\n"
        )

    def close(self):
        for f in [self._imu, self._lidar, self._gps, self._depth] + self._cams:
            if f is not None:
                f.close()
