"""Leica BLK2GO-style dataset reader.

Counterpart of ``okvis2x_tpu/io/leica.py``, the reference's
`LeicaDatasetReader` (okvis_multisensor_processing/src/
LeicaDatasetReader.cpp:26-240):

    <root>/imu_bottom.csv          t_ns, wx, wy, wz, ax, ay, az
    <root>/lidar.csv               t_ns, x, y, z[, intensity]   (one ray/row)
    <root>/pinhole/  or  /imgs/    <cam>_<t_ns>.<ext>, cam in
                                   {bottom, front, left, right, top}
    <root>/gps0/data.csv           cartesian EuRoC gps (t_ns, x, y, z, sx, sy, sz)
    <root>/gnss.csv                geodetic (t_ns, lat, lon, alt, hErr, vErr)

Yields the same `events()` stream as `EurocDataset`/`XDataset`, with LiDAR
rays batched into sweeps by time window (the reference streams per-ray and
batches downstream; batching here keeps device transfers large).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.io.euroc import FrameEvent
from okvis2x_tpu_torch.io.xdataset import LidarSweep, geodetic_to_enu

CAM_ORDER = ["bottom", "front", "left", "right", "top"]


class LeicaDataset:
    def __init__(
        self,
        path: str,
        cameras: Optional[List[str]] = None,
        cam_type: str = "pinhole",
        sweep_dt: float = 0.1,
    ):
        self.root = path
        self.sweep_dt = sweep_dt
        cameras = cameras or ["bottom"]
        self.cam_names = [c for c in CAM_ORDER if c in cameras]

        # IMU
        imu_path = os.path.join(path, "imu_bottom.csv")
        rows = np.loadtxt(imu_path, delimiter=",", skiprows=1, ndmin=2)
        self.imu_t = rows[:, 0] * 1e-9
        self.imu_gyr = rows[:, 1:4]
        self.imu_acc = rows[:, 4:7]

        # images: one directory, camera encoded in the filename stem
        img_dir = os.path.join(path, "pinhole" if cam_type == "pinhole" else "imgs")
        per_cam: Dict[str, List[Tuple[float, str]]] = {c: [] for c in self.cam_names}
        if os.path.isdir(img_dir):
            for name in os.listdir(img_dir):
                stem = os.path.splitext(name)[0]
                parts = stem.split("_")
                if len(parts) < 2:
                    continue
                cam, t_ns = parts[0].lower(), parts[1]
                if cam in per_cam:
                    per_cam[cam].append(
                        (int(t_ns) * 1e-9, os.path.join(img_dir, name))
                    )
        for c in per_cam:
            per_cam[c].sort()
        # synchronise on the first camera's timestamps (nearest within 5 ms)
        self.frames: List[FrameEvent] = []
        if self.cam_names and per_cam[self.cam_names[0]]:
            base = per_cam[self.cam_names[0]]
            for t, p0 in base:
                paths = [p0]
                for c in self.cam_names[1:]:
                    cand = per_cam[c]
                    ts = np.array([x[0] for x in cand]) if cand else np.zeros(0)
                    j = int(np.argmin(np.abs(ts - t))) if len(ts) else -1
                    paths.append(
                        cand[j][1] if j >= 0 and abs(ts[j] - t) < 5e-3 else ""
                    )
                self.frames.append(FrameEvent(t=t, paths=paths))

        # LiDAR rays -> sweeps
        self.sweeps: List[LidarSweep] = []
        lidar_path = os.path.join(path, "lidar.csv")
        if os.path.exists(lidar_path):
            rows = np.loadtxt(lidar_path, delimiter=",", skiprows=1, ndmin=2)
            t = rows[:, 0] * 1e-9
            pts = rows[:, 1:4]
            if len(t):
                t0 = t[0]
                start = 0
                for i in range(1, len(t) + 1):
                    if i == len(t) or t[i] - t0 >= sweep_dt:
                        self.sweeps.append(
                            LidarSweep(
                                t=float(t[i - 1]),
                                t_point=t[start:i].copy(),
                                pts=pts[start:i].copy(),
                                intensity=(
                                    rows[start:i, 4].copy()
                                    if rows.shape[1] > 4
                                    else np.ones(i - start)
                                ),
                            )
                        )
                        if i < len(t):
                            t0 = t[i]
                            start = i

        # GNSS
        self.gps: List[Tuple[float, np.ndarray, np.ndarray]] = []
        cart = os.path.join(path, "gps0", "data.csv")
        geod = os.path.join(path, "gnss.csv")
        if os.path.exists(cart):
            rows = np.loadtxt(cart, delimiter=",", skiprows=1, ndmin=2)
            for r in rows:
                self.gps.append((r[0] * 1e-9, r[1:4], r[4:7]))
        elif os.path.exists(geod):
            rows = np.loadtxt(geod, delimiter=",", skiprows=1, ndmin=2)
            if len(rows):
                lat0, lon0, alt0 = rows[0, 1], rows[0, 2], rows[0, 3]
                for r in rows:
                    enu = geodetic_to_enu(r[1], r[2], r[3], lat0, lon0, alt0)
                    err = np.array([r[4], r[4], r[5]])
                    self.gps.append((r[0] * 1e-9, np.asarray(enu), err))

    def load_image(self, path: str) -> np.ndarray:
        """Load a grayscale image as float32 in [0, 1]."""
        return png.decode_image(path).astype(np.float32) / 255.0

    def events(self) -> Iterator[Tuple[str, object]]:
        """Timestamp-ordered: imu / frames / lidar_sweep / gps."""
        streams = []
        for i in range(len(self.imu_t)):
            streams.append(
                (self.imu_t[i], 0, "imu",
                 (self.imu_t[i], self.imu_gyr[i], self.imu_acc[i]))
            )
        for fr in self.frames:
            streams.append((fr.t, 2, "frames", fr))
        for sw in self.sweeps:
            streams.append((sw.t, 1, "lidar", sw))
        for g in self.gps:
            streams.append((g[0], 1, "gps", g))
        streams.sort(key=lambda x: (x[0], x[1]))
        for _, _, kind, payload in streams:
            yield kind, payload
