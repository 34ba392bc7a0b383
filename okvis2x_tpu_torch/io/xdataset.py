"""Extended EuRoC dataset reader: depth / LiDAR / GNSS streams.

Counterpart of ``okvis2x_tpu/io/xdataset.py``, the reference's
`XDatasetReader` (okvis_multisensor_processing/src/XDatasetReader.cpp): the
extended-EuRoC ("MRL") layout adds

    depth0/data.csv + depth0/data/<t>.png   16-bit depth images [mm]
    lidar0/data.csv                         t[ns], x, y, z, intensity (one
                                            point per line, :344-365)
    gps0/data.csv                           cartesian: t[ns], x, y, z,
                                            err_xyz (:470-483) or geodetic:
                                            t, lat, lon, alt, hErr, vErr
                                            (:486-510)

Geodetic fixes are converted to a local ENU frame at the first fix
(replacing the reference's GeographicLib dependency with the standard WGS84
closed form).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.io.euroc import EurocDataset

WGS84_A = 6378137.0
WGS84_E2 = 6.69437999014e-3
GNSS_LEAP_NS = 18_000_000_000  # GPS-UTC leap seconds (reference constant)


def geodetic_to_enu(lat, lon, alt, lat0, lon0, alt0):
    """WGS84 geodetic -> local ENU at (lat0, lon0, alt0), radians in."""

    def to_ecef(la, lo, al):
        s, c = np.sin(la), np.cos(la)
        n = WGS84_A / np.sqrt(1 - WGS84_E2 * s * s)
        x = (n + al) * c * np.cos(lo)
        y = (n + al) * c * np.sin(lo)
        z = (n * (1 - WGS84_E2) + al) * s
        return np.array([x, y, z])

    p = to_ecef(lat, lon, alt)
    p0 = to_ecef(lat0, lon0, alt0)
    d = p - p0
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    R = np.array(
        [
            [-so, co, 0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ]
    )
    return R @ d


@dataclasses.dataclass
class LidarSweep:
    t: float  # sweep end time
    t_point: np.ndarray  # (N,) per-point times
    pts: np.ndarray  # (N, 3) in LiDAR frame
    intensity: np.ndarray  # (N,)


class XDataset(EurocDataset):
    """EuRoC + optional depth0/lidar0/gps0 streams."""

    def __init__(
        self,
        path: str,
        num_cams: int = 2,
        gps_type: str = "cartesian",
        lidar_sweep_dt: float = 0.1,
    ):
        super().__init__(path, num_cams)
        self.lidar_sweep_dt = lidar_sweep_dt

        # depth images
        self.depth_frames: List[Tuple[float, str]] = []
        dcsv = os.path.join(self.root, "depth0", "data.csv")
        if os.path.exists(dcsv):
            with open(dcsv) as f:
                next(f)
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) >= 2 and parts[0]:
                        self.depth_frames.append(
                            (
                                (int(parts[0]) - self.t0_ns) * 1e-9,
                                os.path.join(self.root, "depth0", "data", parts[1]),
                            )
                        )

        # LiDAR points (one per line), chunked into sweeps
        self.lidar: Optional[np.ndarray] = None  # (N, 5): t, x, y, z, i
        lcsv = os.path.join(self.root, "lidar0", "data.csv")
        if os.path.exists(lcsv):
            raw = np.loadtxt(lcsv, delimiter=",", skiprows=1)
            if raw.ndim == 1:
                raw = raw[None]
            t = (raw[:, 0] - self.t0_ns) * 1e-9
            self.lidar = np.concatenate(
                [t[:, None], raw[:, 1:4],
                 raw[:, 4:5] if raw.shape[1] > 4 else np.zeros((len(raw), 1))],
                axis=1,
            )

        # GPS fixes -> local cartesian
        self.gps: Optional[np.ndarray] = None  # (N, 7): t, xyz, err_xyz
        gcsv = os.path.join(self.root, "gps0", "data.csv")
        if not os.path.exists(gcsv):
            gcsv = os.path.join(self.root, "gps0", "data_raw.csv")
        if os.path.exists(gcsv):
            raw = np.loadtxt(gcsv, delimiter=",", skiprows=1)
            if raw.ndim == 1:
                raw = raw[None]
            t = (raw[:, 0] - GNSS_LEAP_NS - self.t0_ns) * 1e-9
            if gps_type == "cartesian":
                pos = raw[:, 1:4]
                err = raw[:, 4:7]
            else:  # geodetic
                lat = np.radians(raw[:, 1])
                lon = np.radians(raw[:, 2])
                alt = raw[:, 3]
                pos = np.stack(
                    [
                        geodetic_to_enu(la, lo, al, lat[0], lon[0], alt[0])
                        for la, lo, al in zip(lat, lon, alt)
                    ]
                )
                err = np.stack(
                    [raw[:, 4], raw[:, 4], raw[:, 5]], axis=1
                )
            self.gps = np.concatenate([t[:, None], pos, err], axis=1)

    def load_depth(self, path: str, scale: float = 1e-3) -> np.ndarray:
        """16-bit PNG depth in millimetres -> float32 metres."""
        return png.read(path).astype(np.float32) * scale

    def lidar_sweeps(self) -> Iterator[LidarSweep]:
        """Group the point stream into fixed-duration sweeps."""
        if self.lidar is None:
            return
        t = self.lidar[:, 0]
        start = t[0]
        i0 = 0
        for i in range(len(t)):
            if t[i] - start >= self.lidar_sweep_dt:
                yield LidarSweep(
                    t=float(t[i - 1]),
                    t_point=t[i0:i].copy(),
                    pts=self.lidar[i0:i, 1:4].copy(),
                    intensity=self.lidar[i0:i, 4].copy(),
                )
                i0 = i
                start = t[i]
        if i0 < len(t) - 1:
            yield LidarSweep(
                t=float(t[-1]),
                t_point=t[i0:].copy(),
                pts=self.lidar[i0:, 1:4].copy(),
                intensity=self.lidar[i0:, 4].copy(),
            )

    def events(self):
        """Timestamp-ordered events: imu / frames / depth / lidar_sweep /
        gps (imu first at equal stamps, like the reference dispatch)."""
        streams = []
        for kind, ev in super().events():
            streams.append((ev[0] if kind == "imu" else ev.t, 0, kind, ev))
        for t, p in self.depth_frames:
            streams.append((t, 1, "depth", (t, p)))
        for sweep in self.lidar_sweeps():
            streams.append((sweep.t, 2, "lidar", sweep))
        if self.gps is not None:
            for row in self.gps:
                streams.append((row[0], 3, "gps", (row[0], row[1:4], row[4:7])))
        streams.sort(key=lambda x: (x[0], x[1]))
        for _, _, kind, ev in streams:
            yield kind, ev
