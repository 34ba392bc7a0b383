"""Per-run debug CSV writers.

Counterpart of ``okvis2x_tpu/io/debug_csv.py``, the equivalent of the
reference's observability hooks: the IMU / keypoint-track CSV writers on the
estimator interface (okvis_common/src/ViInterface.cpp:408-441,
setImuCsvFile / setTracksCsvFile) and the LiDAR-alignment residual
statistics dump (okvis_ceres/src/ViGraph.cpp:1941
writeLidarDebugStatisticsCsv).  Column layouts match the reference so
existing analysis scripts keep working.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


class ImuCsvWriter:
    """timestamp, omega_tilde_WS_S_{x,y,z}, a_tilde_WS_S_{x,y,z}."""

    HEADER = (
        "timestamp, omega_tilde_WS_S_x, omega_tilde_WS_S_y, "
        "omega_tilde_WS_S_z, a_tilde_WS_S_x, a_tilde_WS_S_y, a_tilde_WS_S_z"
    )

    def __init__(self, path: str):
        self._f = open(path, "w")
        self._f.write(self.HEADER + "\n")

    def add(self, t: float, gyr, acc):
        g = np.asarray(gyr, float)
        a = np.asarray(acc, float)
        self._f.write(
            f"{t:.9f}, {g[0]}, {g[1]}, {g[2]}, {a[0]}, {a[1]}, {a[2]}\n"
        )

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class TracksCsvWriter:
    """Per-camera keypoint-track dump: timestamp, landmark_id, z_tilde_x,
    z_tilde_y, z_tilde_stdev, descriptor (hex)."""

    HEADER = "timestamp, landmark_id, z_tilde_x, z_tilde_y, z_tilde_stdev, descriptor"

    def __init__(self, path: str):
        self._f = open(path, "w")
        self._f.write(self.HEADER + "\n")

    def add_frame(
        self,
        t: float,
        landmark_ids: np.ndarray,
        uv: np.ndarray,
        stdev: np.ndarray,
        descriptors: Optional[np.ndarray] = None,
    ):
        lids = np.asarray(landmark_ids)
        uv = np.asarray(uv)
        sd = np.asarray(stdev)
        for i in range(len(lids)):
            if lids[i] < 0:
                continue
            desc = ""
            if descriptors is not None:
                desc = np.asarray(descriptors[i]).tobytes().hex()
            self._f.write(
                f"{t:.9f}, {int(lids[i])}, {uv[i, 0]}, {uv[i, 1]}, "
                f"{sd[i] if sd.ndim else float(sd)}, {desc}\n"
            )

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


@dataclasses.dataclass
class LidarDebugInfo:
    """≙ ViGraph::lidarDbgInfo (okvis_ceres/include/okvis/ViGraph.hpp:910)."""

    frame_id: int
    reference_id: int
    n_residuals: int = 0
    n_nonzero_occ: int = 0
    n_nonzero_grad: int = 0
    mean_res: float = 0.0
    max_residual: float = 0.0
    n_big_residuals: int = 0
    mean_field_val: float = 0.0
    min_field_val: float = 0.0
    max_field_val: float = 0.0
    mean_grad_norm: float = 0.0
    max_grad_norm: float = 0.0

    @staticmethod
    def from_arrays(
        frame_id: int,
        reference_id: int,
        residuals: np.ndarray,
        occ: np.ndarray,
        grad_norm: np.ndarray,
        big_threshold: float = 1.0,
    ) -> "LidarDebugInfo":
        r = np.asarray(residuals, float)
        o = np.asarray(occ, float)
        g = np.asarray(grad_norm, float)
        n = len(r)
        return LidarDebugInfo(
            frame_id=frame_id,
            reference_id=reference_id,
            n_residuals=n,
            n_nonzero_occ=int((o != 0).sum()),
            n_nonzero_grad=int((g != 0).sum()),
            mean_res=float(np.abs(r).mean()) if n else 0.0,
            max_residual=float(np.abs(r).max()) if n else 0.0,
            n_big_residuals=int((np.abs(r) > big_threshold).sum()),
            mean_field_val=float(o.mean()) if n else 0.0,
            min_field_val=float(o.min()) if n else 0.0,
            max_field_val=float(o.max()) if n else 0.0,
            mean_grad_norm=float(g.mean()) if n else 0.0,
            max_grad_norm=float(g.max()) if n else 0.0,
        )


def write_lidar_debug_csv(prefix: str, infos: List[LidarDebugInfo]) -> str:
    """Write `<prefix>-lidar-info.csv` with the reference's column layout."""
    path = prefix + "-lidar-info.csv"
    with open(path, "w") as f:
        f.write(
            "# frame id, reference frame id, n_residual, n_nonzro_occ, "
            "n_non_zero_grad, mean res., max res., n_big_residuals, mean occ, "
            "min occ, max occ, mean grad norm, max grad norm\n"
        )
        for d in infos:
            f.write(
                f"{d.frame_id}, {d.reference_id}, {d.n_residuals}, "
                f"{d.n_nonzero_occ}, {d.n_nonzero_grad}, {d.mean_res}, "
                f"{d.max_residual}, {d.n_big_residuals}, {d.mean_field_val}, "
                f"{d.min_field_val}, {d.max_field_val}, {d.mean_grad_norm}, "
                f"{d.max_grad_norm}\n"
            )
    return path


class GpsResidualCsvWriter:
    """GPS residual dump (≙ ThreadedSlam.cpp:1659 GPS debug CSV)."""

    HEADER = "timestamp, frame_id, res_x, res_y, res_z, chi2"

    def __init__(self, path: str):
        self._f = open(path, "w")
        self._f.write(self.HEADER + "\n")

    def add(self, t: float, frame_id: int, residual, chi2: float):
        r = np.asarray(residual, float)
        self._f.write(
            f"{t:.9f}, {int(frame_id)}, {r[0]}, {r[1]}, {r[2]}, {chi2}\n"
        )

    def close(self):
        self._f.close()
