"""RPG (UZH-FPV style) dataset reader.

Counterpart of ``okvis2x_tpu/io/rpg.py``, the reference's
`RpgDatasetReader` (okvis_multisensor_processing/src/
RpgDatasetReader.cpp:81-140):

    <root>/imu0/data.csv       EuRoC imu csv (t_ns, w, a)
    <root>/left_images.txt     "<id> <t_sec.frac> <relative image path>"
    <root>/right_images.txt    idem (optional, mono if absent)
    <root>/groundtruth.txt     "<id> <t> <px py pz> <qx qy qz qw>" (optional)
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.io.euroc import FrameEvent


def _read_images_txt(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            out.append((float(parts[1]), parts[2]))
    out.sort()
    return out


class RpgDataset:
    def __init__(self, path: str):
        self.root = path

        rows = np.loadtxt(
            os.path.join(path, "imu0", "data.csv"),
            delimiter=",", skiprows=1, ndmin=2,
        )
        # RPG txt exports sometimes carry seconds, EuRoC ns; autodetect
        scale = 1e-9 if rows[0, 0] > 1e14 else 1.0
        self.imu_t = rows[:, 0] * scale
        self.imu_gyr = rows[:, 1:4]
        self.imu_acc = rows[:, 4:7]

        left = _read_images_txt(os.path.join(path, "left_images.txt"))
        right_path = os.path.join(path, "right_images.txt")
        right = _read_images_txt(right_path) if os.path.exists(right_path) else []
        self.num_cams = 2 if right else 1

        self.frames: List[FrameEvent] = []
        rts = np.array([t for t, _ in right]) if right else np.zeros(0)
        for t, rel in left:
            paths = [os.path.join(path, rel)]
            if right:
                j = int(np.argmin(np.abs(rts - t)))
                paths.append(
                    os.path.join(path, right[j][1])
                    if abs(rts[j] - t) < 5e-3 else ""
                )
            self.frames.append(FrameEvent(t=t, paths=paths))

        self.ground_truth: Optional[np.ndarray] = None
        gt_path = os.path.join(path, "groundtruth.txt")
        if os.path.exists(gt_path):
            g = np.loadtxt(gt_path, ndmin=2)
            if g.shape[1] >= 9:
                # id t px py pz qx qy qz qw  ->  [t p q]
                self.ground_truth = g[:, 1:9]

    def load_image(self, path: str) -> np.ndarray:
        """Load a grayscale image as float32 in [0, 1]."""
        return png.decode_image(path).astype(np.float32) / 255.0

    def events(self) -> Iterator[Tuple[str, object]]:
        i = 0
        n_imu = len(self.imu_t)
        for fr in self.frames:
            while i < n_imu and self.imu_t[i] <= fr.t + 1e-9:
                yield "imu", (self.imu_t[i], self.imu_gyr[i], self.imu_acc[i])
                i += 1
            yield "frames", fr
        while i < n_imu:
            yield "imu", (self.imu_t[i], self.imu_gyr[i], self.imu_acc[i])
            i += 1
