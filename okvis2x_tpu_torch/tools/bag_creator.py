"""Create a ROS1 bag from an EuRoC-layout dataset folder (counterpart of
``tools/bag_creator.py``, ≙ the reference's okvis_apps/scripts/
bag_creator.py, without needing ROS).

Folder layout consumed:
  dataset/camN/data.csv + camN/data/<t>.png   -> /camN/image_raw
  dataset/imu0/data.csv                        -> /imu0

Images are read by the port's codec (``io/png.py``, PNG only) and turned
grey as Pillow's ``convert("L")`` does (`png.pil_grey`), so that the bag
equals the JAX tool's byte for byte.

Usage: python -m okvis2x_tpu_torch.tools.bag_creator --folder <dataset> \\
           --output-bag out.bag
"""

from __future__ import annotations

import argparse
import csv
import os

from okvis2x_tpu_torch.io import png, rosbag1


def main(argv=None):
    ap = argparse.ArgumentParser(description="Create a ROS bag from images and IMU data.")
    ap.add_argument("--folder", required=True, help="dataset folder")
    ap.add_argument("--output-bag", default="output.bag")
    args = ap.parse_args(argv)

    events = []  # (t_ns, kind, payload)
    for entry in sorted(os.listdir(args.folder)):
        if entry.startswith("cam") and os.path.isdir(os.path.join(args.folder, entry)):
            data_dir = os.path.join(args.folder, entry, "data")
            for fn in sorted(os.listdir(data_dir)):
                stem, ext = os.path.splitext(fn)
                if ext.lower() in (".png", ".jpg", ".bmp"):
                    events.append((int(stem), "img", (entry, os.path.join(data_dir, fn))))
    imu_csv = os.path.join(args.folder, "imu0", "data.csv")
    if os.path.exists(imu_csv):
        with open(imu_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                events.append((int(row[0]), "imu", [float(v) for v in row[1:7]]))

    events.sort(key=lambda e: e[0])
    n_img = n_imu = 0
    with rosbag1.Rosbag1Writer(args.output_bag) as bag:
        for t, kind, payload in events:
            if kind == "img":
                cam, path = payload
                img = png.pil_grey(png.read(path))
                bag.write(f"/{cam}/image_raw", "sensor_msgs/Image", t,
                          rosbag1.encode_image(t, img, "mono8"))
                n_img += 1
            else:
                bag.write("/imu0", "sensor_msgs/Imu", t,
                          rosbag1.encode_imu(t, payload[0:3], payload[3:6]))
                n_imu += 1
    print(f"wrote {args.output_bag}: {n_img} images, {n_imu} imu samples")


if __name__ == "__main__":
    main()
