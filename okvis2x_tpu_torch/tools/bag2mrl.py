"""The shared body of ``hilti_bag2mrl`` and ``vbr_bag2mrl``: each bag named
on the command line converted to a sibling folder in the MRL
(EuRoC-extended) layout through ``io/bag_convert.py`` with one preset."""

from __future__ import annotations

import sys


def convert_all(bags, preset):
    """Convert each bag to a folder named after it (without .bag)."""
    from okvis2x_tpu_torch.io.bag_convert import convert_bag

    if not bags:
        sys.exit("No bag files provided.")
    for bag in bags:
        out = bag[:-4] if bag.endswith(".bag") else bag + "_mrl"
        print(f"Processing {bag} -> {out}")
        counts = convert_bag(bag, out, preset)
        print(f"  images: {counts['images']}  imu: {counts['imu']}  "
              f"lidar points: {counts['lidar_points']}")
