"""Convert VBR (Vision Benchmark in Rome) rosbags to the MRL
(EuRoC-extended) folder layout (counterpart of ``tools/vbr_bag2mrl.py``,
≙ the reference's tools/vbr_bag2mrl.py, with the port's pure-Python bag
reader: no ROS installation required).

Per-point Ouster timestamps (`t`, nanoseconds relative to the message
header stamp) are made absolute and the points written in time order;
all-zero returns are dropped, matching the reference converter.

Usage: python -m okvis2x_tpu_torch.tools.vbr_bag2mrl <bag1.bag> [bag2.bag ...]
"""

from __future__ import annotations

import sys

from okvis2x_tpu_torch.io.bag_convert import VBR
from okvis2x_tpu_torch.tools.bag2mrl import convert_all


def main(argv=None):
    convert_all(sys.argv[1:] if argv is None else argv, VBR)


if __name__ == "__main__":
    main()
