"""Convert Hilti SLAM Challenge 2022 rosbags to the MRL (EuRoC-extended)
folder layout (counterpart of ``tools/hilti_bag2mrl.py``, ≙ the reference's
tools/hilti_bag2mrl.py, with the port's pure-Python bag reader: no ROS
installation required).

Usage: python -m okvis2x_tpu_torch.tools.hilti_bag2mrl <bag1.bag> [bag2.bag ...]
Writes each bag to a sibling folder named after the bag (without .bag).
"""

from __future__ import annotations

import sys

from okvis2x_tpu_torch.io.bag_convert import HILTI
from okvis2x_tpu_torch.tools.bag2mrl import convert_all


def main(argv=None):
    convert_all(sys.argv[1:] if argv is None else argv, HILTI)


if __name__ == "__main__":
    main()
