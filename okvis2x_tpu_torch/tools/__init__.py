"""Command-line tools of the port (counterparts of ``tools/``), each run as
``python -m okvis2x_tpu_torch.tools.<name>``: `bag_creator` (a EuRoC-layout
folder to a ROS1 bag), `hilti_bag2mrl` and `vbr_bag2mrl` (rosbags to the MRL
folder layout) and `evaluate_ate` (the ATE/RPE regression gate).  Host work
only: none of them touches a device."""
