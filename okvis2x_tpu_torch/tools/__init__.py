"""Command-line tools of the port (counterparts of ``tools/``), each run as
``python -m okvis2x_tpu_torch.tools.<name>``: `bag_creator` (a EuRoC-layout
folder to a ROS1 bag), `hilti_bag2mrl` and `vbr_bag2mrl` (rosbags to the MRL
folder layout) and `evaluate_ate` (the ATE/RPE regression gate), host work
only; and the trainers `train_segmentation`, `train_stereo`, `train_mvs` and
`train_vocab`, on cuda:0 unless ``--device`` names another device, writing
the JAX package's artifact layouts under ``build/okvis2x_tpu_torch/
artifacts/``."""
