"""okvis2x_tpu_torch — the okvis2x_tpu visual-inertial SLAM system in PyTorch,
for one NVIDIA Hopper GPU (H100).

The JAX package ``okvis2x_tpu`` is the reference: every module here keeps the
name of its counterpart there and is tested against it.

What runs how:
  * the one hand-written kernel is the packed-descriptor Hamming distance
    matrix, CUDA C++ for sm_90a in ``csrc/hamming.cu`` (wrapper and plain
    PyTorch version in ``ops/hamming.py``); it serves every Hamming distance
    of the per-frame association (``frontend/matcher.py``);
  * detection, description, triangulation, the Gauss-Newton/LM solver with
    Schur elimination, IMU factors and marginalisation are PyTorch code;
  * graph bookkeeping, IMU prediction and link preintegration are numpy on
    the host (``*_np.py``, ``graph/estimator.py``).

Layer map (as in okvis2x_tpu):
  core/      SE(3)/quaternion math          cameras/   camera + distortion
  imu/       IMU preintegration             factors/   residuals
  solver/    batched GN/LM + Schur          graph/     sliding window,
  frontend/  detection, description,                   marginalisation
             matching, triangulation        ops/       the Hamming kernel
  pipeline/  per-frame orchestration        io/        synthetic data, ATE
  utils/     timing                         convert.py state from the JAX
                                                       package (numpy)

Ported so far: the synchronous stereo-inertial VIO path
(``pipeline.vio.VioPipeline``).  Loop closure, BoW, RANSAC, the pose graph,
final BA, GNSS, depth, LiDAR, submaps, the learned models, ROS2 and
``parallel/`` are not ported yet.
"""

__version__ = "0.1.0"
