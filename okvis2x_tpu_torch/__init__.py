"""okvis2x_tpu_torch — the okvis2x_tpu visual-inertial SLAM system in PyTorch,
for one NVIDIA Hopper GPU (H100).

The JAX package ``okvis2x_tpu`` is the reference: every module here keeps the
name of its counterpart there and is tested against it.

What runs how:
  * two hand-written kernels, CUDA C++ for sm_90a, compute the Hamming
    distances of packed descriptors (wrappers and plain PyTorch versions in
    ``ops/hamming.py``): ``csrc/hamming_match.cu`` reduces the masked
    distances to best matches without writing the matrix and serves the
    per-frame association (``frontend/matcher.py``), the vocabulary descent
    (``frontend/bow.py``) and the loop matching; ``csrc/hamming.cu`` gives
    the distance matrix to the callers that want it;
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
(``pipeline.vio.VioPipeline``) with synchronous loop closure (BoW, RANSAC,
the pose graph) and the final BA.  The asynchronous loop closure, GNSS,
depth, LiDAR, submaps, the learned models, ROS2 and ``parallel/`` are not
ported yet.

The entry points run on the first CUDA device unless the caller names
another device (``device="cpu"`` for the CPU).
"""

__version__ = "0.1.0"


def default_device():
    """The device an entry point runs on when the caller names none: the
    first CUDA device.  Raises where there is none, instead of carrying on
    on the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "okvis2x_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run on the CPU')
    return torch.device("cuda:0")
