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
    and training (``frontend/bow.py``), the loop matching and the
    verification of a relocalisation; ``csrc/hamming.cu`` gives the distance
    matrix to the callers that want it;
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
  pipeline/  per-frame orchestration,       io/        datasets (EuRoC,
             depth helpers, submapping,                extended, Leica, RPG),
             queues                                    configs, PNG, YAML,
  parallel/  matrix-free pose-graph PCG                synthetic data, ATE,
  apps/      the dataset app, the                      ROS1/ROS2 bags, the
             synchronous, live and                     native loader
             network nodes, the             ros2/      messages, transports,
             realsense publisher                       publisher, subscriber
  tools/     bag creation and conversion, the ATE gate
  models/    depth nets, census, MVS        mapping/   occupancy grid, colour
  api.py     public state types
  convert.py state from the JAX package     utils/     timing, the
             (numpy)                                   forward-AD lock
                                            graph/component.py  map files

Ported so far: the stereo-inertial VIO path (``pipeline.vio.VioPipeline``)
with pose refinement and the pipelined solve or the deferred fused frontend
(one launch chain a frame without a host sync, consumed a frame later),
loop closure (BoW, RANSAC, the pose graph) synchronous or asynchronous (the
place-recognition worker, the background optimisation of
``graph/fullgraph.py``: the complete factor graph or the pose graph), the
single-device matrix-free pose-graph solver of ``parallel/dist_posegraph.py``
and the final BA; a vocabulary trained online when there is no vocabulary
file, and multi-session maps (save and load a session, relocalise against
it, export the map); the dataset app ``apps/okvis2x_app.py`` (vio and slam
modes on EuRoC-layout datasets with okvis2.yaml-schema configs, the
recorder, the debug CSVs, GNSS streams) with its own PNG codec and YAML
reader; GNSS fusion (the 4-dof alignment and its status machine, the
asynchronous position rows) and online extrinsics calibration; RGB-D
(per-keypoint depth priors and depth-initialised landmarks), the learned
stereo and multi-view depth nets with the JAX package's shipped weights,
and occupancy submaps with colour, which the app's rgbd and depth modes
integrate keyframe by keyframe: dense grids, or brick-sparse ones at fine
resolutions, with their meshes and bounding boxes exported; LiDAR-visual-
inertial SLAM (sweep deskew, submap ICP rows, map-to-map alignment edges);
the synchronous ROS2 node without ROS (``apps/okvis2x_node_synchronous.py``:
ROS1 and ROS2 bags replayed through the node graph of ``apps/okvis2x_node.py``
over the in-process transport of ``ros2/``); the live rclpy nodes, the network
node with census stereo depth in the loop and the realsense publisher; the
native frame prefetcher and queue (``io/native_loader.py``), the asynchronous
submapping runner and the bag tools (``tools/``).  Semantic weighting and the
multi-device ``parallel/`` solvers are not ported yet.

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
