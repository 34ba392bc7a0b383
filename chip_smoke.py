#!/usr/bin/env python3
"""Smoke run of okvis2x_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires a CUDA device and prints its `nvidia-smi` name and power limit;
2. builds the two Hamming CUDA kernels (csrc/hamming.cu, the distance matrix,
   and csrc/hamming_match.cu, the fused match) into one library and holds
   each against its plain PyTorch version for exact equality: the matrix at
   nine shapes, the fused match in the form of every site that calls it
   (matcher fills with a random mask, mutual check, 385 fills, segments with
   column argmins and an empty candidate, per-row segments, ragged edges),
   on inputs with duplicated rows so that ties occur;
3. times both kernels at the main path's shapes: the device time of a launch
   (100 launches captured in a CUDA graph, the replay timed with CUDA
   events), the time of a Python call, the plain version, one library
   formulation (a bfloat16 matmul of the +-1 descriptors, unpacked before
   the clock starts), the bound (the larger of bytes over the memory rate
   and popcounts over the card's popcount rate) and the launch floor (an
   empty kernel launched the same way, one of 100 in a CUDA graph); and two
   whole sites,
   `matcher.match_masked` at 704x1024 and `bow.assign_packed` at 704
   descriptors, as they were composed on the matrix kernel and as they are;
   The fused kernel is also held against its plain version from a second
   host thread on a CUDA stream of its own, as the place-recognition worker
   launches it;
4. VIO: renders 8 frames (0.4 s) of the synthetic circuit at the EuRoC
   operating point (752x480 stereo at 20 Hz, 200 Hz IMU, 704 keypoints) in
   memory and feeds them to `VioPipeline` on the GPU under the JAX package's
   default `PipelineConfig` (pose refinement, pipelined solve, loop closure
   with the place-recognition worker), then `finish()`: every pose must be
   finite, the association must have launched the fused kernel 4 times a
   frame, and the online position ATE must be at most 0.25 m; the first
   frames are also run on the CPU (plain versions) and must agree with the
   GPU run (the CPU halves of this check and of phase 9 run meanwhile in a
   spawned process);
5. ratio-test matching: the cam-0 descriptors of the last two frames of that
   run through `matcher.match` with Lowe's ratio test and the mutual check,
   the caller that wants the distance matrix: the matrix kernel must have
   been launched and the matches must equal the CPU's;
6. synchronous loop closure: the same operating point on a circuit of
   radius 0.8 m (one lap in about 125 frames; 150 frames rendered once for
   phases 6 to 9, which run 128, 20, 128 and 150 of them) with the
   synchronous, non-pipelined path (BoW place
   recognition on the shipped vocabulary, loop matching, non-central
   RANSAC, in-line pose-graph solve), then `finish()` and the final BA: at
   least one closure must be accepted, the fused kernel must have been
   launched from the vocabulary descent and the loop matching, every pose
   must be finite, and the online and final ATE must both be at most
   0.25 m;
7. multi-session: phase 6's pipeline is session A and is saved as a map
   component; session B is a new pipeline without a vocabulary file
   (`vocab_path=""`) in phase 6's configuration that loads it (a vocabulary
   of 256 words bootstrapped from A's descriptors: binary k-means on the
   fused kernel) and runs the first 8 frames from a world frame 1.5 m
   lateral and 0.1 rad of yaw off A's (moved so right after the
   estimator's first state, before the first keyframe is recorded): B must
   relocalise, its poses from then on must lie within 0.2 m and 0.05 rad
   of A's estimate of the same frames, the vocabulary must equal the plain
   trainer's on the same descriptors and seed on the card, one
   verification's mutual match must equal the plain version's, and the
   fused kernel must have been launched from the sites "vocab" and
   "reloc";
7b. the dataset app: the port's `generate` writes the first 8 frames of
   that circuit (752x480 PNGs, 200 Hz IMU, ground truth) in the EuRoC
   layout under build/app_phase/, with an okvis2.yaml-schema config; the
   first and last frames read back through `EurocDataset` must equal
   `render_sequence`'s bit for bit; `okvis2x_tpu_torch.apps.okvis2x_app.main`
   then runs `--mode slam` on it on the default device (cuda:0) with both
   debug CSVs: `trajectory.tum` must have a row a frame,
   `final_trajectory.tum` a row an estimator state, the online ATE must be
   at most 0.25 m, the IMU CSV a row per IMU sample fed, the tracks CSV rows,
   and the fused kernel must have been launched from the association and the
   vocabulary descent; it prints the frame times, the peak memory and the
   launches by site;
7b'. bag replay through the synchronous node: that dataset's events written
   as a ROS1 bag (`Rosbag1Writer`: mono8 `sensor_msgs/Image` on
   /cam0/image_raw and /cam1/image_raw, `sensor_msgs/Imu` on /imu0) and as a
   ROS2 bag (`Rosbag2Writer`, sqlite3 and CDR) under build/bag_phase/, both
   read back with every image and IMU sample equal to the dataset's bit for
   bit; `okvis2x_tpu_torch.apps.okvis2x_node_synchronous.main` replays the
   ROS1 bag with the config on the default device (cuda:0) under the node's
   defaults (the config's cameras, 512 keypoints in 2 octaves, loop closures
   with the place-recognition worker): a row a frame in
   okvis2_trajectory.csv, a finite okvis2_final_trajectory.csv with a row an
   estimator state, the online ATE at most 0.25 m and at most twice the JAX
   node's on the same bag (floor 0.05 m, `JAX_NODE`), the fused kernel
   launched 4 times a frame from the association; then the ROS2 bag's first
   4 frames, whose online poses must lie within 1e-6 m of the ROS1 run's; it
   prints the frame times, the peak memory and the launches by site;
7b''. the live nodes on the same frames: (a) the network node
   (`okvis2x_network_node.build_network_graph` over the in-process
   transport on the default device, cuda:0, under the JAX `main`'s
   defaults, 32 disparities), fed the dataset's IMU samples and images on
   its input topics: a depth, a sigma and an odometry message a frame, the
   online ATE at most twice the JAX network node's on the same messages on
   the CPU (floor 0.05 m, `JAX_NETWORK_NODE`) and within 1e-3 m of it, the
   fused kernel launched 4 times a frame from the association, frame 0's
   census depth on the card within 1e-3 m of the CPU's on 99.9% of the
   pixels; it prints the frame times with and without the stereo depth, the
   window solve and the peak memory; (b) the realsense publisher over a
   fake device replaying the dataset: every frame and IMU row published;
   (c) the native loader: whether its library built (it needs libpng), the
   dataset's 24 PNGs decoded equal to io/png.py's, the decodes that fell
   back to io/png.py counted, the native queue's round trip, drop, timeout
   and shutdown (or its refusal without the library);
7c. GNSS and online calibration through the app: `generate` writes the first
   24 frames (1.2 s) of the flagship circuit (752x480, 20 Hz) with its 5 Hz
   gps0/ stream (a frame yawed 0.4 rad and moved (30, -12, 4) m from the
   world, 5 cm noise) under build/gnss_phase/, with an okvis2.yaml-schema
   config that turns on `online_calibration` (window and final BA);
   `okvis2x_app.main` runs `--mode slam --reader xdataset` on cuda:0: the
   GNSS status must reach "Initialised", a window solve must have carried a
   GNSS row, the online and final ATE must be at most 0.25 m, and the T_GW
   errors and the global ATE (the trajectory mapped into the GNSS frame
   through the recovered T_GW, against the true G-frame ground truth) at
   most twice the JAX app's on the same frames (floors 1 degree, 0.05 m);
   it prints the status by frame, how far T_SC moved, the frame, solve,
   alignment and final-BA times, the peak memory and the launches by site;
7d. RGB-D through the app: `generate` writes the first 16 frames (0.8 s) of
   the 0.8 m circuit (752x480, 20 Hz, seed 3) with cam0's depth0/ stream
   under build/rgbd_phase/; `okvis2x_app.main` runs `--mode rgbd --reader
   xdataset` on cuda:0 (sensor depth priors; on every keyframe the learned
   stereo and multi-view depth against the last two of four kept keyframes,
   fused by inverse variance and integrated into the 128^3 occupancy
   submaps): the online and final ATE must be at most 0.25 m and at most
   twice the JAX app's on the same frames (floor 0.05 m), depth priors must
   have been attached, at least as many keyframes integrated as by the JAX
   app, map.ply's point count within 5% of the JAX app's and the grids'
   integration counts, log-odds sum, observed voxels and voxels with
   positive log-odds within 1% of the JAX app's; on the last
   keyframe's inputs the card's fused depth must be within 1e-3 m of the
   CPU's where both are valid, with the valid masks differing on at most
   0.1% of the pixels, and the card's 128^3 grid after integrating it must
   equal the CPU's (counts, occupied sets, log-odds within 1e-5); it prints
   the stage means, the nets' device times (CUDA events), one integration's
   time and the peak memory;
7d'. asynchronous submapping: that phase's 16 depth0/ frames and online
   states through `AsyncSubmapping` (two threads, the port's queues) into a
   grid on the card, against the synchronous `SubmappingInterface` fed the
   same items: every frame integrated, counts equal, log-odds within 1e-5;
7e. the depth mode: 32 frames of the sinusoid scene at the same operating
   point with cam0 an rgb camera in the config and an se2.yaml (the dense
   grid, submaps of up to 50 keyframes), `--mode depth --se2-config`: the
   same ATE, keyframe, map and grid checks, and map.ply must carry points
   with RGB;
7e'. the fine grid: the app in depth mode on the first 8 frames of that
   dataset under the depth mode's se2.yaml at the reference's 0.025 m
   (1024^3: the brick-sparse grid, a 128^3 table and 8192 bricks a submap):
   the ATEs at most twice the JAX app's on the same frames (floor 0.05 m),
   the bricks allocated, the grids and map.ply within 1% and 5% of the JAX
   app's; map.ply stays empty in both (no voxel of the capped pools reaches
   its log-odds 1.0), so the app's export is also written at log-odds 0 and
   held to the JAX app's: its points and their counts in 2 m cubes within
   5%, their mean position within 1 cm and mean colour within 1 of 255;
   the RGB-D phase's fused keyframe integrated into that grid on the
   card must equal the CPU's (table, slots' bricks, count and counts; log-odds
   within 1e-5), with one integration's device time; the depth phase's dense
   submap exported as a PLY mesh and its boxes as VTK, the triangles and the
   file as the CPU's;
7f. LiDAR through the app: `generate` writes the first LIDAR_FRAMES frames of
   the 8 m circuit (752x480, 20 Hz, seed 3) and, through the port's
   `DatasetWriter`, tools/lidar_scale_run.py's hall sweeps (512 rays a 0.1 s
   sweep, cylinder wall at 13 m, floor and ceiling, 1 cm noise) under
   build/lidar_phase/, with an okvis2.yaml-schema config and an se2.yaml of
   that tool's submaps but 5 keyframes a submap (`LIDAR_SE2`);
   `okvis2x_app.main` runs `--mode lidar --reader xdataset` on cuda:0
   (sweep deskew, voxel filter, live frame-to-map edges, integration into
   128^3 submaps, map-to-map alignment edges into the window): the online
   ATE must be at most twice the JAX app's on the same frames (floor
   0.05 m), the sweeps integrated, submaps and map-to-map edges equal to the
   JAX app's (`JAX_LIDAR`, at least one edge), at least one live
   constraint, map.ply's point count within 5% and the grids within 1%;
   then the drift-recovery scenario of tests/test_lidar_vio.py on the card
   with per-point ICP rows and with the compressed edge (under 3 cm left
   and under half the edge's, card equal to CPU within 1e-6 m), and it
   prints the frame times, the stage means, the device times of one
   2048-ray integration and one alignment edge, the aten calls of one
   linearisation with ICP rows and the peak memory;
8. asynchronous loop closure on the same frames: the flagship configuration
   of tools/slam_bench.py without its deferred frontend (place recognition
   on the worker thread, the background optimisation of the history,
   pipelined solve, the realtime budget controller at 35 ms with at least 6
   iterations) with the background complete-factor-graph BA up to 64
   keyframes, then `finish()` and the final BA: the same checks, and a
   background full BA must have been synchronised, the worker must have
   stopped, and the words the worker computed on its stream for a keyframe
   must equal the CPU's;
9. the flagship on the same frames: tools/slam_bench.py's configuration as
   written (the deferred fused frontend at depth 1, asynchronous loop
   closure, the budget controller), then `finish()` and the final BA: the
   checks of phase 8 (a background pose graph synchronised), every
   `frontend_dispatch` free of host syncs under
   `torch.cuda.set_sync_debug_mode`, the fused kernel's results at the
   association's call sites equal to its plain version on the same inputs,
   and the first frames equal to those of the same run on the CPU; it prints
   the wait on the critical block, the descriptor blocks still in flight
   when folded in, the iteration budget and the frame times;
10. the matrix-free PCG pose-graph solver on drifted circles with loop
   edges at 300 and 1000 nodes: the card's poses within 1e-6 of the CPU's,
   and its time per solve;
11. semantic keypoint weighting: 16 frames at 10 Hz of tests/test_adversarial.py's
   textured world and circuit at the flagship's camera (752x480, rendered
   in the background process meanwhile) through the flagship configuration
   twice, weighting off and "net": both online ATEs at most 0.45 m, the
   "net" one at most 1.15 x the "off" one + 0.02 m and within 1e-3 m of the
   JAX pipeline's on the CPU (`JAX_SEG`), the association 4 launches a
   frame, the fourth column only {1, 3, 5} with some keypoints above 1;
   FastSCNN on the card against the CPU on frame 0 (logits within 1e-4,
   classes equal at every keypoint whose top two are clear of that); it
   prints the weights against the renderer's class maps, the frame times,
   the peak memory and FastSCNN's time;
12. the trainers: `train_segmentation`, `train_stereo` and `train_mvs` run
   10 steps each at their default sizes on cuda:0 from small pools: losses
   finite and falling from the first 3 steps to the last 3, the artifact
   loads through the port's loader, one step's loss and gradients on the
   card within 1e-4 relative and 1e-3 of each gradient's largest entry of
   the CPU's from the same weights and batch; `train_vocab` on 20,000
   descriptors: the tree and the assignments on the card equal to the
   CPU's on the same descriptors; it prints the seconds a step and the peak
   memory.

Every phase fails on an ERROR record logged by any thread (the background
workers log and carry on, as in the JAX package).  The second-to-last line
is a JSON object describing the kernels; the last line is
`{"ok": true, "device": {...}}`.  Any failure raises, and the script exits
non-zero without printing a result.
"""

import contextlib
import json
import logging
import multiprocessing
import subprocess
import sys
import threading
import time
import types
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np

# association (704x704, 704x1024), vocabulary branches and leaves (704x64,
# 704x4096), loop matching against three candidates (704x2112)
SHAPES = [(1, 1), (37, 53), (257, 513), (704, 64), (704, 704), (704, 1024), (704, 2112),
          (704, 4096), (768, 16384)]
TIMED = [(704, 64), (704, 704), (704, 1024), (704, 2112), (704, 4096), (768, 16384)]
MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# NVIDIA's table of arithmetic instruction throughput, compute capability 9.0
POPC_PER_CLOCK_PER_SM = 16
GRAPH_LAUNCHES = 100
N_FRAMES = 8  # the VIO phase: 0.4 s of the sequence (12 until the LiDAR phase came)
# the loop-closure phases: a lap of the 0.8 m circuit (1 rad/s) is about 125
# frames; the flagship records keyframes more sparsely and a call later, and
# gets the frames of the next keyframes after the lap as well
LC_FRAMES = {"synchronous": 128, "asynchronous": 128, "flagship": 150}
# the body starts at rest, as the estimator's stationary initialisation assumes
SMALL_CIRCUIT = dict(radius=0.8, speed=0.8, speed_mod=-1.0 / (2 * np.pi * 0.07))
ATE_LIMIT_M = 0.25
CPU_FRAMES = 3
CPU_GPU_TOL_M = 1e-3
# the estimator of tools/slam_bench.py; the flagship adds the realtime budget
BASE_EST = dict(cap_landmarks=1024, cap_obs=8192, max_iterations=10, early_exit_rel=5e-4)
FLAGSHIP_EST = dict(realtime_time_limit=0.035, min_iterations=6)
# tools/slam_bench.py's pipeline (the JAX defaults leave
# async_place_recognition and pipelined_solve on) ...
FLAGSHIP_PIPE = dict(do_loop_closures=True, async_loop_closure=True, pose_refine=False,
                     deferred_frontend=True, pipeline_depth=1)
# ... and the loop-closure phases before it
LC_PIPES = {
    "synchronous": dict(do_loop_closures=True, async_place_recognition=False,
                        async_loop_closure=False, pose_refine=False, pipelined_solve=False),
    "asynchronous": FLAGSHIP_PIPE | dict(deferred_frontend=False, full_ba_threshold=64),
    "flagship": FLAGSHIP_PIPE,
}
LC_ESTS = {"synchronous": {}, "asynchronous": FLAGSHIP_EST, "flagship": FLAGSHIP_EST}
# the segmentation phase: tests/test_adversarial.py's textured world (10
# distractor clusters, 14 panels, 8 clouds) and circuit (radius 6 m at
# 1.5 m/s, density 16, seed 21) seen by the flagship's camera, 16 frames at
# 10 Hz, run by the flagship's configuration with the weighting off and on
SEG_FRAMES = 16
SEG_DATA = dict(duration=0.3 + (SEG_FRAMES - 0.5) / 10.0, frame_rate=10.0, imu_rate=200.0,
                width=752, height=480, fx=460.0, density=16.0, seed=21, trajectory="circuit",
                world="textured", world_kwargs=dict(n_distractors=10, n_panels=14, n_clouds=8),
                traj_kwargs=dict(radius=6.0, speed=1.5))
SEG_ATE_LIMIT_M = 0.45  # tests/test_adversarial.py's bound on the textured world
# the JAX pipeline's online ATE on the same frames on the CPU, weighting off
# and "net" (python tests/test_torch_segmentation.py)
JAX_SEG = dict(off=0.016391158917286278, net=0.01795078901483427)
SEG_JAX_TOL_M = 1e-3
SEG_LOGIT_TOL = 1e-4  # FastSCNN on the card against the CPU, float32 without TF32
SEG_STAGES = ("2.0 PrefetchWait", "2.2 FrontDispatch", "2.3 AssocConsume", "2.5 CollectSolve",
              "2.9 Marginalise")
# the trainers phase: each trainer's `main` for TRAIN_STEPS steps at its
# default image size from a pool of TRAIN_POOL; the vocabulary from VOCAB_N
# descriptors; one step's loss and gradients on the card against the CPU's
TRAIN_STEPS = 10
TRAIN_POOL = dict(segmentation=8, stereo=8, mvs=2)  # the MVS loss is too noisy over 8 in 10 steps
VOCAB_N = 20000
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3  # of each gradient's largest entry
# the multi-session phase: session B runs this many frames from a world frame
# 1.5 m lateral and 0.1 rad of yaw off session A's (tests/test_multisession.py);
# 12 until the LiDAR phase came
MS_FRAMES = 8
MS_OFFSET = (1.5, 0.1)
MS_POS_TOL_M, MS_ROT_TOL_RAD = 0.2, 0.05
# the app phase: this many frames of the 0.8 m circuit written as a dataset
# (the app runs the JAX app's estimator, 10 LM iterations without early
# exit: 1.7-3 s a frame on the card; 12 frames since the LiDAR phase came,
# 20 before, to keep the script near its length before that phase)
APP_FRAMES = 12
# the bag-replay phase: the app phase's dataset as a ROS1 and a ROS2 bag on
# these topics, replayed by the synchronous node; the ROS2 bag's first
# BAG_ROS2_FRAMES frames are held to the ROS1 run's within BAG_ROS2_TOL_M
BAG_CAM_TOPICS = ("/cam0/image_raw", "/cam1/image_raw")
BAG_IMU_TOPIC = "/imu0"
BAG_ROS2_FRAMES = 4
BAG_ROS2_TOL_M = 1e-6
# the JAX node on the same ROS1 bag on the CPU: `python tests/test_torch_node.py`
JAX_NODE = dict(ate_online_m=0.0018682588888909919, ate_final_m=0.0007842064953928203,
                n_frames=12, n_final=6)
# the node's online and final ATE are also held within this of JAX_NODE's
JAX_NODE_TOL_M = 1e-3
# the live-nodes phase: the network node on the app phase's dataset under the
# JAX node's `main` defaults (EstimatorConfig(), PipelineConfig(), 32
# disparities, prefix "okvis"); its online ATE within JAX_NODE_TOL_M of the
# JAX network node's on the same messages on the CPU (`python
# tests/test_torch_network_node.py`) and at most twice it (floor 0.05 m);
# frame 0's census depth on the card within NETWORK_DEPTH_TOL_M of the CPU's
# on at least NETWORK_DEPTH_SHARE of the pixels
NETWORK_MAX_DISP = 32
NETWORK_PREFIX = "okvis"
JAX_NETWORK_NODE = dict(ate_online_m=0.006739173725338425, n_odometry=12, n_depth=12,
                        n_sigma=12)
NETWORK_DEPTH_TOL_M = 1e-3
NETWORK_DEPTH_SHARE = 0.999
# the GNSS phase: the first 24 frames (1.2 s; 30 until the LiDAR phase came, 40
# until the RGB-D phase came) of the flagship circuit with a 5 Hz GNSS stream in
# a frame yawed by 0.4 rad and moved by (30, -12, 4) m, as
# tools/gnss_scale_run.py writes it, and online extrinsics calibration on
# ("Initialised" at frame 19 in the JAX app)
GNSS_FRAMES = 24
GNSS_DATA = dict(frame_rate=20.0, imu_rate=200.0, width=752, height=480, fx=460.0,
                 density=22.0, seed=3, scene_version=2, trajectory="circuit", with_gps=True,
                 gps_rate=5.0, gps_sigma=0.05)
TRUE_YAW_G = 0.4
TRUE_T_G = np.array([30.0, -12.0, 4.0])
# the JAX app on the same 24 frames on the CPU (`python tests/test_torch_gps.py`,
# PERF.md section 4): the T_GW errors against the generator's alignment, as
# tools/gnss_scale_run.py measures them (deg, m) and carried into the
# estimator's world frame (`tgw_error_local`), and the global ATE online and
# after the final BA (m); the port is held to twice these, with floors of 1
# degree and 0.05 m
JAX_GNSS = dict(yaw_deg=94.08829469364959, t_m=7.983025679623287,
                local_yaw_deg=0.0701622322293706, local_t_m=0.16333174008165138,
                ate_global_online_m=0.09895696820758274,
                ate_global_final_m=0.14606159199777566)
# the RGB-D phase: the first 16 frames (0.8 s) of the 0.8 m circuit at the
# EuRoC operating point with cam0's depth0/ stream, through the app in rgbd
# mode (3 keyframes, 1 of them fused, in the JAX app); then the depth mode
# with cam0 an rgb camera on 32 frames of the sinusoid scene at the same
# operating point, where every frame is a keyframe, under DEPTH_SE2: the
# dense 128^3 grid at 0.2 m of the default config with submaps of up to 50
# keyframes, since a voxel passes map.ply's log-odds 1.0 only after about 20
# integrations of its surface and the default 20-keyframe submaps close
# before more than a few do (in the JAX app too)
RGBD_FRAMES = 16  # 20 until the LiDAR phase came
DEPTH_FRAMES = 32  # 40 until the LiDAR phase came
DEPTH_DATA = {
    "rgbd": dict(frame_rate=20.0, imu_rate=200.0, width=752, height=480, fx=460.0,
                 density=22.0, seed=3, scene_version=2, trajectory="circuit", with_depth=True,
                 traj_kwargs=SMALL_CIRCUIT),
    "depth": dict(frame_rate=20.0, imu_rate=200.0, width=752, height=480, fx=460.0,
                  density=22.0, seed=3, scene_version=2, trajectory="sinusoid"),
}
DEPTH_SE2 = """general:
  submap_kf_threshold: 50
  submap_overlap_ratio: 0.1
  submap_min_frames: 4
  depth_image_resolution_downsampling: 4
  far_plane: 20.0
map:
  dim: [25.6, 25.6, 25.6]
  res: 0.2
"""
# the JAX app on the same frames on the CPU (`python tests/test_torch_depth.py
# rgbd 16` and `... depth 32`, PERF.md section 4): ATEs (m), keyframes
# integrated, map.ply's points, `grid_stats`; the port is held to twice the
# ATEs (floor 0.05 m), at least as many keyframes, the point count within
# MAP_POINTS_TOL and the grids within GRID_TOL
JAX_DEPTH = {
    "rgbd": dict(ate_online_m=0.002487772594713386, ate_final_m=0.0010607450528058444,
                 n_integrated=1, map_points=0, n_submaps=1,
                 total_weight=1263360.0, logodds_sum=-286.2161221512233,
                 observed_voxels=32770, positive_voxels=7979,
                 voxels_above_1=0),
    "depth": dict(ate_online_m=0.09505728817245675, ate_final_m=0.010245855409509785,
                  n_integrated=32, map_points=198, n_submaps=1,
                  total_weight=39996223.0, logodds_sum=-23412.885030523226,
                  observed_voxels=131106, positive_voxels=36281,
                  voxels_above_1=198),
}
# the fine-grid run: the depth mode's se2.yaml at the reference's 0.025 m
# (config/euroc/se2.yaml: 25.6 m at 0.025 m, 1024^3), so a brick-sparse grid of
# a 128^3 table and 8192 bricks (8 MiB of table, 32 MiB of pool a submap), on
# the first FINE_FRAMES frames of the depth phase's dataset
FINE_FRAMES = 8
FINE_SE2 = DEPTH_SE2.replace("res: 0.2", "res: 0.025")
# the JAX app on the same frames on the CPU (`python tests/test_torch_depth.py
# fine 8`, PERF.md section 4): ATEs (m), keyframes, map.ply, `grid_stats`
# with the bricks allocated; the port is held to twice the ATEs (floor
# 0.05 m), the bricks and the grids within GRID_TOL and the points within
# MAP_POINTS_TOL
# (the view of the sinusoid scene at 752x480 touches more bricks than the pool
# holds within four keyframes: the first submap fills its 8192 bricks, the
# overlap test then finds its points in unallocated bricks and starts a
# second, which fills too; no voxel of the capped pools reaches map.ply's 1.0)
JAX_FINE = dict(ate_online_m=0.10472332955850064, ate_final_m=0.10422893980224059,
                n_integrated=8, map_points=0, n_submaps=2, bricks=16384,
                total_weight=568568.0, logodds_sum=-2455.0247183618194,
                observed_voxels=505824, positive_voxels=90526, voxels_above_1=0)
MAP_POINTS_TOL = 0.05
# the fine run's export: no voxel of its capped pools reaches map.ply's 1.0,
# so the app's occupied-voxel export (the occupied list over the pools, the
# colours through the table) is also written at log-odds 0, the voxels with
# surface evidence, and held to the JAX app's (JAX_FINE_EXPORT): the points
# and each EXPORT_CELL_M cube's count within MAP_POINTS_TOL, their mean
# position within EXPORT_MEAN_TOL_M and their mean colour within
# EXPORT_RGB_TOL of 255
FINE_EXPORT_THRESHOLD = 0.0
EXPORT_CELL_M = 2.0
EXPORT_MEAN_TOL_M = 0.01
EXPORT_RGB_TOL = 1.0
# the JAX app's export (`python tests/test_torch_depth.py fine 8`)
JAX_FINE_EXPORT = dict(
    export_points=90526,
    export_mean_m=[-7.371186702162934, -0.4045566224068224, 8.912093503523803],
    export_rgb_mean=[122.28949694010561, 122.28949694010561, 122.28949694010561],
    export_cells={
        "-7,-5,5": 26, "-6,-5,5": 80, "-6,-5,6": 13, "-6,-4,4": 122, "-6,-4,5": 141,
        "-6,-3,4": 176, "-6,-3,5": 9, "-6,-2,4": 3, "-6,-2,5": 5, "-6,0,5": 6, "-6,1,5": 106,
        "-6,2,5": 379, "-6,3,5": 50, "-6,3,6": 6, "-5,-5,5": 9, "-5,-4,4": 996, "-5,-4,5": 266,
        "-5,-3,3": 323, "-5,-3,4": 2783, "-5,-3,5": 320, "-5,-3,6": 6, "-5,-2,3": 42,
        "-5,-2,4": 1601, "-5,-2,5": 229, "-5,-2,6": 20, "-5,-1,4": 966, "-5,-1,5": 395,
        "-5,0,4": 1156, "-5,0,5": 579, "-5,1,4": 2616, "-5,1,5": 680, "-5,2,4": 3026,
        "-5,2,5": 426, "-5,3,5": 20, "-5,3,6": 6, "-4,-4,4": 315, "-4,-4,5": 2, "-4,-3,3": 442,
        "-4,-3,4": 9248, "-4,-3,5": 66, "-4,-2,3": 1159, "-4,-2,4": 11228, "-4,-2,5": 108,
        "-4,-1,3": 397, "-4,-1,4": 14978, "-4,-1,5": 86, "-4,0,3": 319, "-4,0,4": 14355,
        "-4,0,5": 89, "-4,1,3": 854, "-4,1,4": 12772, "-4,1,5": 18, "-4,2,3": 72,
        "-4,2,4": 4704, "-4,2,5": 49, "-3,-4,4": 10, "-3,-3,3": 74, "-3,-3,4": 569,
        "-3,-2,3": 31, "-3,-2,4": 398, "-3,-1,3": 12, "-3,-1,4": 424, "-3,-1,5": 1,
        "-3,0,3": 1, "-3,0,4": 158})
GRID_TOL = 0.01  # the grids' counts and voxel sets (grid_stats) against the JAX app's
FUSED_TOL_M = 1e-3  # the card's fused keyframe depth against the CPU's
FUSED_MASK_TOL = 1e-3
COMPARE_EVERY = 16  # flagship frames between two holds of the kernel against its plain version
# the LiDAR phase: the EuRoC operating point on tools/lidar_scale_run.py's
# circuit (the 8 m circuit of tools/slam_bench.py) with that tool's hall
# sweeps in lidar0/ (`make_sweep`), through the app in lidar mode under
# LIDAR_SE2: the tool's submaps (128^3 at 0.2 m, 200 alignment points, sigma
# 0.4, 4 frames at least) but 5 keyframes a submap instead of 20, so that
# three submaps, and with them a map-to-map edge, form within the phase
# the app runs LIDAR_FRAMES frames of a dataset of LIDAR_DATASET_FRAMES: in the
# JAX app on these files the third submap, and with it the map-to-map edge,
# comes after frame 27, and no fourth submap by frame 40 (`python
# tests/test_torch_lidar.py 40`, PERF.md section 4), so the phase stops 2
# frames after the edge (the generator's noise, and with it when the edge
# comes, depends on the dataset's length); 33 frames in its first runs
LIDAR_FRAMES = 29
LIDAR_DATASET_FRAMES = 40
LIDAR_DATA = dict(frame_rate=20.0, imu_rate=200.0, width=752, height=480, fx=460.0,
                  density=22.0, seed=3, scene_version=2, trajectory="circuit")
HALL_R_WALL, HALL_Z_FLOOR, HALL_Z_CEIL = 13.0, -1.6, 4.2
RAYS_PER_SWEEP = 512
SWEEP_PERIOD = 0.1
FIRST_SWEEP_T = 0.4
LIDAR_SE2 = """general:
  submap_kf_threshold: 5
  submap_overlap_ratio: 0.1
  submap_min_frames: 4
  n_factors_per_state: 200
  sensor_error: 0.4
  depth_image_resolution_downsampling: 4
  far_plane: 20.0
map:
  dim: [25.6, 25.6, 25.6]
  res: 0.2
data:
  log_odd_min: -5.0
  log_odd_max: 5.0
"""
# the JAX app on the same frames on the CPU (`python tests/test_torch_lidar.py`,
# PERF.md section 4): `lidar_metrics`; the port is held to twice the online
# ATE (floor 0.05 m), the same submaps, map-to-map edges and sweeps
# integrated, map.ply's points within MAP_POINTS_TOL and the grids within
# GRID_TOL
JAX_LIDAR = dict(ate_online_m=0.05850813930520451, ate_final_m=0.0037044382539067997,
                 n_sweeps=13, n_integrated=13, n_live=10, n_align=1,
                 map_points=375, n_submaps=3, total_weight=271519.0,
                 logodds_sum=-29308.65023827355, observed_voxels=86474,
                 positive_voxels=4572, voxels_above_1=375)
# the drift-recovery scenario of tests/test_lidar_vio.py on the card, held
# to the CPU's final pose
DRIFT_CPU_TOL_M = 1e-6
PCG_NODES = (300, 1000)
PCG_ITERATIONS = 15  # PipelineConfig.full_graph_iterations
PCG_TOL = 1e-6


class ErrorRecords(logging.Handler):
    """Keeps every ERROR record logged by any thread: a background worker
    that fails logs and carries on, and the run must not."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def check(self, phase):
        if self.records:
            msgs = "; ".join(f"[{r.threadName}] {r.getMessage()}" for r in self.records)
            raise RuntimeError(f"{phase}: {len(self.records)} error records: {msgs}")


ERRORS = ErrorRecords()


def random_words(rng, n):
    """(n, 12) int32 words with the all-ones and sign-bit patterns mixed in."""
    w = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    w[rng.random((n, 12)) < 0.05] = 0xFFFFFFFF
    w[rng.random((n, 12)) < 0.05] = 0x80000000
    return w.view(np.int32)


def tied_words(rng, nq, nd):
    """Queries and a database with duplicated rows on both sides and shared
    rows between them, so that ties occur on both axes."""
    q, d = random_words(rng, nq), random_words(rng, nd)
    d[nd // 2:nd // 2 + nd // 8] = d[:nd // 8]
    q[nq // 2:nq // 2 + nq // 8] = q[:nq // 8]
    q[:min(nq, nd) // 4] = d[:min(nq, nd) // 4]
    return q, d


def time_ms(fn, reps):
    """Time of a Python call of `fn`, CUDA events around `reps` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def peak_mib(fn):
    """Device memory that one call of `fn` allocates at its peak above what
    was allocated before it (MiB; cuDNN's and cuBLAS's workspaces included)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**20


def device_ms(fn, launches=GRAPH_LAUNCHES, replays=5):
    """Device time of one call of `fn`: `launches` calls captured in a CUDA
    graph, the replay timed with CUDA events (no host work between the
    kernels); the median of `replays`.  Every capture uses one stream, so
    that cuBLAS keeps one workspace for the library yardstick and not one a
    capture."""
    import torch

    if device_ms.stream is None:
        device_ms.stream = torch.cuda.Stream()
    side = device_ms.stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the stream the first call ran on
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


device_ms.stream = None


def popc_per_s():
    """The card's popcount rate: 16 a clock on each SM at the maximum SM clock."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6, sms, mhz


def bound(n_bytes, n_popc, rate):
    """(bound in ms, what sets it): bytes once over the memory rate against
    popcounts over the popcount rate."""
    t_bytes, t_ops = n_bytes / MEMORY_BYTES_PER_S, n_popc / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def unpack_pm1(packed):
    """(N, 384) bfloat16 +-1 rows of packed descriptors (the JAX matcher's
    operands), for the library yardstick only."""
    import torch

    bits = (packed[:, :, None] >> torch.arange(32, device=packed.device)) & 1
    return (bits.reshape(packed.shape[0], -1) * 2 - 1).to(torch.bfloat16)


def match_forms(rng, dev):
    """The fused kernel's call in the form of each site, as (name, q, vq, d,
    vd, keywords)."""
    import torch

    def flags(n, p=0.15):
        return torch.from_numpy(rng.random(n) > p).to(dev)

    def make(nq, nd, validity=True, allowed=False, row_seg=None, **kw):
        q, d = (torch.from_numpy(x).to(dev) for x in tied_words(rng, nq, nd))
        vq, vd = (flags(nq), flags(nd)) if validity else (None, None)
        if allowed:
            kw["allowed"] = torch.from_numpy(rng.random((nq, nd)) > 0.4).to(dev)
        if row_seg:
            kw["row_seg"] = torch.from_numpy(
                rng.integers(0, nd // kw["seg"], nq).astype(np.int32)).to(dev)
        return q, vq, d, vd, kw

    matcher_fills = dict(fill_invalid=192, fill_disallowed=384)
    forms = [
        ("stereo 704x704", *make(704, 704, allowed=True, **matcher_fills)),
        ("map matching 704x1024", *make(704, 1024, allowed=True, **matcher_fills)),
        ("motion stereo, mutual 704x704",
         *make(704, 704, allowed=True, want_cols=True, **matcher_fills)),
        ("mutual, 385 fills 300x700", *make(300, 700, fill_invalid=385, want_cols=True)),
        ("loop matching, 3 segments 704x2112",
         *make(704, 2112, seg=704, fill_invalid=10 ** 9, want_cols=True)),
        ("vocabulary branches 704x64", *make(704, 64, validity=False)),
        ("vocabulary leaves, row_seg 704x4096",
         *make(704, 4096, validity=False, seg=64, row_seg=True)),
        ("all leaves 704x4096", *make(704, 4096, validity=False)),
        # the multi-session phase: k-means assignment of session A's
        # descriptors to 256 centres; the relocalisation's mutual match is
        # the form "mutual, 385 fills" at 704x704
        ("vocabulary training 20000x256", *make(20000, 256, validity=False)),
        ("reloc mutual, 385 fills 704x704", *make(704, 704, fill_invalid=385, want_cols=True)),
        ("one cell 1x1", *make(1, 1, allowed=True, want_cols=True, **matcher_fills)),
        ("ragged 37x53", *make(37, 53, allowed=True, want_cols=True, **matcher_fills)),
        ("ragged, unaligned mask 257x513",
         *make(257, 513, allowed=True, seg=171, want_cols=True, fill_invalid=600,
               fill_disallowed=600)),
        ("ragged, row_seg 257x513", *make(257, 513, seg=27, row_seg=True, fill_invalid=385)),
        ("large 768x16384", *make(768, 16384, fill_invalid=385, want_cols=True)),
    ]
    forms[4][4][704:1408] = False  # the second loop candidate is an empty slot
    return forms


def check_on_worker_stream(forms):
    """The fused kernel in the forms of the place-recognition worker's sites
    (vocabulary descent, loop matching), launched from a second host thread
    on a CUDA stream of its own, against its plain version; returns the
    largest difference (0)."""
    import torch
    from okvis2x_tpu_torch.ops import hamming

    sites = ("vocabulary branches 704x64", "vocabulary leaves, row_seg 704x4096",
             "loop matching, 3 segments 704x2112")
    done, errors = [], []

    def work():
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.default_stream())  # the inputs' copies
            with torch.cuda.stream(stream):
                for name, q, vq, d, vd, kw in forms:
                    if name not in sites:
                        continue
                    got = hamming.hamming_match(q, vq, d, vd, **kw)
                    ref = hamming.hamming_match_plain(q, vq, d, vd, **kw)
                    stream.synchronize()
                    for g, r in zip(got, ref):
                        if (g is None) != (r is None) or (g is not None and not torch.equal(g, r)):
                            raise RuntimeError(
                                f"hamming match != plain on a worker stream ({name})")
                    done.append(name)
        except Exception as e:  # noqa: BLE001 — raised on the main thread below
            errors.append(e)

    t = threading.Thread(target=work, name="kernel-check")
    t.start()
    t.join()
    if errors:
        raise errors[0]
    if len(done) != len(sites):
        raise RuntimeError(f"the worker-stream check ran {done}, expected {sites}")
    print(f"hamming match from a second thread on its own stream: {len(done)} worker-site "
          "forms == plain, exact")
    return 0


def matrix_bytes_popc(nq, nd):
    return 48 * (nq + nd) + 4 * nq * nd, 12 * nq * nd


def match_bytes_popc(q, vq, d, vd, kw):
    """Bytes the fused call must move (inputs once, outputs once) and the
    popcounts it needs on these inputs."""
    nq, nd = q.shape[0], d.shape[0]
    seg = kw.get("seg") or nd
    n_bytes = 48 * nq + (0 if vq is None else nq) + (0 if vd is None else nd)
    if "row_seg" in kw:  # a row reads only its segment
        rows = int(kw["row_seg"].unique().numel()) * seg
        return n_bytes + 48 * rows + 4 * nq + 12 * nq, 12 * nq * seg
    n_bytes += 48 * nd + (nq * nd if "allowed" in kw else 0)
    n_bytes += 12 * nq * (nd // seg) + (8 * nd if kw.get("want_cols") else 0)
    return n_bytes, 12 * nq * nd


def check_kernels(dev, card):
    """Both kernels against their plain versions, exactly; then their times
    at the TIMED shapes.  Returns {kernel name: entry of the `kernels` line}."""
    import torch
    from okvis2x_tpu_torch.ops import hamming

    rng = np.random.default_rng(0)
    rate, sms, mhz = popc_per_s()
    print(f"popcount rate {rate:.3e}/s ({POPC_PER_CLOCK_PER_SM} a clock x {sms} SMs x "
          f"{mhz:.0f} MHz), memory {MEMORY_BYTES_PER_S:.3e} B/s")

    # ---- the matrix kernel
    matrix_err = 0
    for nq, nd in SHAPES:
        q = torch.from_numpy(random_words(rng, nq)).to(dev)
        d = torch.from_numpy(random_words(rng, nd)).to(dev)
        k = hamming.hamming_matrix_packed(q, d)
        p = hamming.hamming_matrix_plain(q, d)
        torch.cuda.synchronize()
        err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
        if not torch.equal(k, p):
            raise RuntimeError(f"hamming kernel != plain at {nq}x{nd}: max err {err}")
        matrix_err = max(matrix_err, err)
        if (nq, nd) == (37, 53):
            qn, dn = q.cpu().numpy().view(np.uint32), d.cpu().numpy().view(np.uint32)
            ref = np.unpackbits((qn[:, None] ^ dn[None]).view(np.uint8), axis=-1)
            if not np.array_equal(k.cpu().numpy(), ref.reshape(nq, nd, -1).sum(-1)):
                raise RuntimeError("hamming kernel != numpy popcount at 37x53")
        print(f"hamming matrix {nq}x{nd}: kernel == plain, exact")
    if hamming.KERNEL.build_log:
        print("nvcc:", " | ".join(l.strip() for l in hamming.KERNEL.build_log.splitlines()
                                  if "registers" in l or "spill" in l))

    # ---- the fused match kernel, in each site's form
    match_err = 0
    forms = match_forms(rng, dev)
    for name, q, vq, d, vd, kw in forms:
        got = hamming.hamming_match(q, vq, d, vd, **kw)
        ref = hamming.hamming_match_plain(q, vq, d, vd, **kw)
        torch.cuda.synchronize()
        for what, g, r in zip(("row_min", "row_arg", "col_arg"), got, ref):
            if g is None and r is None:
                continue
            err = int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
            match_err = max(match_err, err)
            if g.dtype != r.dtype or not torch.equal(g, r):
                raise RuntimeError(f"hamming match != plain ({name}): {what} max err {err}")
        print(f"hamming match, {name}: kernel == plain, exact"
              + (" (minima of 1e9 present)" if int(got[0].max()) == 10 ** 9 else ""))
    match_err = max(match_err, check_on_worker_stream(forms))

    # ---- times.  The library yardstick is the JAX matcher's formulation:
    # one bf16 matmul of the +-1 rows, then (384 - dot) / 2 (and one min over
    # the rows for the match); the unpacking is done before the clock starts.
    entries = {}
    by_name = {f[0]: f[1:] for f in forms}
    timed_forms = {
        (704, 64): "vocabulary branches 704x64", (704, 704): "motion stereo, mutual 704x704",
        (704, 1024): "map matching 704x1024", (704, 2112): "loop matching, 3 segments 704x2112",
        (704, 4096): "all leaves 704x4096", (768, 16384): "large 768x16384",
    }
    rows = [("matrix", shape, None) for shape in TIMED]
    rows += [("match", shape, timed_forms[shape]) for shape in TIMED]
    rows.append(("match", (704, 4096), "vocabulary leaves, row_seg 704x4096"))
    # the launch floor: an empty kernel launched as the kernels are (ctypes, the
    # current stream), one of GRAPH_LAUNCHES in a CUDA graph
    floor = lambda: hamming.empty_launch(dev)  # noqa: E731
    t_floor = min(device_ms(floor), device_ms(floor))
    print(f"times in ms on {card}; device = one of {GRAPH_LAUNCHES} launches in a CUDA graph, "
          "call = a Python call, share = bound / device, floor = an empty kernel's device time "
          f"launched the same way: {t_floor:.5f}")
    for kind, (nq, nd), form in rows:
        if kind == "matrix":
            q = torch.from_numpy(random_words(rng, nq)).to(dev)
            d = torch.from_numpy(random_words(rng, nd)).to(dev)
            run = lambda: hamming.hamming_matrix_packed(q, d)  # noqa: E731
            plain = lambda: hamming.hamming_matrix_plain(q, d)  # noqa: E731
            n_bytes, n_popc = matrix_bytes_popc(nq, nd)
            label = f"hamming matrix {nq}x{nd}"
        else:
            q, vq, d, vd, kw = by_name[form]
            run = lambda: hamming.hamming_match(q, vq, d, vd, **kw)  # noqa: E731
            plain = lambda: hamming.hamming_match_plain(q, vq, d, vd, **kw)  # noqa: E731
            n_bytes, n_popc = match_bytes_popc(q, vq, d, vd, kw)
            label = f"hamming match, {form}"
        a, b = unpack_pm1(q), unpack_pm1(d).T.contiguous()
        if kind == "matrix":
            lib = lambda: (384 - torch.matmul(a, b)) / 2  # noqa: E731
        else:
            lib = lambda: torch.min((384 - torch.matmul(a, b)) / 2, dim=1)  # noqa: E731
        t_dev = device_ms(run)
        t_call = time_ms(run, 200)
        t_plain = time_ms(plain, 10)
        t_lib = device_ms(lib)
        t_dev = min(t_dev, device_ms(run))
        t_call = min(t_call, time_ms(run, 200))
        t_bound, by = bound(n_bytes, n_popc, rate)
        print(f"{label}: device {t_dev:.5f}, call {t_call:.5f}, plain {t_plain:.4f}, library "
              f"{t_lib:.5f}, bound {t_bound:.5f} ({by}), floor {t_floor:.5f}, share "
              f"{100 * t_bound / t_dev:.1f}%")
        if (nq, nd) == (704, 1024):  # the shape of the `kernels` line
            entries[kind] = dict(ms=t_call, device_ms=t_dev, plain_ms=t_plain, bound_ms=t_bound,
                                 bound_by=by, library_ms=t_lib, launch_floor_ms=t_floor)
    entries["matrix"]["max_abs_err"] = matrix_err
    entries["match"]["max_abs_err"] = match_err
    return entries


def match_masked_on_matrix(packed_a, valid_a, packed_b, valid_b, allowed):
    """`matcher.match_masked` as it was composed on the matrix kernel: kept
    here for the comparison of the site's time only."""
    import torch
    from okvis2x_tpu_torch.frontend import matcher

    D = matcher.hamming_matrix(packed_a, valid_a, packed_b, valid_b)
    D = torch.where(allowed, D, torch.full_like(D, float(matcher.DESC_BITS)))
    idx = torch.argmin(D, dim=1)
    d1 = torch.gather(D, 1, idx[:, None])[:, 0]
    return idx, d1, d1 <= 60.0


def assign_packed_on_matrix(packed, valid, vocab):
    """`bow.assign_packed` as it was composed on the matrix kernel: kept here
    for the comparison of the site's time only."""
    import torch
    from okvis2x_tpu_torch.ops import hamming

    d1 = hamming.hamming_matrix_packed(packed, vocab.branches)
    b = torch.argmin(d1, dim=1)
    d2 = hamming.hamming_matrix_packed(packed, vocab.leaves)
    leaf_branch = torch.arange(d2.shape[1], device=d2.device) // vocab.L
    d2 = torch.where(leaf_branch[None, :] == b[:, None], d2,
                     torch.full_like(d2, hamming.DESC_BITS + 1))
    w = torch.argmin(d2, dim=1)
    return torch.where(valid, w, torch.zeros_like(w))


def time_sites(dev, card):
    """The two sites as a whole, composed on the matrix kernel (before) and
    on the fused kernel (after): same results, device and Python-call time."""
    import torch
    from okvis2x_tpu_torch.frontend import bow, matcher

    rng = np.random.default_rng(1)
    q, d = (torch.from_numpy(x).to(dev) for x in tied_words(rng, 704, 1024))
    vq = torch.from_numpy(rng.random(704) > 0.15).to(dev)
    vd = torch.from_numpy(rng.random(1024) > 0.15).to(dev)
    allowed = torch.from_numpy(rng.random((704, 1024)) > 0.4).to(dev)
    vocab = bow.HierVocabulary.load(device=dev)
    sites = {
        "matcher.match_masked 704x1024": (
            lambda: match_masked_on_matrix(q, vq, d, vd, allowed),
            lambda: tuple(matcher.match_masked(q, vq, d, vd, allowed, max_dist=60.0))),
        "bow.assign_packed 704": (
            lambda: (assign_packed_on_matrix(q, vq, vocab),),
            lambda: (bow.assign_packed(q, vq, vocab),)),
    }
    for name, (before, after) in sites.items():
        for x, y in zip(before(), after()):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise RuntimeError(f"{name}: the fused composition differs from the old one")
        t = [device_ms(before), device_ms(after), device_ms(after), device_ms(before)]
        c = [time_ms(before, 100), time_ms(after, 100), time_ms(after, 100),
             time_ms(before, 100)]
        print(f"site {name}: on the matrix kernel device {min(t[0], t[3]):.5f} ms, call "
              f"{min(c[0], c[3]):.5f} ms; on the fused kernel device {min(t[1], t[2]):.5f} ms, "
              f"call {min(c[1], c[2]):.5f} ms; same results ({card})")


def render(n_frames, **traj_kwargs):
    """`n_frames` frames of the circuit at the EuRoC operating point."""
    from okvis2x_tpu_torch.io import synthetic

    seq = synthetic.render_sequence(
        duration=0.3 + n_frames / 20.0, frame_rate=20.0, imu_rate=200.0, width=752,
        height=480, fx=460.0, density=22.0, seed=3, trajectory="circuit", scene_version=2,
        traj_kwargs=traj_kwargs,
    )
    if len(seq.frame_t) < n_frames:
        raise RuntimeError(f"rendered {len(seq.frame_t)} frames, need {n_frames}")
    return seq


def seg_sequence():
    """The segmentation phase's frames, with cam0's class maps."""
    from okvis2x_tpu_torch.io import synthetic

    seq = synthetic.render_sequence(**SEG_DATA, with_classmap=True)
    if len(seq.frame_t) != SEG_FRAMES:
        raise RuntimeError(f"rendered {len(seq.frame_t)} frames, need {SEG_FRAMES}")
    return seq


def run_pipeline(seq, device, n_frames, record_times=False, est_kw=(), pipe_kw=(), wrap=None):
    """Feed `n_frames` frames of `seq` to a fresh VioPipeline on `device`:
    the estimator of tools/slam_bench.py updated with `est_kw`, the JAX
    package's default PipelineConfig at 704 keypoints updated with
    `pipe_kw`; then `finish()`.  `wrap(vio)` may instrument the pipeline
    before the first frame.  Returns (pipeline, frame infos, wall time a
    frame, iterations of each pipelined window solve when it was built, wall
    time of finish, the wait on the critical block a frame)."""
    import torch
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline
    from okvis2x_tpu_torch.utils import timing

    c = seq.camera
    cam = pinhole.make_pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                               model=c["model"], dist_params=c["dist_params"],
                               dtype=torch.float64, device=device)
    est_cfg = EstimatorConfig(**(BASE_EST | dict(est_kw)))
    pipe_cfg = PipelineConfig(**(dict(max_keypoints=704) | dict(pipe_kw)))
    # on the card through the default device, as a user calls it
    on_cpu = dict(device=device) if device.type == "cpu" else {}
    vio = VioPipeline([cam, cam], seq.T_SC, est_cfg, pipe_cfg, **on_cpu)
    if wrap is not None:
        wrap(vio)
    infos, wall, iters, waits = [], [], [], []
    n = 0
    for kind, data in seq.events():
        if kind == "imu":
            vio.add_imu_measurement(*data)
            continue
        if n >= n_frames:
            break
        t0 = time.perf_counter()
        w0 = timing.total_s("2.0 PrefetchWait")
        infos.append(vio.process_frame(data[0], data[1]))
        if record_times and device.type == "cuda":
            torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        waits.append(timing.total_s("2.0 PrefetchWait") - w0)
        h = (vio._pending["h"] if vio._pending is not None
             else vio._inflight[-1]["solve"] if vio._inflight else None)
        if h is not None:
            iters.append(h["iters"])
        n += 1
    t0 = time.perf_counter()
    vio.finish()
    return vio, infos, wall, iters, time.perf_counter() - t0, waits


def check_positions(vio, n_frames, what):
    ts = np.array([s[0] for s in vio.states_log])
    Ts = np.stack([s[1] for s in vio.states_log])
    if len(ts) != n_frames or not np.isfinite(Ts).all():
        raise RuntimeError(f"non-finite or missing poses on the {what} path")
    return ts, Ts


def ate_checked(seq, ts, Ts, what):
    from okvis2x_tpu_torch.io import trajectory_io

    ate = trajectory_io.ate_rmse(ts, Ts[:, :3], seq.gt[:, 0], seq.gt[:, 1:4])
    if ate is None or not ate <= ATE_LIMIT_M:
        raise RuntimeError(f"{what} ATE {ate} m exceeds {ATE_LIMIT_M} m")
    return ate


def vio_cpu_positions():
    """The first CPU_FRAMES positions of the VIO phase's run on the CPU
    (plain kernel versions); with the run's seconds."""
    import torch

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    vio = run_pipeline(render(N_FRAMES), torch.device("cpu"), CPU_FRAMES)[0]
    return np.stack([s[1][:3] for s in vio.states_log]), time.perf_counter() - t0


def flagship_cpu_positions():
    """The first CPU_FRAMES positions of the flagship phase's run on the
    CPU, with the run's seconds.  One frame more is run: with the deferred
    frontend a frame's solve is built in the next call, and the last one
    only in finish(), against a window without that next frame."""
    import torch

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    vio = run_pipeline(render(max(LC_FRAMES.values()), **SMALL_CIRCUIT), torch.device("cpu"),
                       CPU_FRAMES + 1,
                       est_kw=LC_ESTS["flagship"], pipe_kw=LC_PIPES["flagship"])[0]
    return (np.stack([s[1][:3] for s in vio.states_log[:CPU_FRAMES]]),
            time.perf_counter() - t0)


def pcg_cpu_solves():
    """The PCG phase's solves on the CPU: {nodes: (poses, cost, seconds)}."""
    import torch
    from okvis2x_tpu_torch.parallel import dist_posegraph

    torch.set_num_threads(2)
    out = {}
    for K in PCG_NODES:
        *args, _ = drifted_circle(K, np.random.default_rng(K))
        t0 = time.perf_counter()
        T, cost = dist_posegraph.optimize_pose_graph_pcg(*args, iterations=PCG_ITERATIONS,
                                                         device="cpu")
        out[K] = (T, cost, time.perf_counter() - t0)
    return out


def vio_phase(dev, card, cpu_positions):
    """N_FRAMES frames of VIO on the GPU under the JAX default configuration,
    against the CPU's first frames (`cpu_positions`, a future of
    `vio_cpu_positions`), then ratio-test matching of the last two frames.
    Returns the fused kernel's launches by site and the matrix kernel's
    launches on these paths."""
    import torch
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    t0 = time.perf_counter()
    seq = render(N_FRAMES)
    print(f"rendered {N_FRAMES} frames at 752x480: {time.perf_counter() - t0:.1f} s")
    timing.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    vio, infos, wall, _, _, _ = run_pipeline(seq, dev, N_FRAMES, record_times=True)
    t_run = time.perf_counter() - t0
    launches = hamming.hamming_match.launches
    sites = dict(hamming.hamming_match.site_launches)
    on_matrix = hamming.hamming_matrix_packed.launches
    peak = torch.cuda.max_memory_allocated(dev)
    ts, Ts = check_positions(vio, N_FRAMES, "VIO")
    n_kf = sum(i["is_keyframe"] for i in infos)
    if sites.get("assoc", 0) != 4 * N_FRAMES or on_matrix != 0:
        raise RuntimeError(f"the VIO path launched the fused kernel {sites} and the matrix "
                           f"kernel {on_matrix} times over {N_FRAMES} frames; expected "
                           f"{4 * N_FRAMES} association launches and 0")
    ERRORS.check("VIO phase")
    ate = ate_checked(seq, ts, Ts, "VIO online")
    ms = np.asarray(wall) * 1e3
    counts = np.array([[i["n_map"], i["n_stereo"], i["n_motion"]] for i in infos])
    p50 = np.median(counts, axis=0)
    print(f"VIO path (JAX default PipelineConfig: pose refinement, pipelined solve, place "
          f"recognition worker): {N_FRAMES} frames in {t_run:.1f} s, dtype {vio.est.cfg.dtype}, "
          f"online ATE {ate:.4f} m, ms/frame p50 {np.percentile(ms, 50):.1f} p90 "
          f"{np.percentile(ms, 90):.1f} (first frame {ms[0]:.1f}), peak allocated "
          f"{peak / 2**20:.1f} MiB, fused match launches {launches} by site {sites} = 4 a frame "
          f"+ 2 a keyframe ({n_kf}) on the worker, matrix launches {on_matrix} ({card})")
    print(f"VIO path counts p50: map {p50[0]:.0f} stereo {p50[1]:.0f} motion "
          f"{p50[2]:.0f}; keyframes {n_kf} ({card})")
    print(timing.report())

    # the same first frames on the CPU (plain Hamming version)
    p_cpu, t_cpu = cpu_positions.result()
    gap = float(np.abs(p_cpu - Ts[:CPU_FRAMES, :3]).max())
    print(f"cpu vs gpu over {CPU_FRAMES} frames: max position gap {gap:.3e} m "
          f"(CPU run {t_cpu:.1f} s, in a process of its own)")
    if not gap <= CPU_GPU_TOL_M:
        raise RuntimeError(f"GPU and CPU runs disagree by {gap} m")
    return sites, ratio_match_phase(vio, dev)


def ratio_match_phase(vio, dev):
    """Frame-to-frame matching with Lowe's ratio test and the mutual check
    (`matcher.match`, the caller that wants the distance matrix) on the cam-0
    descriptors of the last two frames; returns the matrix kernel's launches."""
    import torch
    from okvis2x_tpu_torch.frontend import matcher
    from okvis2x_tpu_torch.ops import hamming

    fa, fb = (vio.frames[f][0] for f in sorted(vio.frames)[-2:])
    args = [torch.as_tensor(np.ascontiguousarray(x)) for x in
            (fa.packed.astype(np.int32), fa.valid, fb.packed.astype(np.int32), fb.valid)]
    kw = dict(max_dist=vio.cfg.matching_threshold, ratio=0.8, mutual=True)
    hamming.reset_launch_counts()
    got = matcher.match(*(x.to(dev) for x in args), **kw)
    torch.cuda.synchronize()
    launches = hamming.hamming_matrix_packed.launches
    ref = matcher.match(*args, **kw)
    for x, y in zip(got, ref):
        if not torch.equal(x.cpu(), y):
            raise RuntimeError("ratio-test matches differ between the card and the CPU")
    n = int(ref.valid.sum())
    print(f"ratio-test matching of the last two frames: {n} mutual matches, card == CPU, "
          f"matrix kernel launches {launches}")
    if launches <= 0 or n <= 0:
        raise RuntimeError("the ratio-test matching found nothing or never launched the "
                           "matrix kernel")
    return launches


class FrontendCheck:
    """Instruments the flagship pipeline's `frontend_dispatch`.

    Host syncs: `torch.cuda.set_sync_debug_mode` is process-wide, while the
    recognition worker and the background optimisation read their results
    back on their own streams, as they must.  So a dispatch runs under
    "error" when neither is running (the worker's item lock is held for the
    dispatch; the background thread starts only from the frame thread),
    else under "warn", and a warning issued on the frame thread during a
    dispatch counts as a sync.  Either way a sync fails the phase.

    The kernel: every COMPARE_EVERY-th dispatch keeps the inputs and results
    of the association's fused-kernel launches, and after the dispatch holds
    each against the plain version on the same inputs."""

    SYNC = "synchronizing CUDA operation"

    def __init__(self):
        self.n_error = self.n_warn = self.n_compared = self._n = 0
        self.syncs = []
        self.calls = None
        self._in_dispatch = False
        self._frame_thread = threading.current_thread()

    def install(self):
        self._show, self._filters = warnings.showwarning, warnings.filters[:]
        warnings.showwarning = self._showwarning
        warnings.filterwarnings("always", message=f".*{self.SYNC}.*")

    def uninstall(self):
        warnings.showwarning, warnings.filters[:] = self._show, self._filters

    def _showwarning(self, message, category, filename, lineno, file=None, line=None):
        if self.SYNC not in str(message):
            return self._show(message, category, filename, lineno, file, line)
        if self._in_dispatch and threading.current_thread() is self._frame_thread:
            self.syncs.append(f"{filename}:{lineno}")

    def wrap(self, vio):
        import torch
        from okvis2x_tpu_torch.frontend import matcher
        from okvis2x_tpu_torch.ops import hamming

        def recorded(*args, **kwargs):
            out = hamming.hamming_match(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        # ops.hamming as the matcher sees it during a compared dispatch
        recording = types.SimpleNamespace(**vars(hamming))
        recording.hamming_match = recorded
        dispatch = vio.frontend_dispatch

        def checked(*args, **kwargs):
            quiet = vio._lc_active.acquire(blocking=False)
            compare = self._n % COMPARE_EVERY == COMPARE_EVERY // 2
            self._n += 1
            real = matcher.hamming
            try:
                mode = "error" if quiet and not vio.full_graph.is_loop_closing else "warn"
                self.n_error += mode == "error"
                self.n_warn += mode == "warn"
                if compare:
                    self.calls, matcher.hamming = [], recording
                self._in_dispatch = True
                torch.cuda.set_sync_debug_mode(mode)
                try:
                    return dispatch(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    self._in_dispatch = False
                    matcher.hamming = real
            finally:
                if quiet:
                    vio._lc_active.release()
                if compare:
                    self._compare()

        vio.frontend_dispatch = checked

    def _compare(self):
        import torch
        from okvis2x_tpu_torch.ops import hamming

        for args, kwargs, out in self.calls:
            ref = hamming.hamming_match_plain(*args, **{k: v for k, v in kwargs.items()
                                                        if k != "site"})
            for g, r in zip(out, ref):
                if (g is None) != (r is None) or (g is not None and not torch.equal(g, r)):
                    raise RuntimeError("flagship: the fused kernel differs from its plain "
                                       "version at an association site")
            self.n_compared += 1
        self.calls = None


def loop_closure_phase(dev, card, mode, seq, cpu_positions=None):
    """One lap of the 0.8 m circuit (`seq`) with loop closure, then finish()
    and the final BA, in `mode`: "synchronous" (the synchronous,
    non-pipelined path), "asynchronous" (the flagship without its deferred
    frontend, with the background full BA) or "flagship" (tools/slam_bench.py
    as written; `cpu_positions` is a future of `flagship_cpu_positions`).
    Returns the fused kernel's launches by site and the pipeline."""
    import torch
    from okvis2x_tpu_torch.frontend import bow
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    what = f"{mode} loop-closure"
    n_frames = LC_FRAMES[mode]
    check = FrontendCheck() if mode == "flagship" else None
    timing.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    threads_before = set(threading.enumerate())
    if check is not None:
        check.install()
    try:
        vio, infos, wall, iters, t_finish, waits = run_pipeline(
            seq, dev, n_frames, record_times=True, est_kw=LC_ESTS[mode], pipe_kw=LC_PIPES[mode],
            wrap=None if check is None else check.wrap)
    finally:
        if check is not None:
            check.uninstall()
    t_run = time.perf_counter() - t0
    ts, Ts = check_positions(vio, n_frames, what)
    t0 = time.perf_counter()
    cost = vio.est.final_ba()
    torch.cuda.synchronize()
    t_ba = time.perf_counter() - t0
    launches = hamming.hamming_match.launches
    sites = dict(hamming.hamming_match.site_launches)
    on_matrix = hamming.hamming_matrix_packed.launches
    peak = torch.cuda.max_memory_allocated(dev)
    ft, fT = vio.est.full_trajectory()
    if not np.isfinite(fT).all() or not np.isfinite(cost):
        raise RuntimeError("non-finite poses or cost after the final BA")
    closures = sorted((int(e["j"]), int(e["i"])) for e in vio.est.archive_edges
                      if e.get("loop"))
    print(f"{what}: closures {vio.n_loop_closures} (frame, candidate) {closures}, landmarks "
          f"merged {vio.n_landmarks_merged}, keyframe records {len(vio.kf_records)} ({card})")
    n_kf = sum(i["is_keyframe"] for i in infos)
    print(f"{what}: fused match launches by site {sites} over {n_frames} frames and {n_kf} "
          f"keyframes; matrix kernel launches {on_matrix}")
    ERRORS.check(what)
    if vio.n_loop_closures < 1:
        raise RuntimeError(f"{what}: no loop closure was accepted")
    for site in ("bow", "lc_match"):
        if sites.get(site, 0) <= 0:
            raise RuntimeError(f"{what}: the fused kernel was never launched from site {site!r}")
    if sites.get("assoc", 0) != 4 * n_frames or on_matrix != 0:
        raise RuntimeError(f"{what}: the association did not launch the fused kernel 4 times a "
                           "frame, or the path launched the matrix kernel")
    ate_on = ate_checked(seq, ts, Ts, f"{what} online")
    ate_fin = ate_checked(seq, ft, fT, f"{what} final")
    ms = np.asarray(wall) * 1e3
    n_common = min(LC_FRAMES.values())
    print(f"{what}: {n_frames} frames in {t_run:.1f} s (finish() {t_finish:.1f} s), online "
          f"ATE {ate_on:.4f} m, final ATE {ate_fin:.4f} m over {len(ft)} keyframes, ms/frame "
          f"p50 {np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max {ms.max():.1f} "
          f"(first {n_common} frames: p50 {np.percentile(ms[:n_common], 50):.1f} p90 "
          f"{np.percentile(ms[:n_common], 90):.1f}), "
          f"2.8 LoopClosure mean {timing.mean_ms('2.8 LoopClosure'):.1f} ms, final BA "
          f"{t_ba:.1f} s, peak allocated {peak / 2**20:.1f} MiB, fused match launches "
          f"{launches} ({card})")
    if mode != "synchronous":
        fg = vio.full_graph
        hist = {int(k): int(n) for k, n in zip(*np.unique(iters, return_counts=True))}
        left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
        print(f"{what}: background optimisation dispatched {fg.n_dispatched}, synchronised "
              f"{fg.n_synchronised} (full BA {fg.n_full_ba}), stale discarded "
              f"{fg.n_stale_discarded}, solve wall time mean "
              f"{timing.mean_ms('4.1 FullGraphSolve'):.1f} ms; keyframes demoted to index-only "
              f"{vio._lc_skipped}; window solve iterations {hist} (histogram of _rt_iters when "
              f"built), budget overruns {vio.est.n_budget_overruns} of {len(iters)} solves; "
              f"threads left after finish(): {left} ({card})")
        if fg.n_synchronised < 1:
            raise RuntimeError(f"{what}: the background optimisation was never synchronised")
        if mode == "asynchronous" and fg.n_full_ba < 1:
            raise RuntimeError(f"{what}: no background full BA was synchronised")
        if left or vio._lc_thread is not None or fg.is_loop_closing:
            raise RuntimeError(f"{what}: threads still running after finish(): {left}")
        # the words the worker computed on its stream, against the CPU
        rec = next(r for r in vio.kf_records.values() if "words" in r)
        w_cpu = bow.assign_packed(rec["packed_d"].cpu(), rec["valid_d"].cpu(),
                                  vio.vocab.to("cpu")).numpy()
        if not np.array_equal(rec["words"], w_cpu):
            raise RuntimeError("the worker's vocabulary words differ from the CPU's")
        print(f"{what}: vocabulary words computed by the worker on its stream == CPU, exact "
              f"({card})")
    else:
        # the vocabulary descent of one keyframe on the card and on the CPU
        rec = vio.kf_records[min(vio.kf_records)]
        w_gpu = bow.assign_packed(rec["packed_d"], rec["valid_d"], vio.vocab).cpu()
        w_cpu = bow.assign_packed(rec["packed_d"].cpu(), rec["valid_d"].cpu(),
                                  vio.vocab.to("cpu"))
        if not torch.equal(w_gpu, w_cpu):
            raise RuntimeError("vocabulary words differ between the card and the CPU")
        print(f"{what}: vocabulary words of the first keyframe: card == CPU, exact")
    if check is not None:
        wait_ms = np.asarray(waits) * 1e3
        print(f"{what}: frontend_dispatch under set_sync_debug_mode: {check.n_error} dispatches "
              f"under 'error', {check.n_warn} under 'warn' (a worker running), host syncs on the "
              f"frame thread {len(check.syncs)}; fused kernel == plain at {check.n_compared} "
              f"association launches of {n_frames // COMPARE_EVERY} frames, exact; "
              f"2.0 PrefetchWait ms p50 {np.percentile(wait_ms, 50):.3f} p90 "
              f"{np.percentile(wait_ms, 90):.3f} max {wait_ms.max():.3f}; descriptor blocks still "
              f"in flight when folded in: {vio.n_desc_late} ({card})")
        if check.syncs or check.n_error + check.n_warn != n_frames:
            raise RuntimeError(f"{what}: host syncs in frontend_dispatch at {check.syncs}")
        if check.n_compared != 4 * (n_frames // COMPARE_EVERY):
            raise RuntimeError(f"{what}: held {check.n_compared} kernel launches against plain")
        p_cpu, t_cpu = cpu_positions.result()
        gap = float(np.abs(p_cpu - Ts[:CPU_FRAMES, :3]).max())
        print(f"{what}: cpu vs gpu over {CPU_FRAMES} frames: max position gap {gap:.3e} m (CPU run "
              f"{t_cpu:.1f} s, in a process of its own)")
        if not gap <= CPU_GPU_TOL_M:
            raise RuntimeError(f"{what}: GPU and CPU runs disagree by {gap} m")
    print(timing.report())
    return sites, vio


class MatchRecorder:
    """Keeps the inputs and outputs of the calls of
    `hamming.match_packed_mutual` from one site while installed."""

    def __init__(self, site):
        self.site, self.calls = site, []

    def __enter__(self):
        from okvis2x_tpu_torch.ops import hamming

        self.orig = hamming.match_packed_mutual

        def call(*args, **kw):
            out = self.orig(*args, **kw)
            if kw.get("site") == self.site:
                self.calls.append((args, dict(kw), out))
            return out

        hamming.match_packed_mutual = call
        return self

    def __exit__(self, *exc):
        from okvis2x_tpu_torch.ops import hamming

        hamming.match_packed_mutual = self.orig


def plain_match():
    """A context in which `hamming.hamming_match` is its plain version (on
    the card too): for holding a whole site against it."""
    import contextlib

    from okvis2x_tpu_torch.ops import hamming

    @contextlib.contextmanager
    def ctx():
        orig = hamming.hamming_match
        hamming.hamming_match = lambda *a, site=None, **kw: hamming.hamming_match_plain(*a, **kw)
        try:
            yield
        finally:
            hamming.hamming_match = orig

    return ctx()


def rot_err(qa, qb):
    """Angles (rad) between the rotations of unit quaternions (..., 4)."""
    return 2 * np.arccos(np.clip(np.abs(np.sum(qa * qb, axis=-1)), 0, 1))


def multisession_phase(dev, card, vio_a, seq):
    """Session A (the synchronous phase's pipeline) saved as a component;
    session B, a new pipeline on the card without a vocabulary file
    (`vocab_path=""`) in the synchronous configuration, loads it (its
    vocabulary bootstrapped from A's descriptors on the kernel, site
    "vocab") and runs MS_FRAMES frames of the same rendering from a world
    frame that is MS_OFFSET off A's (put on after the estimator's first
    state, before the first keyframe is recorded).  B's keyframes are
    verified against A's (site "reloc").  Returns the fused kernel's
    launches by site."""
    import os
    import tempfile

    import torch
    from okvis2x_tpu_torch.core import se3np
    from okvis2x_tpu_torch.frontend import bow
    from okvis2x_tpu_torch.graph import component
    from okvis2x_tpu_torch.ops import hamming

    what = "multi-session"
    t0 = time.perf_counter()
    offset = se3np.se3_multiply(
        np.array([0.0, MS_OFFSET[0], 0.0, 0, 0, 0, 1.0]),
        np.concatenate([[0.0, 0.0, 0.0], se3np.delta_q(np.array([0.0, 0.0, MS_OFFSET[1]]))]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session_a.npz")
        vio_a.save_component(path)
        comp = component.load_component(path)
        print(f"{what}: session A saved, {len(comp['frame_fids'])} pose-graph nodes, "
              f"{len(comp['records'])} keyframe records, {os.path.getsize(path) / 2**20:.2f} MiB")

        def prepare(vio):
            """Load A, then put B's world frame off A's at its first state."""
            if not vio.load_component(path):
                raise RuntimeError(f"{what}: load_component refused session A")
            add_state = vio.est.add_state

            def first_state(t):
                fid = add_state(t)
                vio.est.rigid_transform(offset, session_only=True)
                vio.est.add_state = add_state
                return fid

            vio.est.add_state = first_state

        hamming.reset_launch_counts()
        with MatchRecorder("reloc") as rec:
            vio, infos, wall, _, _, _ = run_pipeline(
                seq, dev, MS_FRAMES, record_times=True, est_kw=LC_ESTS["synchronous"],
                pipe_kw=LC_PIPES["synchronous"] | dict(vocab_path=""), wrap=prepare)
        sites = dict(hamming.hamming_match.site_launches)
    t_run = time.perf_counter() - t0
    ERRORS.check(what)
    ts, Ts = check_positions(vio, MS_FRAMES, what)
    print(f"{what}: session B, {MS_FRAMES} frames in {t_run:.1f} s (ms/frame p50 "
          f"{np.percentile(np.asarray(wall) * 1e3, 50):.1f}), relocalisations "
          f"{vio.n_relocalisations}, loop closures {vio.n_loop_closures}; fused match launches "
          f"by site {sites} ({card})")
    if vio.n_relocalisations < 1 or not vio.relocalised:
        raise RuntimeError(f"{what}: session B was never relocalised")
    for site in ("vocab", "reloc"):
        if sites.get(site, 0) <= 0:
            raise RuntimeError(f"{what}: the fused kernel was never launched from site {site!r}")

    # the bootstrapped vocabulary against the plain trainer on the card
    recs = vio.components[0]["records"].values()
    packs = torch.cat([r["packed_d"][r["valid_d"]] for r in recs])
    init = bow.init_indices(len(packs), vio.cfg.vocab_k)
    with plain_match():
        plain = bow.train_vocabulary_core(packs, init, iters=6)
    if not torch.equal(vio.vocab, plain):
        raise RuntimeError(f"{what}: the vocabulary trained on the kernel differs from the plain "
                           "trainer's")
    print(f"{what}: vocabulary of {vio.vocab.shape[0]} words bootstrapped from {len(packs)} "
          "descriptors of session A on the kernel == plain trainer on the card, exact")

    # one verification's match on the kernel against the plain version
    args, kw, out = rec.calls[0]
    with plain_match():
        ref = hamming.match_packed_mutual(*args, **kw)
    for name, g, r in zip(("idx", "dist", "ok"), out, ref):
        if g.dtype != r.dtype or not torch.equal(g, r):
            raise RuntimeError(f"{what}: the reloc match differs from the plain version ({name})")
    print(f"{what}: reloc match of {args[0].shape[0]} x {args[2].shape[0]} descriptors == plain, "
          f"exact ({len(rec.calls)} reloc matches in the run)")

    # B's poses from its first relocalisation on, against A's estimate
    first = next(i for i, inf in enumerate(infos) if inf["loop_closure"])
    ta = np.array([s[0] for s in vio_a.states_log])
    Ta = np.stack([s[1] for s in vio_a.states_log])
    if not np.array_equal(ta[first:MS_FRAMES], ts[first:]):
        raise RuntimeError(f"{what}: sessions A and B logged different frame times")
    d_pos = np.linalg.norm(Ts[first:, :3] - Ta[first:MS_FRAMES, :3], axis=1)
    d_rot = rot_err(Ts[first:, 3:7], Ta[first:MS_FRAMES, 3:7])
    print(f"{what}: first relocalised at frame {first}; B against A over frames {first}-"
          f"{MS_FRAMES - 1}: position gap max {d_pos.max():.4f} m, rotation gap max "
          f"{d_rot.max():.4f} rad (limits {MS_POS_TOL_M} m, {MS_ROT_TOL_RAD} rad); before: "
          f"{np.linalg.norm(offset[:3]):.2f} m, {MS_OFFSET[1]} rad")
    if not (d_pos.max() <= MS_POS_TOL_M and d_rot.max() <= MS_ROT_TOL_RAD):
        raise RuntimeError(f"{what}: relocalised poses off session A's estimate")
    return sites


def app_config(path, seq, online_calibration=False, camera_type="gray"):
    """An okvis2.yaml-schema config for the rendered rig (`seq.camera`, a dict
    of the intrinsics, and `seq.T_SC`), as the reference's files are written:
    the %YAML header, one flow mapping a camera; with `online_calibration`
    the extrinsics are estimated in the window and in the final BA, at the
    default sigmas; `camera_type` is cam0's ("rgb": colour submaps)."""
    c = seq.camera
    cams = []
    for k, T in enumerate(seq.T_SC):
        M = np.eye(4)
        M[:3, 3] = T[:3]
        rows = ",\n          ".join(", ".join(repr(float(v)) for v in r) for r in M)
        cams.append(f"""    - {{T_SC:
        [ {rows}],
        image_dimension: [{c['width']}, {c['height']}],
        distortion_coefficients: [{", ".join(repr(d) for d in c['dist_params'])}],
        distortion_type: radialtangential,
        focal_length: [{c['fx']!r}, {c['fy']!r}],
        principal_point: [{c['cx']!r}, {c['cy']!r}],
        camera_type: {camera_type if k == 0 else "gray"}, # gray, rgb, gray+depth, rgb+depth
        slam_use: okvis}}""")
    calib = """
camera_parameters:
    online_calibration:
        do_extrinsics: true
        do_extrinsics_final_ba: true
""" if online_calibration else ""
    with open(path, "w") as f:
        f.write("%YAML:1.0\ncameras:\n" + "\n".join(cams) + "\n" + calib + """
imu_parameters:
    use: true
    sigma_g_c: 12.0e-4 # gyro noise density [rad/s/sqrt(Hz)]
    sigma_a_c: 8.0e-3 # accelerometer noise density [m/s^2/sqrt(Hz)]
    sigma_gw_c: 4.0e-6
    sigma_aw_c: 4.0e-5
    g: 9.81007

estimator_parameters:
    num_keyframes: 5
    num_loop_closure_frames: 5
    num_imu_frames: 3
    do_loop_closures: true
    realtime_max_iterations: 10
""")


def app_dataset(root):
    """The app phase's dataset, written under `root`: APP_FRAMES frames of
    the 0.8 m circuit at the EuRoC operating point in the EuRoC layout
    (`generate`), and its okvis2.yaml-schema config.  Returns (dataset dir,
    config path, the same frames from `render_sequence`)."""
    import os

    from okvis2x_tpu_torch.io import synthetic

    ds_dir = os.path.join(root, "dataset")
    kw = dict(duration=0.3 + APP_FRAMES / 20.0, frame_rate=20.0, imu_rate=200.0, width=752,
              height=480, fx=460.0, density=22.0, seed=3, trajectory="circuit",
              scene_version=2, traj_kwargs=SMALL_CIRCUIT)
    synthetic.generate(ds_dir, **kw)
    seq = synthetic.render_sequence(**kw)
    cfg = os.path.join(root, "okvis2.yaml")
    app_config(cfg, seq)
    return ds_dir, cfg, seq


@contextlib.contextmanager
def timed_frames(dev):
    """A context in which every `VioPipeline.process_frame` is timed to the
    end of its device work.  Yields (wall, pipes): each frame's seconds and
    the pipelines that ran, in order of their first frame.  Peak device
    memory counts from its start (`peak_text`)."""
    import torch
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline

    wall, pipes = [], []
    process_frame = VioPipeline.process_frame

    def timed(self, *args, **kwargs):
        t = time.perf_counter()
        info = process_frame(self, *args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall.append(time.perf_counter() - t)
        if self not in pipes:
            pipes.append(self)
        return info

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    VioPipeline.process_frame = timed
    try:
        yield wall, pipes
    finally:
        VioPipeline.process_frame = process_frame


def peak_text(dev):
    """The peak allocated device memory since its last reset, for printing."""
    import torch

    if dev.type != "cuda":
        return "not measured"
    return f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB"


def app_phase(dev, card):
    """The port's dataset app (`okvis2x_tpu_torch.apps.okvis2x_app.main`) in
    slam mode on an EuRoC-layout dataset that the port's `generate` writes
    under build/: APP_FRAMES frames of the 0.8 m circuit at the EuRoC
    operating point, with an okvis2.yaml-schema config and both debug CSVs,
    on the default device (cuda:0) or on `dev` when that is the CPU.
    Returns the fused kernel's launches by site."""
    import os
    import shutil

    from okvis2x_tpu_torch.apps import okvis2x_app
    from okvis2x_tpu_torch.io import euroc, trajectory_io
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    what = "app"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "app_phase")
    shutil.rmtree(root, ignore_errors=True)
    out = os.path.join(root, "out")
    t0 = time.perf_counter()
    ds_dir, cfg, seq = app_dataset(root)
    ds = euroc.EurocDataset(ds_dir)
    if len(ds.frames) != APP_FRAMES:
        raise RuntimeError(f"{what}: the dataset has {len(ds.frames)} frames")
    for k in (0, APP_FRAMES - 1):
        for c in range(2):
            img = ds.load_image(ds.frames[k].paths[c])
            if not np.array_equal(img, seq.images[k, c].astype(np.float32) / 255.0):
                raise RuntimeError(f"{what}: frame {k} of cam {c} read back differs from "
                                   "render_sequence's")
    n_imu = 0
    n_frames = 0
    for kind, _ in ds.events():
        if kind == "frames":
            n_frames += 1
            if n_frames == APP_FRAMES:
                break
        else:
            n_imu += 1
    t_data = time.perf_counter() - t0

    argv = ["--dataset", ds_dir, "--config", cfg, "--mode", "slam", "--output", out,
            "--max-frames", str(APP_FRAMES), "--imu-csv", os.path.join(out, "imu.csv"),
            "--tracks-csv", os.path.join(out, "tracks.csv")]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    with timed_frames(dev) as (wall, pipes):
        timing.reset()  # the stage times the app prints are its own
        hamming.reset_launch_counts()
        t0 = time.perf_counter()
        ate = okvis2x_app.main(argv)
        t_run = time.perf_counter() - t0
    sites = dict(hamming.hamming_match.site_launches)
    ERRORS.check(what)
    vio = pipes[0]
    if vio.device != dev:
        raise RuntimeError(f"{what}: the app ran on {vio.device}, not {dev}")
    ts, _ = trajectory_io.read_tum(os.path.join(out, "trajectory.tum"))
    fts, _ = trajectory_io.read_tum(os.path.join(out, "final_trajectory.tum"))
    n_est = len(vio.est.full_trajectory()[0])
    if len(ts) != APP_FRAMES or len(fts) != n_est:
        raise RuntimeError(f"{what}: trajectory.tum has {len(ts)} rows for {APP_FRAMES} "
                           f"frames, final_trajectory.tum {len(fts)} for {n_est} states")
    if ate is None or not ate <= ATE_LIMIT_M:
        raise RuntimeError(f"{what}: online ATE {ate} m exceeds {ATE_LIMIT_M} m")
    with open(os.path.join(out, "imu.csv")) as f:
        imu_rows = sum(1 for _ in f) - 1
    with open(os.path.join(out, "tracks.csv")) as f:
        track_rows = sum(1 for _ in f) - 1
    if imu_rows != n_imu or track_rows <= 0:
        raise RuntimeError(f"{what}: the IMU CSV has {imu_rows} rows for {n_imu} samples fed, "
                           f"the tracks CSV {track_rows}")
    if dev.type == "cuda" and (sites.get("assoc", 0) <= 0 or sites.get("bow", 0) <= 0):
        raise RuntimeError(f"{what}: the fused kernel's launches by site {sites} lack the "
                           "association or the vocabulary descent")
    ms = np.asarray(wall) * 1e3
    peak = peak_text(dev)
    print(f"{what}: dataset of {APP_FRAMES} frames (752x480 PNG, {n_imu} IMU samples before "
          f"the last frame) written, read back and checked in {t_data:.1f} s; "
          f"okvis2x_app --mode slam on {vio.device}: {t_run:.1f} s, online ATE {ate:.4f} m, "
          f"{len(fts)} final-BA states, ms/frame p50 {np.percentile(ms, 50):.1f} p90 "
          f"{np.percentile(ms, 90):.1f} max {ms.max():.1f}, window solve (2.5 CollectSolve) "
          f"mean {timing.mean_ms('2.5 CollectSolve'):.2f} ms, peak allocated {peak}, "
          f"IMU CSV {imu_rows} rows, tracks CSV {track_rows} rows; fused match launches by "
          f"site {sites} ({card})")
    return sites


def write_bags(ds_dir, root):
    """The events of the EuRoC-layout dataset `ds_dir`, in `events()`'s
    order, as a ROS1 bag (`Rosbag1Writer`) and a ROS2 bag (`Rosbag2Writer`)
    under `root`: mono8 `sensor_msgs/Image` on BAG_CAM_TOPICS (the PNGs'
    pixels) and `sensor_msgs/Imu` on BAG_IMU_TOPIC, stamped in integer
    nanoseconds.  Returns (ROS1 path, ROS2 path, the messages written as
    (topic, ns, image or (gyr, acc)))."""
    import os

    from okvis2x_tpu_torch.io import euroc, png, rosbag1, rosbag2

    os.makedirs(root, exist_ok=True)
    bag1, bag2 = os.path.join(root, "seq.bag"), os.path.join(root, "seq_ros2")
    written = []
    with rosbag1.Rosbag1Writer(bag1) as b1, rosbag2.Rosbag2Writer(bag2) as b2:
        for kind, ev in euroc.EurocDataset(ds_dir).events():
            if kind == "imu":
                t, gyr, acc = ev
                ns = int(round(t * 1e9))
                b1.write(BAG_IMU_TOPIC, "sensor_msgs/Imu", ns, rosbag1.encode_imu(ns, gyr, acc))
                b2.write(BAG_IMU_TOPIC, "sensor_msgs/msg/Imu", ns,
                         rosbag2.encode_imu(ns, gyr, acc))
                written.append((BAG_IMU_TOPIC, ns, (gyr, acc)))
                continue
            ns = int(round(ev.t * 1e9))
            for topic, path in zip(BAG_CAM_TOPICS, ev.paths):
                img = png.decode_image(path)
                b1.write(topic, "sensor_msgs/Image", ns, rosbag1.encode_image(ns, img))
                b2.write(topic, "sensor_msgs/msg/Image", ns, rosbag2.encode_image(ns, img))
                written.append((topic, ns, img))
    return bag1, bag2, written


def check_bags(what, bag1, bag2, written):
    """Both bags read back through the port's readers: every message on its
    topic, with its stamp, and its image or IMU sample equal to what was
    written, bit for bit."""
    from okvis2x_tpu_torch.io import rosbag1, rosbag2

    for reader, codec in ((rosbag1.Rosbag1Reader(bag1), rosbag1),
                          (rosbag2.Rosbag2Reader(bag2), rosbag2)):
        got = list(reader.messages())
        if len(got) != len(written):
            raise RuntimeError(f"{what}: {codec.__name__} read {len(got)} messages of "
                               f"{len(written)}")
        for msg, (topic, ns, data) in zip(got, written):
            if msg.topic != topic or msg.t_ns != ns:
                raise RuntimeError(f"{what}: {codec.__name__} read {msg.topic} at {msg.t_ns} "
                                   f"where {topic} at {ns} was written")
            if topic == BAG_IMU_TOPIC:
                m = codec.decode_imu(msg.raw)
                same = np.array_equal(m.gyr, data[0]) and np.array_equal(m.acc, data[1])
            else:
                m = codec.decode_image(msg.raw)
                same = (m.encoding == "mono8" and m.data.dtype == data.dtype
                        and np.array_equal(m.data, data))
            if m.t_ns != ns or not same:
                raise RuntimeError(f"{what}: {codec.__name__} decoded {topic} at {ns} unlike "
                                   "what was written")


def node_metrics(ds_dir, out):
    """The synchronous node's trajectories in `out` against the ground truth
    of the EuRoC-layout dataset `ds_dir`: the online and final ATE and the
    rows of each file."""
    import os

    from okvis2x_tpu_torch.io import euroc, trajectory_io

    gt = euroc.EurocDataset(ds_dir).ground_truth
    ts, Ts = trajectory_io.read_tum(os.path.join(out, "okvis2_trajectory.csv"))
    fts, fTs = trajectory_io.read_tum(os.path.join(out, "okvis2_final_trajectory.csv"))
    return dict(
        ate_online_m=float(trajectory_io.ate_rmse(ts, Ts[:, :3], gt[:, 0], gt[:, 1:4])),
        ate_final_m=float(trajectory_io.ate_rmse(fts, fTs[:, :3], gt[:, 0], gt[:, 1:4])),
        n_frames=len(ts), n_final=len(fts), final_finite=bool(np.isfinite(fTs).all()),
    )


def bag_phase(dev, card):
    """The port's synchronous node (`okvis2x_tpu_torch.apps.
    okvis2x_node_synchronous.main`) on the app phase's dataset and config
    (build/app_phase/, written by `app_phase`) repacked as bags: both bags
    read back bit for bit, the ROS1 bag replayed under the node's defaults
    (the config's cameras, 512 keypoints, loop closures on) on the default
    device (cuda:0), or on `dev` when that is the CPU, then the ROS2 bag's
    first BAG_ROS2_FRAMES frames.  Returns the fused kernel's launches by
    site over both runs."""
    import os
    import shutil

    from okvis2x_tpu_torch.apps import okvis2x_node_synchronous as node
    from okvis2x_tpu_torch.ops import hamming

    what = "bag replay"
    here = os.path.dirname(os.path.abspath(__file__))
    app_root, root = os.path.join(here, "build", "app_phase"), os.path.join(here, "build",
                                                                            "bag_phase")
    ds_dir, cfg = os.path.join(app_root, "dataset"), os.path.join(app_root, "okvis2.yaml")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    bag1, bag2, written = write_bags(ds_dir, root)
    check_bags(what, bag1, bag2, written)
    n_imu = sum(topic == BAG_IMU_TOPIC for topic, _, _ in written)
    t_bags = time.perf_counter() - t0

    def replay(bag, out, max_frames=0):
        argv = ["--bag", bag, "--config", cfg, "--output", out]
        if max_frames:
            argv += ["--max-frames", str(max_frames)]
        if dev.type == "cpu":
            argv += ["--device", "cpu"]
        hamming.reset_launch_counts()
        t = time.perf_counter()
        rc = node.main(argv)
        t = time.perf_counter() - t
        if rc != 0:
            raise RuntimeError(f"{what}: the node returned {rc} on {bag}")
        return dict(hamming.hamming_match.site_launches), t

    outs = [os.path.join(root, "out_ros1"), os.path.join(root, "out_ros2")]
    with timed_frames(dev) as (wall, pipes):
        sites, t_run = replay(bag1, outs[0])
        n_timed = len(wall)
        sites2, t_run2 = replay(bag2, outs[1], BAG_ROS2_FRAMES)
    ERRORS.check(what)
    vio, vio2 = pipes
    if vio.device != dev or vio2.device != dev:
        raise RuntimeError(f"{what}: the node ran on {vio.device}, not {dev}")
    if vio._lc_thread is not None or vio2._lc_thread is not None:
        raise RuntimeError(f"{what}: the place-recognition worker outlived finish()")
    m = node_metrics(ds_dir, outs[0])
    n_est = len(vio.est.full_trajectory()[0])
    if m["n_frames"] != APP_FRAMES or m["n_final"] != n_est or not m["final_finite"]:
        raise RuntimeError(f"{what}: okvis2_trajectory.csv has {m['n_frames']} rows for "
                           f"{APP_FRAMES} frames, okvis2_final_trajectory.csv {m['n_final']} for "
                           f"{n_est} states (finite: {m['final_finite']})")
    limit = min(ATE_LIMIT_M, max(2 * JAX_NODE["ate_online_m"], 0.05))
    if not m["ate_online_m"] <= limit:
        raise RuntimeError(f"{what}: online ATE {m['ate_online_m']} m exceeds {limit} m")
    for key in ("ate_online_m", "ate_final_m"):
        if not abs(m[key] - JAX_NODE[key]) <= JAX_NODE_TOL_M:
            raise RuntimeError(f"{what}: {key} {m[key]} is more than {JAX_NODE_TOL_M} m from "
                               f"the JAX node's {JAX_NODE[key]}")
    if dev.type == "cuda" and (sites.get("assoc", 0) != 4 * APP_FRAMES
                               or sites2.get("assoc", 0) != 4 * BAG_ROS2_FRAMES):
        raise RuntimeError(f"{what}: the association did not launch the fused kernel 4 times a "
                           f"frame: {sites} over {APP_FRAMES} frames, {sites2} over "
                           f"{BAG_ROS2_FRAMES}")
    p1 = np.stack([T[:3] for _, T in vio.states_log[:BAG_ROS2_FRAMES]])
    p2 = np.stack([T[:3] for _, T in vio2.states_log])
    gap = float(np.abs(p1 - p2).max()) if len(p2) == BAG_ROS2_FRAMES else np.inf
    if not gap <= BAG_ROS2_TOL_M:
        raise RuntimeError(f"{what}: the ROS2 bag's {len(p2)} online poses differ from the ROS1 "
                           f"run's by {gap} m")
    ms = np.asarray(wall[:n_timed]) * 1e3
    peak = peak_text(dev)
    print(f"{what}: {len(written)} messages ({APP_FRAMES} stereo frames, {n_imu} IMU samples) "
          f"written as a ROS1 and a ROS2 bag and read back bit for bit in {t_bags:.1f} s; "
          f"okvis2x_node_synchronous on the ROS1 bag on {vio.device}: {t_run:.1f} s, online "
          f"ATE {m['ate_online_m']:.4f} m (JAX node {JAX_NODE['ate_online_m']:.4f}, limit "
          f"{limit:.4f}), final ATE {m['ate_final_m']:.4f} m (JAX node "
          f"{JAX_NODE['ate_final_m']:.4f}) over {m['n_final']} states, "
          f"{vio.n_loop_closures} loop closures, the worker stopped, ms/frame p50 "
          f"{np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max {ms.max():.1f}, "
          f"peak allocated {peak}; the ROS2 "
          f"bag's first {BAG_ROS2_FRAMES} frames in {t_run2:.1f} s, {gap:.3e} m from the ROS1 "
          f"run's; fused match launches by site {sites} and {sites2} ({card})")
    return {k: sites.get(k, 0) + sites2.get(k, 0) for k in {*sites, *sites2}}


def publish_dataset(transport, ds_dir, topic_msgs, n_frames=0):
    """Publish the EuRoC-layout dataset `ds_dir`'s events, in `events()`'s
    order, on a node's input topics as a live driver would: each IMU sample on
    "imu", each stereo frame's images (float32 in [0, 1]) on "cam0/image" and
    "cam1/image"; stop after `n_frames` frames (0: all).  `topic_msgs` is the
    messages module of the ROS2 layer (the JAX package's or the port's).
    Returns each frame's seconds from its first image to the end of its device
    work."""
    import torch
    from okvis2x_tpu_torch.io import euroc

    ds = euroc.EurocDataset(ds_dir)
    cams = [transport.advertise(f"cam{c}/image") for c in range(2)]
    imu = transport.advertise("imu")
    wall = []
    for kind, ev in ds.events():
        if kind == "imu":
            t, gyr, acc = ev
            imu.publish(topic_msgs.Imu(topic_msgs.Header(t), np.asarray(gyr), np.asarray(acc)))
            continue
        if not ev.paths[0]:
            continue
        images = [ds.load_image(p) for p in ev.paths[:2]]
        t0 = time.perf_counter()
        for pub, img in zip(cams, images):
            pub.publish(topic_msgs.Image(topic_msgs.Header(ev.t), img))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        if n_frames and len(wall) == n_frames:
            break
    return wall


def network_metrics(transport, ds_dir, prefix=NETWORK_PREFIX):
    """What the live-nodes phase checks of a network node's run over a
    `LocalTransport`: the messages on its depth, sigma and odometry topics
    and the online ATE of its odometry against the dataset's ground truth."""
    from okvis2x_tpu_torch.io import euroc, trajectory_io

    gt = euroc.EurocDataset(ds_dir).ground_truth
    odom = transport.history.get(f"{prefix}/odometry", [])
    ts = np.array([o.header.stamp for o in odom])
    pos = np.stack([np.asarray(o.T_WB[:3], np.float64) for o in odom])
    return dict(
        ate_online_m=float(trajectory_io.ate_rmse(ts, pos, gt[:, 0], gt[:, 1:4])),
        n_odometry=len(odom), n_depth=transport.count(f"{prefix}/network/depth"),
        n_sigma=transport.count(f"{prefix}/network/depth_sigma"),
        positions_finite=bool(np.isfinite(pos).all()),
    )


def network_node_phase(dev, card, ds_dir, cfg):
    """(a) The port's network node (`build_network_graph` over a
    `LocalTransport`) on the app phase's dataset under the JAX `main`'s
    defaults, on the default device (cuda:0) or on `dev` when that is the
    CPU: a depth, sigma and odometry message a frame, the online ATE against
    JAX_NETWORK_NODE, frame 0's census depth against the CPU's.  Returns the
    fused kernel's launches by site."""
    import torch
    from okvis2x_tpu_torch.apps.okvis2x_network_node import build_network_graph
    from okvis2x_tpu_torch.apps.okvis2x_node import load_rig
    from okvis2x_tpu_torch.io import euroc
    from okvis2x_tpu_torch.models import stereo
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.ros2 import LocalTransport
    from okvis2x_tpu_torch.ros2 import messages as m
    from okvis2x_tpu_torch.utils import timing

    what = "live nodes (network node)"
    cameras, T_SC = load_rig(cfg)
    tr = LocalTransport()
    start_mib = None
    if dev.type == "cuda":
        start_mib = torch.cuda.memory_allocated(dev) / 2**20
    with timed_frames(dev) as (wall, pipes):
        core, _, _, _ = build_network_graph(tr, cameras, T_SC, prefix=NETWORK_PREFIX,
                                            max_disp=NETWORK_MAX_DISP,
                                            device=None if dev.type == "cuda" else dev)
        timing.reset()
        hamming.reset_launch_counts()
        t0 = time.perf_counter()
        frame_s = publish_dataset(tr, ds_dir, m)
        core.pipe.finish()
        t_run = time.perf_counter() - t0
    sites = dict(hamming.hamming_match.site_launches)
    ERRORS.check(what)
    vio = core.pipe
    if vio.device != dev:
        raise RuntimeError(f"{what}: the node ran on {vio.device}, not {dev}")
    if vio._lc_thread is not None:
        raise RuntimeError(f"{what}: the place-recognition worker outlived finish()")
    n = len(frame_s)
    met = network_metrics(tr, ds_dir)
    counts = (met["n_depth"], met["n_sigma"], met["n_odometry"])
    if n != APP_FRAMES or counts != (n, n, n) or not met["positions_finite"]:
        raise RuntimeError(f"{what}: {n} frames published; depth, sigma and odometry "
                           f"messages {counts}, finite {met['positions_finite']}")
    ref = JAX_NETWORK_NODE["ate_online_m"]
    limit = min(ATE_LIMIT_M, max(2 * ref, 0.05))
    ate = met["ate_online_m"]
    if not (ate <= limit and abs(ate - ref) <= JAX_NODE_TOL_M):
        raise RuntimeError(f"{what}: online ATE {ate} m, the JAX network node's {ref} m "
                           f"(at most {limit} m and within {JAX_NODE_TOL_M} m of it)")
    if dev.type == "cuda" and sites.get("assoc", 0) != 4 * n:
        raise RuntimeError(f"{what}: the association did not launch the fused kernel 4 times "
                           f"a frame: {sites} over {n} frames")
    # frame 0's census depth on the node's device against the CPU's
    depth0 = tr.history[f"{NETWORK_PREFIX}/network/depth"][0].data
    fx = float(np.asarray(cameras[0].fxfycxcy)[0])
    baseline = float(np.linalg.norm(T_SC[1][:3] - T_SC[0][:3]))
    ds = euroc.EurocDataset(ds_dir)
    left, right = (torch.as_tensor(ds.load_image(p)) for p in ds.frames[0].paths[:2])
    cpu = stereo.stereo_depth(left, right, fx, baseline, max_disp=NETWORK_MAX_DISP).depth.numpy()
    agree = ((depth0 > 0) == (cpu > 0)) & (np.abs(depth0 - cpu) <= NETWORK_DEPTH_TOL_M)
    share = float(agree.mean())
    if not share >= NETWORK_DEPTH_SHARE:
        raise RuntimeError(f"{what}: frame 0's depth on {dev} agrees with the CPU's within "
                           f"{NETWORK_DEPTH_TOL_M} m on {share:.5f} of the pixels "
                           f"(at least {NETWORK_DEPTH_SHARE})")
    total = np.asarray(frame_s) * 1e3
    ms = np.asarray(wall) * 1e3
    peak = peak_text(dev)
    print(f"{what}: build_network_graph over LocalTransport on {vio.device}, {n} frames of "
          f"{left.shape[1]}x{left.shape[0]} ({NETWORK_MAX_DISP} disparities, the JAX main's "
          f"EstimatorConfig() and PipelineConfig()): {t_run:.1f} s; {counts[0]} depth, "
          f"{counts[1]} sigma and {counts[2]} odometry messages; online ATE {ate:.4f} m (JAX "
          f"network node {ref:.4f}, limit {limit:.4f}); frame 0's depth equal to the CPU's "
          f"within {NETWORK_DEPTH_TOL_M} m on {share:.5f} of the pixels "
          f"({int((cpu > 0).sum())} valid on the CPU, {int((depth0 > 0).sum())} on {dev}); "
          f"ms/frame (stereo depth and the frame) p50 {np.percentile(total, 50):.1f} p90 "
          f"{np.percentile(total, 90):.1f} max {total.max():.1f}, of which process_frame p50 "
          f"{np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max {ms.max():.1f}; "
          f"window solve (2.5 CollectSolve) mean {timing.mean_ms('2.5 CollectSolve'):.2f} ms, "
          f"3.2 SolveDevice mean {timing.mean_ms('3.2 SolveDevice'):.2f} ms; peak allocated "
          f"{peak}{'' if start_mib is None else f' ({start_mib:.1f} at the start)'}; fused "
          f"match launches by site {sites} ({card})")
    return sites


def realsense_check(ds_dir):
    """(b) The port's realsense publisher (`run_publisher`) over a
    `FakeRealsense` replaying the dataset: a message on each camera topic a
    frame and on the IMU topic an IMU sample."""
    from okvis2x_tpu_torch.apps.okvis_node_realsense_publisher import run_publisher
    from okvis2x_tpu_torch.io import euroc
    from okvis2x_tpu_torch.io.realsense import FakeRealsense
    from okvis2x_tpu_torch.ros2 import LocalTransport

    what = "live nodes (realsense publisher)"
    ds = euroc.EurocDataset(ds_dir)
    driver = FakeRealsense(ds)
    tr = LocalTransport()
    t0 = time.perf_counter()
    run_publisher(tr, driver, prefix="realsense")
    driver.start_streaming()
    driver.wait_done(timeout=120.0)
    driver.stop_streaming()
    t_run = time.perf_counter() - t0
    if driver._thread.is_alive():
        raise RuntimeError(f"{what}: the fake driver's thread did not stop")
    want = (len(ds.frames), len(ds.frames), len(ds.imu.t))
    got = tuple(tr.count(f"realsense/{t}") for t in ("cam0/image", "cam1/image", "imu"))
    if got != want:
        raise RuntimeError(f"{what}: cam0, cam1 and IMU messages {got}, the dataset has {want}")
    print(f"{what}: FakeRealsense over the dataset through run_publisher in {t_run:.2f} s: "
          f"{got[0]} + {got[1]} images and {got[2]} IMU samples published, as many as the "
          "dataset's")


def native_loader_check(ds_dir):
    """(c) The port's native loader: whether its library built (it needs
    libpng), each of the dataset's PNGs decoded by `decode_image` and by the
    prefetcher equal to ``io/png.py``'s bit for bit, the frames that fell back
    to ``io/png.py`` counted; with the library, the queue's round trip, drop,
    timeout and shutdown; without it, the queue's refusal."""
    from okvis2x_tpu_torch.io import euroc, native_loader, png

    what = "live nodes (native loader)"
    paths = [p for fr in euroc.EurocDataset(ds_dir).frames for p in fr.paths if p]
    t0 = time.perf_counter()
    built = native_loader.available()
    t_build = time.perf_counter() - t0
    native_loader.FALLBACKS.reset()
    t0 = time.perf_counter()
    pf = native_loader.ImagePrefetcher(paths)
    for path, img in zip(paths, pf):
        ref = png.decode_image(path)
        if not (np.array_equal(native_loader.decode_image(path), ref)
                and np.array_equal(img, ref)):
            raise RuntimeError(f"{what}: {path} decodes unlike io/png.py's")
    pf.close()
    t_dec = time.perf_counter() - t0
    fallbacks = native_loader.FALLBACKS.frames
    if fallbacks != (0 if built else 2 * len(paths)):
        raise RuntimeError(f"{what}: {fallbacks} decodes fell back to io/png.py with the "
                           f"library {'built' if built else 'missing'}")
    if built:
        q = native_loader.NativeQueue(capacity=2)
        a = np.arange(10, dtype=np.float64)
        ok = (q.push(a) == 0 and q.push(2 * a) == 0 and q.push(3 * a, block=False) == 1
              and np.array_equal(q.pop().view(np.float64), 2 * a)
              and np.array_equal(q.pop().view(np.float64), 3 * a)
              and q.size() == 0 and q.pop(timeout_ms=50) is None)
        q.shutdown()
        if not (ok and q.push(a) == -1):
            raise RuntimeError(f"{what}: the native queue's round trip, drop, timeout or "
                               "shutdown failed")
        queue = "round trip, drop, timeout and shutdown as the reference's tests expect"
    else:
        try:
            native_loader.NativeQueue()
        except RuntimeError:
            queue = "refused without the library, as the JAX package's is"
        else:
            raise RuntimeError(f"{what}: the queue started without its library")
    reason = "" if built else " ({})".format(next(
        (ln.strip() for ln in native_loader.LIBRARY.error.splitlines() if "error" in ln),
        native_loader.LIBRARY.error.strip()))
    print(f"{what}: library built from native/dataloader.cpp: {built}{reason}, "
          f"{t_build:.2f} s; {len(paths)} PNGs decoded by decode_image and the prefetcher, "
          f"equal to io/png.py's bit for bit, in {t_dec:.2f} s; {fallbacks} decodes fell back "
          f"to io/png.py; queue: {queue}")
    return built, fallbacks


def live_nodes_phase(dev, card):
    """The live nodes on the app phase's dataset and config (build/app_phase/,
    written by `app_phase`): (a) the network node, (b) the realsense
    publisher, (c) the native loader.  Returns the fused kernel's launches by
    site."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    app_root = os.path.join(here, "build", "app_phase")
    ds_dir, cfg = os.path.join(app_root, "dataset"), os.path.join(app_root, "okvis2.yaml")
    sites = network_node_phase(dev, card, ds_dir, cfg)
    realsense_check(ds_dir)
    native_loader_check(ds_dir)
    return sites


def gnss_dataset(root, n_frames, **overrides):
    """Write the GNSS phase's dataset (GNSS_DATA, `overrides` applied) for
    `n_frames` frames under `root`/dataset in the extended EuRoC layout with
    its gps0/ stream, and an okvis2.yaml-schema config with online
    extrinsics calibration; returns (dataset dir, config path, true T_SC)."""
    import os
    import shutil

    from okvis2x_tpu_torch.io import synthetic

    shutil.rmtree(root, ignore_errors=True)
    kw = GNSS_DATA | overrides
    ds_dir = os.path.join(root, "dataset")
    cam, T_SC, _ = synthetic.generate(ds_dir, duration=0.3 + n_frames / kw["frame_rate"], **kw)
    fx, fy, cx, cy = (float(v) for v in cam.fxfycxcy)
    rig = types.SimpleNamespace(
        camera=dict(width=cam.width, height=cam.height, fx=fx, fy=fy, cx=cx, cy=cy,
                    dist_params=[float(v) for v in cam.dist_params]),
        T_SC=T_SC)
    cfg = os.path.join(root, "okvis2.yaml")
    app_config(cfg, rig, online_calibration=True)
    return ds_dir, cfg, np.asarray(T_SC, np.float64)


class GnssRecorder:
    """Wraps a `VioPipeline` class's `process_frame` (the JAX package's or the
    port's) while an app runs: the pipeline, each frame's wall time (to the
    end of its device work), and after each frame the GNSS status, T_GW and
    T_SC; also the host time of the estimator's GNSS alignments and of its
    final BA."""

    def __init__(self, pipeline_cls, estimator_cls):
        self.classes = (pipeline_cls, estimator_cls)
        self.pipe = None
        self.wall, self.status, self.T_GW, self.T_SC = [], [], [], []
        self.align_s, self.n_align, self.final_ba_s = 0.0, 0, 0.0

    def __enter__(self):
        pipeline_cls, estimator_cls = self.classes
        self.saved = (pipeline_cls.process_frame, estimator_cls._attempt_gps_alignment,
                      estimator_cls.final_ba)
        process_frame, align, final_ba = self.saved
        rec = self

        def frame(pipe, *args, **kwargs):
            t = time.perf_counter()
            info = process_frame(pipe, *args, **kwargs)
            if getattr(pipe, "device", None) is not None and pipe.device.type == "cuda":
                import torch

                torch.cuda.synchronize(pipe.device)
            rec.wall.append(time.perf_counter() - t)
            rec.pipe = rec.pipe or pipe
            rec.status.append(pipe.est.gps_status)
            rec.T_GW.append(np.array(pipe.est.T_GW, np.float64))
            rec.T_SC.append(np.array(pipe.est.T_SC, np.float64))
            return info

        def timed_align(est):
            t = time.perf_counter()
            align(est)
            rec.align_s += time.perf_counter() - t
            rec.n_align += 1

        def timed_final_ba(est, *args, **kwargs):
            t = time.perf_counter()
            out = final_ba(est, *args, **kwargs)
            rec.final_ba_s += time.perf_counter() - t
            return out

        pipeline_cls.process_frame = frame
        estimator_cls._attempt_gps_alignment = timed_align
        estimator_cls.final_ba = timed_final_ba
        return self

    def __exit__(self, *exc):
        pipeline_cls, estimator_cls = self.classes
        (pipeline_cls.process_frame, estimator_cls._attempt_gps_alignment,
         estimator_cls.final_ba) = self.saved

    def transitions(self):
        """[(frame index, status)] wherever the status changed."""
        out, last = [], "Off"
        for k, st in enumerate(self.status):
            if st != last:
                out.append((k, st))
                last = st
        return out


def tgw_error(T_GW):
    """(yaw error in degrees, translation error in m) of a T_GW against the
    generator's alignment."""
    yaw = 2 * np.arctan2(T_GW[5], T_GW[6])
    dyaw = abs((yaw - TRUE_YAW_G + np.pi) % (2 * np.pi) - np.pi)
    return float(np.degrees(dyaw)), float(np.linalg.norm(np.asarray(T_GW[:3]) - TRUE_T_G))


def _yaw(q):
    from okvis2x_tpu_torch.core import se3np

    R = se3np.quat_to_matrix(q)
    return float(np.arctan2(R[1, 0], R[0, 0]))


def tgw_error_local(T_GW, ts, Ts, gt):
    """`tgw_error` against the generator's alignment carried into the
    estimator's world frame.  The estimator's W is its first state's (at the
    origin, yaw 0) and the ground truth's is the circuit's, so `tgw_error`
    also measures the offset between the two; here the true T_GW is composed
    with the 4-dof transform that takes the first frame's estimated pose onto
    its true pose.  Returns (yaw error in degrees, translation error in m)."""
    from okvis2x_tpu_torch.core import se3np
    from okvis2x_tpu_torch.io import trajectory_io

    _, ib = trajectory_io.associate(ts[:1], gt[:, 0])
    g0 = gt[ib[0]]
    q = se3np.delta_q(np.array([0.0, 0.0, _yaw(g0[4:8]) - _yaw(Ts[0, 3:7])]))
    T_local = np.concatenate([g0[1:4] - se3np.quat_rotate(q, Ts[0, :3]), q])
    true = se3np.se3_multiply(np.concatenate([TRUE_T_G, se3np.delta_q(
        np.array([0.0, 0.0, TRUE_YAW_G]))]), T_local)
    dyaw = abs((_yaw(T_GW[3:7]) - _yaw(true[3:7]) + np.pi) % (2 * np.pi) - np.pi)
    return float(np.degrees(dyaw)), float(np.linalg.norm(np.asarray(T_GW[:3]) - true[:3]))


def ate_global(T_GW, ts, Ts, gt):
    """The unaligned RMSE of the trajectory mapped into the GNSS frame through
    `T_GW` against the true G-frame ground truth (`_ate_global` of
    tools/gnss_scale_run.py): what a GNSS user reads."""
    from okvis2x_tpu_torch.core import se3np
    from okvis2x_tpu_torch.io import trajectory_io

    p_G = se3np.se3_apply(np.asarray(T_GW, np.float64), Ts[:, :3])
    Rg = se3np.quat_to_matrix(se3np.delta_q(np.array([0.0, 0.0, TRUE_YAW_G])))
    ia, ib = trajectory_io.associate(ts, gt[:, 0])
    if len(ia) < 3:
        return float("nan")
    err = np.linalg.norm(p_G[ia] - (gt[ib, 1:4] @ Rg.T + TRUE_T_G), axis=1)
    return float(np.sqrt((err ** 2).mean()))


def gnss_metrics(rec, ds_dir, out, T_SC_true):
    """What the GNSS phase checks, from a recorded app run that wrote its
    trajectories to `out`."""
    import os

    from okvis2x_tpu_torch.core import se3np
    from okvis2x_tpu_torch.io import trajectory_io, xdataset

    gt = xdataset.XDataset(ds_dir).ground_truth
    ts, Ts = trajectory_io.read_tum(os.path.join(out, "trajectory.tum"))
    fts, fTs = trajectory_io.read_tum(os.path.join(out, "final_trajectory.tum"))
    T_GW = np.asarray(rec.pipe.est.T_GW, np.float64)
    T_SC = np.asarray(rec.pipe.est.T_SC, np.float64)
    yaw_deg, t_m = tgw_error(T_GW)
    local_yaw_deg, local_t_m = tgw_error_local(T_GW, ts, Ts, gt)
    dq = [se3np.quat_multiply(se3np.quat_conjugate(a[3:7]), b[3:7])
          for a, b in zip(T_SC, T_SC_true)]
    return dict(
        transitions=rec.transitions(), status=rec.status[-1], T_GW=T_GW.tolist(),
        yaw_deg=yaw_deg, t_m=t_m, local_yaw_deg=local_yaw_deg, local_t_m=local_t_m,
        ate_online_m=float(trajectory_io.ate_rmse(ts, Ts[:, :3], gt[:, 0], gt[:, 1:4])),
        ate_final_m=float(trajectory_io.ate_rmse(fts, fTs[:, :3], gt[:, 0], gt[:, 1:4])),
        ate_global_online_m=ate_global(T_GW, ts, Ts, gt),
        ate_global_final_m=ate_global(T_GW, fts, fTs, gt),
        T_SC_moved_m=float(np.linalg.norm(T_SC[:, :3] - T_SC_true[:, :3], axis=1).max()),
        T_SC_moved_rad=float(max(np.linalg.norm(se3np.quat_log(q)) for q in dq)),
        n_frames=len(ts), n_final=len(fts), n_align=rec.n_align, align_ms=rec.align_s * 1e3,
        final_ba_s=rec.final_ba_s,
    )


def gnss_bound(what, jax_value, floor):
    """Twice the JAX app's value on the same frames, or `floor` if larger."""
    if jax_value is None:
        raise RuntimeError(f"no JAX reference value for {what}")
    return max(2.0 * jax_value, floor)


def gnss_phase(dev, card):
    """The port's app in slam mode, as a user runs it, on a GNSS dataset with
    online extrinsics calibration: GNSS_FRAMES frames of the flagship circuit
    written with its gps0/ stream under build/gnss_phase/ (`gnss_dataset`),
    `okvis2x_app.main(--mode slam --reader xdataset)` on the default device
    (cuda:0) or on `dev` when that is the CPU.  Checks that the GNSS status
    reaches "Initialised", that at least one window solve carried a GNSS
    row, the online and final ATE, the T_GW errors and the global ATE
    against the JAX app's on the same frames (JAX_GNSS); prints how far T_SC
    moved, the frame times, the solve, alignment and final-BA times and the
    peak memory.  Returns the fused kernel's launches by site."""
    import os

    import torch
    from okvis2x_tpu_torch.apps import okvis2x_app
    from okvis2x_tpu_torch.graph.estimator import SlidingWindowEstimator
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline
    from okvis2x_tpu_torch.utils import timing

    what = "GNSS"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "gnss_phase")
    t0 = time.perf_counter()
    ds_dir, cfg, T_SC_true = gnss_dataset(root, GNSS_FRAMES)
    t_data = time.perf_counter() - t0
    out = os.path.join(root, "out")
    argv = ["--dataset", ds_dir, "--config", cfg, "--mode", "slam", "--reader", "xdataset",
            "--output", out, "--max-frames", str(GNSS_FRAMES)]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    else:
        torch.cuda.reset_peak_memory_stats(dev)
    timing.reset()
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    with GnssRecorder(VioPipeline, SlidingWindowEstimator) as rec:
        okvis2x_app.main(argv)
    t_run = time.perf_counter() - t0
    sites = dict(hamming.hamming_match.site_launches)
    ERRORS.check(what)
    vio = rec.pipe
    if vio.device != dev:
        raise RuntimeError(f"{what}: the app ran on {vio.device}, not {dev}")
    m = gnss_metrics(rec, ds_dir, out, T_SC_true)
    if m["n_frames"] != GNSS_FRAMES:
        raise RuntimeError(f"{what}: trajectory.tum has {m['n_frames']} rows for {GNSS_FRAMES}")
    if "Initialised" not in rec.status or m["status"] != "Initialised":
        raise RuntimeError(f"{what}: the GNSS status went {m['transitions']}, not to Initialised")
    if vio.est.n_gps_solves < 1:
        raise RuntimeError(f"{what}: no window solve carried a GNSS row")
    for k in ("ate_online_m", "ate_final_m"):
        if not m[k] <= ATE_LIMIT_M:
            raise RuntimeError(f"{what}: {k} {m[k]} exceeds {ATE_LIMIT_M} m")
    bounds = {k: gnss_bound(k, JAX_GNSS[k], 1.0 if k.endswith("deg") else 0.05)
              for k in JAX_GNSS}
    for k, b in bounds.items():
        if not m[k] <= b:
            raise RuntimeError(f"{what}: {k} {m[k]} exceeds {b} (twice the JAX app's "
                               f"{JAX_GNSS[k]}, floor applied)")
    if dev.type == "cuda" and (sites.get("assoc", 0) <= 0 or sites.get("bow", 0) <= 0):
        raise RuntimeError(f"{what}: the fused kernel's launches by site {sites} lack the "
                           "association or the vocabulary descent")
    ms = np.asarray(rec.wall) * 1e3
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB" if dev.type == "cuda"
            else "not measured")
    print(f"{what}: dataset of {GNSS_FRAMES} frames with gps0/ written in {t_data:.1f} s; "
          f"okvis2x_app --mode slam, online calibration, on {vio.device}: {t_run:.1f} s; "
          f"status by frame {m['transitions']}, {vio.est.n_gps_solves} solves with a GNSS row, "
          f"{m['n_align']} alignment attempts ({m['align_ms']:.3f} ms of host time in all); "
          f"T_GW {np.round(m['T_GW'], 4).tolist()}, error against the generator's yaw "
          f"{m['yaw_deg']:.4f} deg (bound {bounds['yaw_deg']:.4f}), translation {m['t_m']:.4f} m "
          f"(bound {bounds['t_m']:.4f}), in the estimator's world frame yaw "
          f"{m['local_yaw_deg']:.4f} deg (bound {bounds['local_yaw_deg']:.4f}), translation "
          f"{m['local_t_m']:.4f} m (bound {bounds['local_t_m']:.4f}); global ATE online "
          f"{m['ate_global_online_m']:.4f} m (bound {bounds['ate_global_online_m']:.4f}), final "
          f"{m['ate_global_final_m']:.4f} m (bound {bounds['ate_global_final_m']:.4f}); ATE "
          f"online {m['ate_online_m']:.4f} m, final {m['ate_final_m']:.4f} m over {m['n_final']} "
          f"states; T_SC moved {m['T_SC_moved_m'] * 1e3:.3f} mm / {m['T_SC_moved_rad']:.6f} rad; "
          f"ms/frame p50 {np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max "
          f"{ms.max():.1f}; window solve (2.5 CollectSolve) mean "
          f"{timing.mean_ms('2.5 CollectSolve'):.2f} ms, 3.1 BuildProblem "
          f"{timing.mean_ms('3.1 BuildProblem'):.2f} ms; final BA with extrinsics "
          f"{m['final_ba_s']:.2f} s; peak allocated {peak}; fused match launches by site "
          f"{sites} ({card})")
    return sites


def depth_dataset(root, mode, n_frames):
    """Write the dataset of the `mode` phase (DEPTH_DATA) for `n_frames`
    frames under `root`/dataset in the extended EuRoC layout (with cam0's
    depth0/ stream for rgbd), an okvis2.yaml-schema config (cam0 an rgb
    camera for the depth mode) and, for the depth mode, DEPTH_SE2 as an
    se2.yaml; returns (dataset dir, the app's arguments without the
    device)."""
    import os
    import shutil

    from okvis2x_tpu_torch.io import synthetic

    shutil.rmtree(root, ignore_errors=True)
    kw = DEPTH_DATA[mode]
    ds_dir = os.path.join(root, "dataset")
    cam, T_SC, _ = synthetic.generate(ds_dir, duration=0.3 + n_frames / kw["frame_rate"], **kw)
    fx, fy, cx, cy = (float(v) for v in cam.fxfycxcy)
    rig = types.SimpleNamespace(
        camera=dict(width=cam.width, height=cam.height, fx=fx, fy=fy, cx=cx, cy=cy,
                    dist_params=[float(v) for v in cam.dist_params]),
        T_SC=T_SC)
    cfg = os.path.join(root, "okvis2.yaml")
    app_config(cfg, rig, camera_type="rgb" if mode == "depth" else "gray")
    argv = ["--dataset", ds_dir, "--config", cfg, "--mode", mode, "--reader", "xdataset",
            "--output", os.path.join(root, "out"), "--max-frames", str(n_frames)]
    if mode == "depth":
        se2 = os.path.join(root, "se2.yaml")
        with open(se2, "w") as f:
            f.write(DEPTH_SE2)
        argv += ["--se2-config", se2]
    return ds_dir, argv


class DepthRecorder:
    """Wraps, while an app runs in a depth mode (the JAX package's or the
    port's classes): `process_frame` (each frame's wall time to the end of
    its device work, the pipeline), `attach_depth_priors` (the priors
    attached) and `SubmappingInterface.integrate_depth` (the depth images
    integrated)."""

    def __init__(self, pipeline_cls, submapping_cls):
        self.classes = (pipeline_cls, submapping_cls)
        self.pipe, self.wall, self.n_priors, self.n_integrated = None, [], 0, 0
        self.frames = []  # (t, fid, is_keyframe) of each frame, as process_frame reported
        self.last_integration = None  # the arguments of the last integration
        self.submapping = None  # the interface that integrated them

    def __enter__(self):
        pipeline_cls, submapping_cls = self.classes
        self.saved = (pipeline_cls.process_frame, pipeline_cls.attach_depth_priors,
                      submapping_cls.integrate_depth)
        process_frame, attach, integrate = self.saved
        rec = self

        def frame(pipe, *args, **kwargs):
            t = time.perf_counter()
            info = process_frame(pipe, *args, **kwargs)
            if getattr(pipe, "device", None) is not None and pipe.device.type == "cuda":
                import torch

                torch.cuda.synchronize(pipe.device)
            rec.wall.append(time.perf_counter() - t)
            rec.pipe = rec.pipe or pipe
            rec.frames.append((args[0], info["fid"], info["is_keyframe"]))
            return info

        def attached(pipe, *args, **kwargs):
            n = attach(pipe, *args, **kwargs)
            rec.n_priors += n
            return n

        def integrated(si, *args, **kwargs):
            rec.n_integrated += 1
            rec.last_integration, rec.submapping = args, si
            return integrate(si, *args, **kwargs)

        pipeline_cls.process_frame = frame
        pipeline_cls.attach_depth_priors = attached
        submapping_cls.integrate_depth = integrated
        return self

    def __exit__(self, *exc):
        pipeline_cls, submapping_cls = self.classes
        (pipeline_cls.process_frame, pipeline_cls.attach_depth_priors,
         submapping_cls.integrate_depth) = self.saved


def ply_vertices(path):
    """(vertex count, whether the vertices carry RGB) of an ASCII PLY."""
    head = []
    with open(path) as f:
        for ln in f:
            if ln.strip() == "end_header":
                break
            head.append(ln)
    n = int(next(ln for ln in head if ln.startswith("element vertex")).split()[2])
    return n, any("uchar red" in ln for ln in head)


def grid_stats(si):
    """The occupancy grids of an app's submapping interface (the JAX
    package's or the port's) summed over its submaps: the submaps, the
    integration counts, the log-odds, the voxels observed (count > 0), those
    with positive log-odds (surface evidence) and those above 1.0 (map.ply's
    threshold); for brick-sparse grids over their pools' voxels, with the
    bricks allocated (`bricks`)."""
    import torch

    def host(x):
        return (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(np.float64)

    bricks = [e.sm for e in si.maps if hasattr(e.sm, "pool_lo")]
    if bricks:  # the pool's voxels (the trash voxel left out) and the bricks allocated
        weight = [host(sm.pool_w[:-1]) for sm in bricks]
        logodds = [host(sm.pool_lo[:-1]) for sm in bricks]
    else:
        weight = [host(e.sm.weight) for e in si.maps]
        logodds = [host(e.sm.logodds) for e in si.maps]
    out = dict(n_submaps=len(si.maps), total_weight=float(sum(w.sum() for w in weight)),
               logodds_sum=float(sum(lo.sum() for lo in logodds)),
               observed_voxels=int(sum((w > 0).sum() for w in weight)),
               positive_voxels=int(sum((lo > 0).sum() for lo in logodds)),
               voxels_above_1=int(sum((lo > 1.0).sum() for lo in logodds)))
    if bricks:
        out["bricks"] = int(sum(int(sm.n_alloc) for sm in bricks))
    return out


def read_ply_points(path):
    """The vertices (N, 3) and their RGB (N, 3; None without colour) of an
    ASCII point PLY as `export_occupied_ply` writes it."""
    n, rgb = ply_vertices(path)
    with open(path) as f:
        for ln in f:
            if ln.strip() == "end_header":
                break
        rows = np.loadtxt(f, ndmin=2).reshape(n, 6 if rgb else 3)
    return rows[:, :3], (rows[:, 3:] if rgb else None)


def export_stats(si, path, threshold):
    """An app's occupied-voxel export (its submapping interface's, either
    package's) at log-odds `threshold`, written to `path` and read back: the
    points, their mean position, their mean colour (0-255) and their count in
    each EXPORT_CELL_M cube of the world ("i,j,k": n)."""
    import collections

    n = si.export_occupied_ply(path, threshold)
    pts, rgb = read_ply_points(path)
    cells = collections.Counter(map(tuple, np.floor(pts / EXPORT_CELL_M).astype(int).tolist()))
    return dict(export_points=int(n), export_mean_m=pts.mean(0).tolist() if n else None,
                export_rgb_mean=rgb.mean(0).tolist() if n and rgb is not None else None,
                export_cells={",".join(map(str, k)): v for k, v in sorted(cells.items())})


def check_export(what, ex, ref):
    """Holds `export_stats` to the JAX app's `ref`: the points and the cubes'
    counts (their L1 distance) within MAP_POINTS_TOL of its points, the mean
    position within EXPORT_MEAN_TOL_M, the mean colour within EXPORT_RGB_TOL."""
    n_ref = ref["export_points"]
    cells = set(ex["export_cells"]) | set(ref["export_cells"])
    l1 = sum(abs(ex["export_cells"].get(c, 0) - ref["export_cells"].get(c, 0)) for c in cells)
    mean_gap = (float(np.abs(np.subtract(ex["export_mean_m"], ref["export_mean_m"])).max())
                if ex["export_points"] else np.inf)
    rgb_gap = (float(np.abs(np.subtract(ex["export_rgb_mean"], ref["export_rgb_mean"])).max())
               if ex["export_rgb_mean"] is not None else np.inf)
    print(f"{what}: export at log-odds > {FINE_EXPORT_THRESHOLD}: {ex['export_points']} points "
          f"(JAX app {n_ref}), {len(ex['export_cells'])} cubes of {EXPORT_CELL_M} m "
          f"({len(ref['export_cells'])}), L1 of their counts {l1}; mean position gap "
          f"{mean_gap:.2e} m, mean colour gap {rgb_gap:.2e} of 255")
    if not (n_ref > 0 and abs(ex["export_points"] - n_ref) <= MAP_POINTS_TOL * n_ref
            and l1 <= MAP_POINTS_TOL * n_ref):
        raise RuntimeError(f"{what}: the export has {ex['export_points']} points, L1 {l1} over "
                           f"the cubes, the JAX app's {n_ref} points (tolerance "
                           f"{MAP_POINTS_TOL:.0%})")
    if not mean_gap <= EXPORT_MEAN_TOL_M or not rgb_gap <= EXPORT_RGB_TOL:
        raise RuntimeError(f"{what}: the export's mean position differs from the JAX app's by "
                           f"{mean_gap} m (tolerance {EXPORT_MEAN_TOL_M}), its mean colour by "
                           f"{rgb_gap} (tolerance {EXPORT_RGB_TOL})")


def depth_metrics(rec, ds_dir, out):
    """What the depth phases check, from a recorded app run that wrote its
    trajectories and map.ply to `out`: the ATEs, the priors, the keyframes
    integrated, map.ply's points and `grid_stats`."""
    import os

    from okvis2x_tpu_torch.io import trajectory_io, xdataset

    gt = xdataset.XDataset(ds_dir).ground_truth
    ts, Ts = trajectory_io.read_tum(os.path.join(out, "trajectory.tum"))
    fts, fTs = trajectory_io.read_tum(os.path.join(out, "final_trajectory.tum"))
    n_map, rgb = ply_vertices(os.path.join(out, "map.ply"))
    return dict(
        ate_online_m=float(trajectory_io.ate_rmse(ts, Ts[:, :3], gt[:, 0], gt[:, 1:4])),
        ate_final_m=float(trajectory_io.ate_rmse(fts, fTs[:, :3], gt[:, 0], gt[:, 1:4])),
        n_frames=len(ts), n_final=len(fts), n_priors=rec.n_priors,
        n_integrated=rec.n_integrated, map_points=n_map, map_rgb=rgb,
        **grid_stats(rec.submapping),
    )


class FusionCapture:
    """Keeps the inputs of the port's last stereo and multi-view depth calls
    while the app runs (the module functions the app's keyframe stage
    calls)."""

    def __enter__(self):
        from okvis2x_tpu_torch.models import mvs, stereo

        self.mods = (stereo, mvs)
        self.saved = (stereo.stereo_depth, mvs.mvs_depth)
        stereo_depth, mvs_depth = self.saved
        self.stereo_args = self.mvs_args = None

        def st(*args, **kwargs):
            self.stereo_args = (args, kwargs)
            return stereo_depth(*args, **kwargs)

        def mv(*args, **kwargs):
            self.mvs_args = (args, kwargs)
            return mvs_depth(*args, **kwargs)

        stereo.stereo_depth, mvs.mvs_depth = st, mv
        return self

    def __exit__(self, *exc):
        stereo, mvs = self.mods
        stereo.stereo_depth, mvs.mvs_depth = self.saved


def depth_device_checks(dev, card, cap, integration):
    """On one keyframe's inputs (the last fusion of the RGB-D phase and its
    integration's camera and poses): the fused depth on the card against the
    port's on the CPU, the card's 128^3 grid after integrating it against the
    CPU's, and the device times of the two nets, of the fusion and of one
    integration (CUDA events)."""
    import torch
    from okvis2x_tpu_torch.apps.okvis2x_app import fused_depth
    from okvis2x_tpu_torch.core import se3
    from okvis2x_tpu_torch.mapping import submap
    from okvis2x_tpu_torch.models import mvs_net, stereo_net

    (left, right, fx, baseline), _ = cap.stereo_args
    (_, srcs, K, T_rs), _ = cap.mvs_args
    _, T_WK, T_WC, cam = integration[:4]
    d_card, s_card = fused_depth(left, right, fx, baseline, srcs, K, T_rs)
    cpu = [x.cpu() for x in (left, right, srcs, K, T_rs)]
    d_cpu, s_cpu = fused_depth(cpu[0], cpu[1], fx, baseline, *cpu[2:])
    d_card, s_card = d_card.cpu(), s_card.cpu()
    both = (d_card > 0) & (d_cpu > 0)
    mask_diff = float(((d_card > 0) != (d_cpu > 0)).double().mean())
    err = float((d_card - d_cpu)[both].abs().max()) if bool(both.any()) else 0.0
    if not err <= FUSED_TOL_M or not mask_diff <= FUSED_MASK_TOL:
        raise RuntimeError(f"RGB-D: the card's fused depth is {err} m from the CPU's where both "
                           f"are valid and the valid masks differ on {mask_diff:.2e} of the "
                           f"pixels (bounds {FUSED_TOL_M} m, {FUSED_MASK_TOL})")
    # the same fused depth three times into a 128^3 grid (a voxel moves by
    # at most log_odd_occ an integration) at the keyframe's camera pose in
    # its anchor, on the card and on the CPU
    cfg = submap.SubmapConfig()
    T_KC = se3.se3_multiply(
        se3.se3_inverse(torch.as_tensor(np.asarray(T_WK), dtype=torch.float32)).double(),
        torch.as_tensor(np.asarray(T_WC, np.float64))).float()
    grids = {}
    for where in ("card", "cpu"):
        dv = dev if where == "card" else torch.device("cpu")
        sm = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, device=dv)
        for _ in range(3):
            sm = submap.integrate_depth_image(sm, cfg, cam.to(device=dv), T_KC.to(dv),
                                              d_card.float().to(dv), s_card.float().to(dv))
        grids[where] = sm
    a, b = grids["card"], grids["cpu"]
    occ = {t: [set(map(tuple, (x.logodds > t).nonzero().cpu().numpy().tolist())) for x in (a, b)]
           for t in (0.3, 1.0)}
    if not torch.equal(a.weight.cpu(), b.weight) or any(o[0] != o[1] for o in occ.values()):
        raise RuntimeError("RGB-D: the card's 128^3 grid differs from the CPU's: counts equal "
                           f"{torch.equal(a.weight.cpu(), b.weight)}, occupied sets "
                           f"{[(len(o[0]), len(o[1]), len(o[0] ^ o[1])) for o in occ.values()]}")
    lo_err = float((a.logodds.cpu() - b.logodds).abs().max())
    if not lo_err <= 1e-5:
        raise RuntimeError(f"RGB-D: the card's log-odds are {lo_err} from the CPU's")

    print(f"RGB-D on one keyframe's inputs ({left.shape[1]}x{left.shape[0]}): fused depth on "
          f"{dev} vs the CPU max |err| {err:.3e} m where both are valid ({int(both.sum())} "
          f"pixels), valid masks differ on {mask_diff:.2e}; 128^3 grid {dev} vs CPU: counts "
          f"equal, log-odds max |err| {lo_err:.2e}, occupied voxels (>1.0) {len(occ[1.0][0])}, "
          f"(>0.3) {len(occ[0.3][0])}, equal ({card})")
    if dev.type != "cuda":
        return None
    # device times at the keyframe's shape
    snet, _ = stereo_net.trained(str(stereo_net.DEFAULT_WEIGHTS), 64, str(dev))
    mnet, _ = mvs_net.trained(str(mvs_net.DEFAULT_WEIGHTS), str(dev))
    fxfycxcy = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    T_sr7 = se3.se3_inverse(T_rs)
    M = torch.eye(4, device=dev).repeat(2, 1, 1)
    M[:, :3, :3] = se3.quat_to_matrix(se3.se3_q(T_sr7))
    M[:, :3, 3] = T_sr7[:, :3]
    dd, ss = d_card.float().to(dev), s_card.float().to(dev)
    sm0 = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, device=dev)
    with torch.no_grad():
        times = dict(
            stereo_net_ms=time_ms(lambda: snet(left, right), 10),
            mvs_net_ms=time_ms(lambda: mnet(left, srcs, fxfycxcy, M), 5),
            fusion_ms=time_ms(lambda: fused_depth(left, right, fx, baseline, srcs, K, T_rs), 5),
            integrate_ms=time_ms(lambda: submap.integrate_depth_image(
                sm0, cfg, cam.to(device=dev), T_KC.to(dev), dd, ss), 10))
        peaks = dict(
            stereo_net=peak_mib(lambda: snet(left, right)),
            mvs_net=peak_mib(lambda: mnet(left, srcs, fxfycxcy, M)),
            integrate=peak_mib(lambda: submap.integrate_depth_image(
                sm0, cfg, cam.to(device=dev), T_KC.to(dev), dd, ss)))
    _, p_K, ok = submap.depth_rays(cam.to(device=dev), T_KC.to(dev), dd, 4, 20.0)
    n_rays = int(ok.numel())
    print(f"RGB-D device times at {left.shape[1]}x{left.shape[0]} (CUDA events, mean of the "
          f"calls): StereoNet "
          f"{times['stereo_net_ms']:.3f} ms, MvsNet {times['mvs_net_ms']:.3f} ms, stereo + MVS "
          f"+ fusion {times['fusion_ms']:.3f} ms, one integration of {n_rays} rays x "
          f"{cfg.samples_per_ray + cfg.band_samples} samples into the 128^3 grid "
          f"{times['integrate_ms']:.3f} ms; peak memory above the inputs: StereoNet "
          f"{peaks['stereo_net']:.1f} MiB, MvsNet {peaks['mvs_net']:.1f} MiB, one integration "
          f"{peaks['integrate']:.1f} MiB ({card})")
    return times


def depth_phase(dev, card, mode):
    """The port's app in `mode` (rgbd or depth), as a user runs it, on the
    phase's dataset (`depth_dataset`): RGBD_FRAMES frames of the 0.8 m
    circuit with depth0/ (rgbd) or DEPTH_FRAMES frames of the sinusoid scene
    with cam0 an rgb camera and DEPTH_SE2 (depth), both at 752x480, under
    build/<mode>_phase/, `okvis2x_app.main(--mode <mode> --reader xdataset)`
    on the default device (cuda:0) or on `dev` when that is the CPU.  Checks
    the ATEs, the depth priors, the keyframes fused, map.ply and the grids
    (`grid_stats`) against the JAX app's on the same frames (JAX_DEPTH), RGB
    in map.ply in depth mode; in rgbd mode on the card also
    `depth_device_checks`.  Prints the stage means, the peak memory and the
    launches by site; returns them, the recorder (its submapping interface
    and last integration), the fusion capture and the dataset's directory."""
    import os

    import torch
    from okvis2x_tpu_torch.apps import okvis2x_app
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.pipeline.submapping import SubmappingInterface
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline
    from okvis2x_tpu_torch.utils import timing

    what = "RGB-D" if mode == "rgbd" else "depth mode"
    n_frames = RGBD_FRAMES if mode == "rgbd" else DEPTH_FRAMES
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", f"{mode}_phase")
    t0 = time.perf_counter()
    ds_dir, argv = depth_dataset(root, mode, n_frames)
    t_data = time.perf_counter() - t0
    out = os.path.join(root, "out")
    start_mib = None
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    else:
        start_mib = torch.cuda.memory_allocated(dev) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
    timing.reset()
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    with DepthRecorder(VioPipeline, SubmappingInterface) as rec, FusionCapture() as cap:
        okvis2x_app.main(argv)
    t_run = time.perf_counter() - t0
    sites = dict(hamming.hamming_match.site_launches)
    ERRORS.check(what)
    vio = rec.pipe
    if vio.device != dev:
        raise RuntimeError(f"{what}: the app ran on {vio.device}, not {dev}")
    m = depth_metrics(rec, ds_dir, out)
    ref = JAX_DEPTH[mode]
    if m["n_frames"] != n_frames:
        raise RuntimeError(f"{what}: trajectory.tum has {m['n_frames']} rows for {n_frames}")
    bounds = {k: max(2.0 * ref[k], 0.05) for k in ("ate_online_m", "ate_final_m")}
    for k, b in bounds.items():
        if not m[k] <= min(b, ATE_LIMIT_M):
            raise RuntimeError(f"{what}: {k} {m[k]} exceeds {min(b, ATE_LIMIT_M)} m (twice the "
                               f"JAX app's {ref[k]} m, floor 0.05 m, and at most {ATE_LIMIT_M})")
    if mode == "rgbd" and not m["n_priors"] > 0:
        raise RuntimeError(f"{what}: no depth prior was attached")
    if not m["n_integrated"] >= ref["n_integrated"]:
        raise RuntimeError(f"{what}: {m['n_integrated']} keyframes integrated, the JAX app "
                           f"{ref['n_integrated']}")
    if not abs(m["map_points"] - ref["map_points"]) <= MAP_POINTS_TOL * ref["map_points"]:
        raise RuntimeError(f"{what}: map.ply has {m['map_points']} points, the JAX app's "
                           f"{ref['map_points']} (tolerance {MAP_POINTS_TOL:.0%})")
    if m["n_submaps"] != ref["n_submaps"]:
        raise RuntimeError(f"{what}: {m['n_submaps']} submaps, the JAX app {ref['n_submaps']}")
    for k in ("total_weight", "logodds_sum", "observed_voxels", "positive_voxels"):
        if not (ref[k] != 0 and abs(m[k] - ref[k]) <= GRID_TOL * abs(ref[k])):
            raise RuntimeError(f"{what}: the grids' {k} is {m[k]}, the JAX app's {ref[k]} "
                               f"(tolerance {GRID_TOL:.0%})")
    if mode == "depth" and not (m["map_points"] > 0 and m["map_rgb"]):
        raise RuntimeError(f"{what}: map.ply has {m['map_points']} points, RGB {m['map_rgb']}")
    if dev.type == "cuda" and sites.get("assoc", 0) <= 0:
        raise RuntimeError(f"{what}: the fused kernel's launches by site {sites} lack the "
                           "association")
    ms = np.asarray(rec.wall) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None)
    stage = "9 DepthFusionAndIntegrate" if mode == "rgbd" else "9 DepthAndIntegrate"
    print(f"{what}: dataset of {n_frames} frames with depth0/ written in {t_data:.1f} s; "
          f"okvis2x_app --mode {mode} on {vio.device}: {t_run:.1f} s; ATE online "
          f"{m['ate_online_m']:.4f} m (bound {min(bounds['ate_online_m'], ATE_LIMIT_M):.4f}), "
          f"final {m['ate_final_m']:.4f} m (bound {min(bounds['ate_final_m'], ATE_LIMIT_M):.4f}) "
          f"over {m['n_final']} states; {m['n_priors']} depth priors attached; "
          f"{m['n_integrated']} keyframes integrated (JAX app {ref['n_integrated']}); map.ply "
          f"{m['map_points']} points, RGB {m['map_rgb']} (JAX app {ref['map_points']}); grids: "
          f"{m['n_submaps']} submaps, counts {m['total_weight']:.0f} (JAX app "
          f"{ref['total_weight']:.0f}), log-odds sum {m['logodds_sum']:.1f} "
          f"({ref['logodds_sum']:.1f}), observed {m['observed_voxels']} "
          f"({ref['observed_voxels']}), log-odds > 0 {m['positive_voxels']} "
          f"({ref['positive_voxels']}), > 1.0 {m['voxels_above_1']} "
          f"({ref['voxels_above_1']}); ms/frame "
          f"p50 {np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max {ms.max():.1f}; "
          f"{stage} mean {timing.mean_ms(stage):.2f} ms, window solve (2.5 CollectSolve) mean "
          f"{timing.mean_ms('2.5 CollectSolve'):.2f} ms, 3.2 SolveDevice mean "
          f"{timing.mean_ms('3.2 SolveDevice'):.2f} ms; peak allocated "
          f"{'not measured' if peak is None else f'{peak:.1f} MiB ({start_mib:.1f} at the start)'}"
          f"; fused match launches by "
          f"site {sites} ({card})")
    if mode == "rgbd":
        depth_device_checks(dev, card, cap, rec.last_integration)
    return sites, rec, cap, ds_dir


def async_submapping_phase(dev, card, rec, ds_dir):
    """(d) The RGB-D phase's depth0/ frames and online states through the
    port's `AsyncSubmapping` on the card: state k, then depth frame k, each
    next step once the runner has integrated the last (so that every frame is
    anchored to the newest keyframe of its time, as in the app), into a
    grid of the app's configuration; the same items (the newest keyframe,
    the frame's pose composed with cam0's extrinsics, its depth) through the
    synchronous `SubmappingInterface` on the card: counts equal, log-odds
    within 1e-5, `n_integrated` equal to the frames fed."""
    import torch
    from okvis2x_tpu_torch import api
    from okvis2x_tpu_torch.core import se3
    from okvis2x_tpu_torch.io import xdataset
    from okvis2x_tpu_torch.pipeline.submapping import SubmappingInterface
    from okvis2x_tpu_torch.pipeline.submapping_runner import AsyncSubmapping

    what = "asynchronous submapping"
    vio, cfg = rec.pipe, rec.submapping.cfg
    ds = xdataset.XDataset(ds_dir)
    depth_at = {round(t, 6): p for t, p in ds.depth_frames}
    cam, T_SC = vio.cameras[0], np.asarray(vio.T_SC[0], np.float64)
    items = []
    for (t, fid, is_kf), (t_log, T_WS) in zip(rec.frames, vio.states_log):
        if abs(t - t_log) > 1e-9 or round(t, 6) not in depth_at:
            raise RuntimeError(f"{what}: frame {fid} at {t} has no state or no depth image")
        items.append((api.State(id=fid, timestamp=t, T_WS=np.asarray(T_WS, np.float64),
                                v_W=np.zeros(3), b_g=np.zeros(3), b_a=np.zeros(3),
                                omega_S=np.zeros(3), is_keyframe=bool(is_kf)),
                      ds.load_depth(depth_at[round(t, 6)])))
    limit_s = 60.0
    t0 = time.perf_counter()
    runner = AsyncSubmapping(SubmappingInterface(cfg, device=dev), cam=cam, T_SC=T_SC)
    for k, (st, depth) in enumerate(items):
        runner.state_update_callback(st)
        runner.add_depth_measurement(st.timestamp, depth)
        while runner.n_integrated < k + 1 and time.perf_counter() - t0 < limit_s:
            time.sleep(0.001)
    runner.finish()
    for th in (runner._t_assembly, runner._t_integrate):
        th.join(limit_s)
        if th.is_alive():
            raise RuntimeError(f"{what}: {th.name} did not stop")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_async = time.perf_counter() - t0
    ERRORS.check(what)
    if runner.n_integrated != len(items) or runner.n_dropped:
        raise RuntimeError(f"{what}: {runner.n_integrated} of {len(items)} frames integrated, "
                           f"{runner.n_dropped} dropped")
    t0 = time.perf_counter()
    si = SubmappingInterface(cfg, device=dev)
    kf = None
    for st, depth in items:
        kf = (st.id, st.T_WS) if st.is_keyframe else kf
        T_WC = se3.se3_multiply(torch.as_tensor(st.T_WS), torch.as_tensor(T_SC)).numpy()
        si.integrate_depth(kf[0], kf[1], T_WC, cam, depth)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_sync = time.perf_counter() - t0
    a, b = runner.si.maps, si.maps
    same = len(a) == len(b) and all(
        x.anchor_fid == y.anchor_fid and x.n_frames == y.n_frames
        and torch.equal(x.sm.weight, y.sm.weight) for x, y in zip(a, b))
    lo_err = max((float((x.sm.logodds - y.sm.logodds).abs().max()) for x, y in zip(a, b)),
                 default=np.inf)
    if not same or not lo_err <= 1e-5:
        raise RuntimeError(f"{what}: the asynchronous grids differ from the synchronous ones: "
                           f"{len(a)} and {len(b)} submaps, counts equal {same}, log-odds "
                           f"max |err| {lo_err}")
    stats = grid_stats(runner.si)
    print(f"{what}: the RGB-D phase's {len(items)} depth frames and online states "
          f"({sum(st.is_keyframe for st, _ in items)} keyframes) through AsyncSubmapping on "
          f"{dev} in {t_async:.2f} s ({runner.n_integrated} integrated, none dropped, both "
          f"threads joined); the synchronous SubmappingInterface on the same items in "
          f"{t_sync:.2f} s: {len(a)} submaps, counts equal ({stats['total_weight']:.0f}), "
          f"log-odds max |err| {lo_err:.2e}, {stats['positive_voxels']} voxels with log-odds "
          f"> 0 ({card})")


def fine_args(ds_dir, root, n_frames=FINE_FRAMES):
    """The app's arguments for the fine-grid run on the depth phase's dataset
    `ds_dir` (its okvis2.yaml beside it) with FINE_SE2 written under `root`,
    output in `root`/out, without the device."""
    import os

    os.makedirs(root, exist_ok=True)
    se2 = os.path.join(root, "se2.yaml")
    with open(se2, "w") as f:
        f.write(FINE_SE2)
    return ["--dataset", ds_dir, "--config", os.path.join(os.path.dirname(ds_dir), "okvis2.yaml"),
            "--mode", "depth", "--reader", "xdataset", "--se2-config", se2,
            "--output", os.path.join(root, "out"), "--max-frames", str(n_frames)]


def fine_device_checks(dev, card, cap, integration, dense_si):
    """On the RGB-D phase's last fused keyframe (its 22,560 rays) the card's
    brick-sparse grid at 0.025 m against the CPU's: the table, the slots'
    brick coordinates and the allocated count equal, the counts equal and the
    log-odds within 1e-5; one integration's device time (CUDA events) and
    peak memory.  Then the depth phase's dense submap exported as a PLY mesh
    and its submaps' bounding boxes as VTK from the card, against the
    triangles and the VTK file of a copy on the CPU."""
    import os

    import torch
    from okvis2x_tpu_torch.apps.okvis2x_app import fused_depth
    from okvis2x_tpu_torch.core import se3
    from okvis2x_tpu_torch.io.config import load_submap_config
    from okvis2x_tpu_torch.mapping import mesh, submap
    from okvis2x_tpu_torch.pipeline.submapping import (SubmapEntry, SubmappingConfig,
                                                      SubmappingInterface)

    (left, right, fx, baseline), _ = cap.stereo_args
    (_, srcs, K, T_rs), _ = cap.mvs_args
    _, T_WK, T_WC, cam = integration[:4]
    d, sg = fused_depth(left, right, fx, baseline, srcs, K, T_rs)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fine_phase")
    cfg = SubmappingConfig.from_se2(load_submap_config(os.path.join(root, "se2.yaml"))).submap
    T_KC = se3.se3_multiply(
        se3.se3_inverse(torch.as_tensor(np.asarray(T_WK), dtype=torch.float32)).double(),
        torch.as_tensor(np.asarray(T_WC, np.float64))).float()
    grids = {}
    for where, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        sm = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, device=dv)
        for _ in range(3):
            sm = submap.integrate_depth_image(sm, cfg, cam.to(device=dv), T_KC.to(dv),
                                              d.float().to(dv), sg.float().to(dv))
        grids[where] = {k: x.cpu() for k, x in sm._asdict().items()}
    a, b = grids["card"], grids["cpu"]
    same = {k: torch.equal(a[k], b[k]) for k in ("table", "brick_xyz", "n_alloc", "pool_w")}
    lo_err = float((a["pool_lo"] - b["pool_lo"]).abs().max())
    if not all(same.values()) or not lo_err <= 1e-5:
        raise RuntimeError(f"fine grid: the card's brick grid differs from the CPU's: equal "
                           f"{same}, log-odds max |err| {lo_err}")
    n_rays = int(d[::4, ::4].numel())
    sm0 = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, device=dev)
    args = (cam.to(device=dev), T_KC.to(dev), d.float().to(dev), sg.float().to(dev))
    t_int = time_ms(lambda: submap.integrate_depth_image(sm0, cfg, *args), 10)
    peak = peak_mib(lambda: submap.integrate_depth_image(sm0, cfg, *args))
    print(f"fine grid on one keyframe's inputs ({left.shape[1]}x{left.shape[0]}, {n_rays} rays x "
          f"{cfg.samples_per_ray + cfg.band_samples} samples, three integrations) into "
          f"{cfg.dim}^3 at {cfg.res} m ({cfg.table_dim}^3 table, {cfg.pool_bricks} bricks): "
          f"{dev} vs CPU table, brick coordinates, {int(a['n_alloc'])} bricks and counts equal, "
          f"log-odds max |err| {lo_err:.2e}; one integration {t_int:.3f} ms (CUDA events, mean "
          f"of 10), peak {peak:.1f} MiB above its inputs ({card})")

    # the exports of the depth phase's dense submaps, from the card and the CPU
    cpu_si = SubmappingInterface(dense_si.cfg, device="cpu")
    cpu_si.maps = [SubmapEntry(sid=e.sid, anchor_fid=e.anchor_fid,
                               sm=type(e.sm)(*[x.cpu() for x in e.sm]),
                               col=None if e.col is None else type(e.col)(*[x.cpu()
                                                                            for x in e.col]))
                   for e in dense_si.maps]
    t0 = time.perf_counter()
    n = dense_si.export_mesh_ply(os.path.join(root, "mesh.ply"), dense_si.maps[0])
    t_mesh = time.perf_counter() - t0
    tris = mesh.submap_mesh(cpu_si.maps[0].sm, cpu_si.cfg.submap)
    boxes = []
    for where, si in (("card", dense_si), ("cpu", cpu_si)):
        with open(si.export_vtk_bboxes(os.path.join(root, f"boxes_{where}.vtk"))) as f:
            boxes.append(f.read())
    if n != len(tris) or not n > 0:
        raise RuntimeError(f"mesh export: {n} triangles from the card, {len(tris)} on the CPU")
    if boxes[0] != boxes[1]:
        raise RuntimeError("VTK export: the card's bounding boxes differ from the CPU's")
    print(f"exports of the depth phase's dense submap: a mesh of {n} triangles (CPU {len(tris)}) "
          f"written with colour in {t_mesh * 1e3:.1f} ms; VTK boxes of {len(dense_si.maps)} "
          f"submaps equal to the CPU's ({card})")
    return t_int


def fine_phase(dev, card, ds_dir, cap=None, integration=None, dense_si=None):
    """The port's app in depth mode at the reference's 0.025 m (FINE_SE2, the
    brick-sparse grid) on the first FINE_FRAMES frames of the depth phase's
    dataset `ds_dir`, under build/fine_phase/, on the default device (cuda:0)
    or on `dev` when that is the CPU.  Checks the ATEs, the keyframes
    integrated, the bricks, the grids and map.ply against the JAX app's on
    the same frames (JAX_FINE), and the export at log-odds 0
    (`check_export`); on the card also `fine_device_checks`.
    Prints the frame times, the stage means, the bricks and the peak memory;
    returns the launches by site."""
    import os

    import torch
    from okvis2x_tpu_torch.apps import okvis2x_app
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.pipeline.submapping import SubmappingInterface
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline
    from okvis2x_tpu_torch.utils import timing

    what = "fine grid"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fine_phase")
    argv = fine_args(ds_dir, root)
    out = os.path.join(root, "out")
    start_mib = None
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    else:
        start_mib = torch.cuda.memory_allocated(dev) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
    timing.reset()
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    with DepthRecorder(VioPipeline, SubmappingInterface) as rec:
        okvis2x_app.main(argv)
    t_run = time.perf_counter() - t0
    sites = dict(hamming.hamming_match.site_launches)
    ERRORS.check(what)
    if rec.pipe.device != dev:
        raise RuntimeError(f"{what}: the app ran on {rec.pipe.device}, not {dev}")
    cfg = rec.submapping.cfg.submap
    if not (hasattr(cfg, "table_dim") and cfg.dim == 1024):
        raise RuntimeError(f"{what}: the app's grid is {cfg}, not the 1024^3 brick grid")
    m = depth_metrics(rec, ds_dir, out)
    ref = JAX_FINE
    if m["n_frames"] != FINE_FRAMES:
        raise RuntimeError(f"{what}: trajectory.tum has {m['n_frames']} rows for {FINE_FRAMES}")
    bounds = {k: max(2.0 * ref[k], 0.05) for k in ("ate_online_m", "ate_final_m")}
    for k, bd in bounds.items():
        if not m[k] <= min(bd, ATE_LIMIT_M):
            raise RuntimeError(f"{what}: {k} {m[k]} exceeds {min(bd, ATE_LIMIT_M)} m (twice the "
                               f"JAX app's {ref[k]} m, floor 0.05 m, and at most {ATE_LIMIT_M})")
    if not m["n_integrated"] >= ref["n_integrated"] or m["n_submaps"] != ref["n_submaps"]:
        raise RuntimeError(f"{what}: {m['n_integrated']} keyframes integrated into "
                           f"{m['n_submaps']} submaps, the JAX app {ref['n_integrated']} into "
                           f"{ref['n_submaps']}")
    if not abs(m["map_points"] - ref["map_points"]) <= MAP_POINTS_TOL * ref["map_points"]:
        raise RuntimeError(f"{what}: map.ply has {m['map_points']} points, the JAX app's "
                           f"{ref['map_points']} (tolerance {MAP_POINTS_TOL:.0%})")
    for k in ("bricks", "total_weight", "logodds_sum", "observed_voxels", "positive_voxels"):
        if not (ref[k] != 0 and abs(m[k] - ref[k]) <= GRID_TOL * abs(ref[k])):
            raise RuntimeError(f"{what}: the grids' {k} is {m[k]}, the JAX app's {ref[k]} "
                               f"(tolerance {GRID_TOL:.0%})")
    ex = export_stats(rec.submapping, os.path.join(out, "map_evidence.ply"),
                      FINE_EXPORT_THRESHOLD)
    check_export(what, ex, JAX_FINE_EXPORT)
    if dev.type == "cuda" and sites.get("assoc", 0) <= 0:
        raise RuntimeError(f"{what}: the fused kernel's launches by site {sites} lack the "
                           "association")
    ms = np.asarray(rec.wall) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None)
    print(f"{what}: okvis2x_app --mode depth --se2-config (25.6 m at {cfg.res} m: {cfg.dim}^3, "
          f"a {cfg.table_dim}^3 table, {cfg.pool_bricks} bricks) on {rec.pipe.device}, "
          f"{FINE_FRAMES} frames: {t_run:.1f} s; ATE online {m['ate_online_m']:.4f} m (bound "
          f"{min(bounds['ate_online_m'], ATE_LIMIT_M):.4f}), final {m['ate_final_m']:.4f} m "
          f"(bound {min(bounds['ate_final_m'], ATE_LIMIT_M):.4f}); {m['n_integrated']} keyframes "
          f"integrated; bricks allocated {m['bricks']} (JAX app {ref['bricks']}); map.ply "
          f"{m['map_points']} points, RGB {m['map_rgb']} (JAX app {ref['map_points']}); grids: "
          f"counts {m['total_weight']:.0f} ({ref['total_weight']:.0f}), log-odds sum "
          f"{m['logodds_sum']:.1f} ({ref['logodds_sum']:.1f}), observed {m['observed_voxels']} "
          f"({ref['observed_voxels']}), log-odds > 0 {m['positive_voxels']} "
          f"({ref['positive_voxels']}), > 1.0 {m['voxels_above_1']} ({ref['voxels_above_1']}); "
          f"ms/frame p50 {np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max "
          f"{ms.max():.1f}; 9 DepthAndIntegrate mean {timing.mean_ms('9 DepthAndIntegrate'):.2f} "
          f"ms, window solve (2.5 CollectSolve) mean {timing.mean_ms('2.5 CollectSolve'):.2f} ms; "
          f"peak allocated "
          f"{'not measured' if peak is None else f'{peak:.1f} MiB ({start_mib:.1f} at the start)'}"
          f"; fused match launches by site {sites} ({card})")
    if dev.type == "cuda" and cap is not None:
        fine_device_checks(dev, card, cap, integration, dense_si)
    return sites


def make_sweep(t_end, rng):
    """One hall sweep of tools/lidar_scale_run.py: RAYS_PER_SWEEP rays over
    SWEEP_PERIOD up to `t_end` (interleaved elevation rings) from the true
    pose at each ray's time on LIDAR_DATA's circuit, cast analytically
    against the cylinder wall, the floor and the ceiling (hits within 25 m),
    in the moving sensor frame with 1 cm range noise from `rng`; returns
    (ray times, points)."""
    from okvis2x_tpu_torch.core import se3np
    from okvis2x_tpu_torch.io.synthetic import circuit_trajectory

    n = RAYS_PER_SWEEP
    t_point = t_end - SWEEP_PERIOD + np.linspace(0.0, SWEEP_PERIOD, n)
    az = np.linspace(-np.pi, np.pi, n, endpoint=False)
    el = 0.3 * np.sin(np.linspace(0, 16 * np.pi, n))
    d_S = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    o, q, _, _, _ = circuit_trajectory(t_point)
    C = se3np.quat_to_matrix(q)
    d_W = np.einsum("nij,nj->ni", C, d_S)
    s_best = np.full(n, np.inf)
    a = (d_W[:, :2] ** 2).sum(1)
    b = 2 * (o[:, :2] * d_W[:, :2]).sum(1)
    c = (o[:, :2] ** 2).sum(1) - HALL_R_WALL ** 2
    disc = b * b - 4 * a * c
    ok = (disc > 0) & (a > 1e-9)
    s_cyl = np.where(ok, (-b + np.sqrt(np.maximum(disc, 0.0))) / (2 * a), np.inf)
    s_best = np.where(s_cyl > 0.1, np.minimum(s_best, s_cyl), s_best)
    dz = d_W[:, 2]
    for z_pl in (HALL_Z_FLOOR, HALL_Z_CEIL):
        with np.errstate(divide="ignore"):
            s_pl = np.where(np.abs(dz) > 1e-6, (z_pl - o[:, 2]) / dz, np.inf)
        s_best = np.where(s_pl > 0.1, np.minimum(s_best, s_pl), s_best)
    hit = np.isfinite(s_best) & (s_best < 25.0)
    p_S = np.einsum("nji,nj->ni", C, s_best[:, None] * d_W)
    p_S = p_S + rng.normal(0, 0.01, p_S.shape)
    return t_point[hit], p_S[hit]


def write_sweeps(ds_dir, t_last):
    """Add lidar0/ to the dataset at `ds_dir` (written by the port's
    `generate` on the circuit): the hall sweeps ending every SWEEP_PERIOD
    from FIRST_SWEEP_T to `t_last` (`make_sweep`, `default_rng(5)`), through
    the port's `DatasetWriter`."""
    import os
    import shutil

    from okvis2x_tpu_torch.io import synthetic
    from okvis2x_tpu_torch.io.dataset_writer import DatasetWriter

    tmp = os.path.join(ds_dir, "lidar_writer")
    w = DatasetWriter(tmp, num_cams=0, t0_ns=synthetic.T0_NS)
    rng = np.random.default_rng(5)
    t_end = FIRST_SWEEP_T
    while t_end <= t_last + 1e-9:
        w.add_lidar_points(*make_sweep(t_end, rng))
        t_end += SWEEP_PERIOD
    w.close()
    shutil.move(os.path.join(tmp, "mav0", "lidar0"), os.path.join(ds_dir, "mav0", "lidar0"))
    shutil.rmtree(tmp)


def lidar_dataset(root, n_frames, dataset_frames=LIDAR_DATASET_FRAMES):
    """Write the LiDAR phase's dataset of `dataset_frames` frames under
    `root`/dataset: the port's `generate` at LIDAR_DATA and the hall sweeps
    up to the last frame (`write_sweeps`); an okvis2.yaml-schema config and
    LIDAR_SE2; returns (dataset dir, the app's arguments for its first
    `n_frames` frames, without the device)."""
    import os
    import shutil

    from okvis2x_tpu_torch.io import synthetic

    shutil.rmtree(root, ignore_errors=True)
    ds_dir = os.path.join(root, "dataset")
    duration = 0.3 + dataset_frames / LIDAR_DATA["frame_rate"]
    cam, T_SC, _ = synthetic.generate(ds_dir, duration=duration, **LIDAR_DATA)
    write_sweeps(ds_dir, duration - 0.3)
    fx, fy, cx, cy = (float(v) for v in cam.fxfycxcy)
    rig = types.SimpleNamespace(
        camera=dict(width=cam.width, height=cam.height, fx=fx, fy=fy, cx=cx, cy=cy,
                    dist_params=[float(v) for v in cam.dist_params]),
        T_SC=T_SC)
    cfg = os.path.join(root, "okvis2.yaml")
    app_config(cfg, rig)
    se2 = os.path.join(root, "se2.yaml")
    with open(se2, "w") as f:
        f.write(LIDAR_SE2)
    return ds_dir, ["--dataset", ds_dir, "--config", cfg, "--mode", "lidar", "--reader",
                    "xdataset", "--se2-config", se2, "--output", os.path.join(root, "out"),
                    "--max-frames", str(n_frames)]


class LidarRecorder:
    """Wraps, while an app runs in lidar mode (the JAX package's or the
    port's classes): `process_frame` of the LiDAR pipeline (each frame's
    wall time to the end of its device work), `process_lidar_sweep` (the
    sweeps integrated, the live constraints made) and the pipeline's
    alignment callback (the map-to-map edges)."""

    def __init__(self, lidar_cls):
        self.cls = lidar_cls
        self.pipe, self.wall = None, []
        self.n_sweeps = self.n_integrated = self.n_live = self.n_align = 0
        self.align_frames = []  # the frames processed when each edge came

    def __enter__(self):
        cls = self.cls
        self.saved = (cls.process_frame, cls.process_lidar_sweep, cls._on_align_edge)
        process_frame, sweep, on_align = self.saved
        rec = self

        def frame(pipe, *args, **kwargs):
            t = time.perf_counter()
            info = process_frame(pipe, *args, **kwargs)
            dev = getattr(pipe, "device", None)
            if dev is not None and dev.type == "cuda":
                import torch

                torch.cuda.synchronize(dev)
            rec.wall.append(time.perf_counter() - t)
            rec.pipe = rec.pipe or pipe
            return info

        def swept(pipe, *args, **kwargs):
            out = sweep(pipe, *args, **kwargs)
            rec.n_sweeps += 1
            rec.n_integrated += bool(out.get("integrated"))
            rec.n_live += bool(out.get("live_edge"))
            rec.pipe = rec.pipe or pipe
            return out

        def aligned(pipe, edge):
            rec.n_align += 1
            rec.align_frames.append(len(rec.wall))
            return on_align(pipe, edge)

        cls.process_frame, cls.process_lidar_sweep, cls._on_align_edge = frame, swept, aligned
        return self

    def __exit__(self, *exc):
        self.cls.process_frame, self.cls.process_lidar_sweep, self.cls._on_align_edge = self.saved


def lidar_metrics(rec, ds_dir, out):
    """What the LiDAR phase checks, from a recorded app run that wrote its
    trajectories and map.ply to `out`: the ATEs, the sweeps, the live
    constraints, the submaps and map-to-map edges, map.ply's points and
    `grid_stats`."""
    import os

    from okvis2x_tpu_torch.io import trajectory_io, xdataset

    gt = xdataset.XDataset(ds_dir).ground_truth
    ts, Ts = trajectory_io.read_tum(os.path.join(out, "trajectory.tum"))
    fts, fTs = trajectory_io.read_tum(os.path.join(out, "final_trajectory.tum"))
    n_map, _ = ply_vertices(os.path.join(out, "map.ply"))
    return dict(
        ate_online_m=float(trajectory_io.ate_rmse(ts, Ts[:, :3], gt[:, 0], gt[:, 1:4])),
        ate_final_m=float(trajectory_io.ate_rmse(fts, fTs[:, :3], gt[:, 0], gt[:, 1:4])),
        n_frames=len(ts), n_final=len(fts), n_sweeps=rec.n_sweeps,
        n_integrated=rec.n_integrated, n_live=rec.n_live, n_align=rec.n_align,
        align_frames=list(rec.align_frames), map_points=n_map,
        **grid_stats(rec.pipe.submapper),
    )


def drift_recovery(cap_icp, device="cpu", m=None):
    """The drift-recovery scenario of tests/test_lidar_vio.py: a wall at 2 m
    painted by three dense sweeps from three fixed frames (5 cm grid), then a
    frame that believes it is 8 cm behind its true pose sees the wall (300
    rays from the seeded `default_rng(23)`) and the window is solved once;
    with `cap_icp` > 0 the sweep enters as per-point rows, else as a
    relative-pose edge.  Returns the LiDAR pipeline (the frame's pose is
    `pipe.est.frames[-1].T_WS`).  `m` holds the classes of the package to
    run (default: the port's on `device`)."""
    if m is None:
        from okvis2x_tpu_torch.cameras import pinhole
        from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, FrameState
        from okvis2x_tpu_torch.io.xdataset import LidarSweep
        from okvis2x_tpu_torch.mapping.submap import SubmapConfig
        from okvis2x_tpu_torch.pipeline.lidar_vio import LidarVioPipeline
        from okvis2x_tpu_torch.pipeline.submapping import SubmappingConfig
        from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline

        m = types.SimpleNamespace(
            pinhole=pinhole, EstimatorConfig=EstimatorConfig, FrameState=FrameState,
            LidarSweep=LidarSweep, SubmapConfig=SubmapConfig, LidarVioPipeline=LidarVioPipeline,
            SubmappingConfig=SubmappingConfig, PipelineConfig=PipelineConfig,
            VioPipeline=VioPipeline, vio_kw=dict(device=device))
    rng = np.random.default_rng(23)
    cam = m.pinhole.make_pinhole(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96,
                                 model="none")
    est_cfg = m.EstimatorConfig(cap_frames=8, num_keyframes=4, num_imu_frames=2,
                                cap_landmarks=64, cap_obs=256, cap_imu_links=7, cap_rel_edges=8,
                                cap_icp=cap_icp, max_iterations=6)
    vio = m.VioPipeline([cam], np.array([[0, 0, 0, 0, 0, 0, 1.0]]), est_cfg,
                        m.PipelineConfig(do_loop_closures=False), **m.vio_kw)
    sub_cfg = m.SubmappingConfig(submap=m.SubmapConfig(dim=96, res=0.05, band_samples=16),
                                 min_frames_integrated=1, align_points=128, sensor_sigma=0.1)
    pipe = m.LidarVioPipeline(vio, sub_cfg, voxel=0.05, max_points_per_sweep=4096)
    est = pipe.est
    for k in range(3):
        est.frames.append(m.FrameState(fid=k, timestamp=0.1 * k,
                                       T_WS=np.array([0, 0, 0, 0, 0, 0, 1.0]), sb=np.zeros(9),
                                       is_keyframe=True, pose_fixed=True, sb_fixed=True,
                                       pose_graph_frame=True))
    pipe.vio.last_kf_fid = 0
    xy = np.stack(np.meshgrid(np.linspace(-2, 2, 70), np.linspace(-1.5, 1.5, 52)),
                  -1).reshape(-1, 2)
    wall = np.concatenate([xy, np.full((len(xy), 1), 2.0)], -1)
    for t in (0.15, 0.22, 0.28):
        pipe.process_lidar_sweep(m.LidarSweep(t=t, t_point=np.linspace(t - 0.05, t, len(wall)),
                                              pts=wall, intensity=np.ones(len(wall))))
    est.frames.append(m.FrameState(fid=3, timestamp=0.35,
                                   T_WS=np.array([0, 0, -0.08, 0, 0, 0, 1.0]), sb=np.zeros(9),
                                   is_keyframe=False, sb_fixed=True))
    pts = np.concatenate([rng.uniform(-1.8, 1.8, (300, 2)), np.full((300, 1), 2.0)], -1)
    pipe.process_lidar_sweep(m.LidarSweep(t=0.40, t_point=np.linspace(0.36, 0.40, 300),
                                          pts=pts, intensity=np.ones(300)))
    est.optimise()
    return pipe


def drift_cpu_poses():
    """The drifted frame's pose after `drift_recovery` on the CPU, by
    `cap_icp` (128 and 0): the CPU half of `lidar_device_checks`, run in
    the spawned process meanwhile the card works."""
    import torch

    torch.set_num_threads(1)
    return {cap: np.array(drift_recovery(cap, "cpu").est.frames[-1].T_WS) for cap in (128, 0)}


def lidar_device_checks(dev, card, pipe, cpu_poses=None):
    """The live ICP rows and the LiDAR functions on the card: the drift
    recovery (`drift_recovery`) with per-point rows and with the compressed
    edge on the card against the CPU's (`cpu_poses`, a future of
    `drift_cpu_poses`; None: computed here); the device times of one
    2048-ray `integrate_rays` into a 128^3 grid and of one
    `make_alignment_edge` of up to 200 points of the app's second submap
    against its first (CUDA events); the aten calls of one
    linearisation of the drift problem with and without its ICP rows."""
    import torch
    import torch.profiler as tp
    from okvis2x_tpu_torch.mapping import icp_factor, submap
    from okvis2x_tpu_torch.solver import gauss_newton as gn

    cpu_poses = drift_cpu_poses() if cpu_poses is None else cpu_poses.result()
    poses, pipes = {}, {}
    for cap in (128, 0):
        pipes["card", cap] = drift_recovery(cap, dev)
        poses["card", cap] = np.array(pipes["card", cap].est.frames[-1].T_WS)
        poses["cpu", cap] = cpu_poses[cap]
    err_live, err_edge = abs(poses["card", 128][2]), abs(poses["card", 0][2])
    gaps = {cap: float(np.abs(poses["card", cap][:3] - poses["cpu", cap][:3]).max())
            for cap in (128, 0)}
    if not (err_live < 0.03 and err_live < 0.5 * err_edge):
        raise RuntimeError(f"LiDAR: the per-point rows leave {err_live} m of the 8 cm drift, the "
                           f"compressed edge {err_edge} m (bounds 0.03 m and half the edge's)")
    if not max(gaps.values()) <= DRIFT_CPU_TOL_M:
        raise RuntimeError(f"LiDAR: the drift recovery on the card is {gaps} m from the CPU's "
                           f"(bound {DRIFT_CPU_TOL_M})")
    # aten calls of one linearisation of the drift window, with its ICP rows
    est = pipes["card", 128].est
    p = est._build_problem()[0]
    aten = {}
    for name, use_icp in (("without", False), ("with", True)):
        cfg = est._solver_config(est.cfg.max_iterations, False, use_icp)
        gn.linearize(p, est.cams, cfg)
        with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
            gn.linearize(p, est.cams, cfg)
            torch.cuda.synchronize()
        aten[name] = sum(e.name.startswith("aten::") for e in prof.events())
    # device times at the LiDAR path's shapes
    cfg = submap.SubmapConfig()
    rng = np.random.default_rng(5)
    end = np.concatenate([make_sweep(FIRST_SWEEP_T + k * SWEEP_PERIOD, rng)[1]
                          for k in range(8)])[:2048]
    end_d = torch.as_tensor(end, dtype=torch.float32, device=dev)
    sm0 = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, device=dev)
    origin = torch.zeros(3, device=dev)
    ok = torch.ones(len(end_d), dtype=torch.bool, device=dev)
    si = pipe.submapper  # the pair of the phase's first map-to-map edge
    a, b = si.maps[0], si.maps[1]
    centres, occ = submap.occupied_point_list(b.sm, si.cfg.submap, max_points=4096)
    pts = centres[occ][:si.cfg.align_points]
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    times = dict(
        integrate_ms=time_ms(lambda: submap.integrate_rays(sm0, cfg, origin, end_d, ok, 0.1), 10),
        edge_ms=time_ms(lambda: icp_factor.make_alignment_edge(
            a.sm, si.cfg.submap, a.sm.T_WK, b.sm.T_WK, pts, valid, si.cfg.sensor_sigma), 10),
        integrate_mib=peak_mib(lambda: submap.integrate_rays(sm0, cfg, origin, end_d, ok, 0.1)))
    print(f"LiDAR on the card: drift recovery (8 cm) with per-point rows {err_live * 100:.3f} cm "
          f"left, with the compressed edge {err_edge * 100:.3f} cm; card vs CPU {gaps[128]:.2e} "
          f"/ {gaps[0]:.2e} m; aten calls of one linearisation of the drift window "
          f"{aten['without']} without its 128 ICP rows, {aten['with']} with them; device time "
          f"(CUDA events, mean of 10 calls) of one integrate_rays of {len(end_d)} rays x "
          f"{cfg.samples_per_ray + cfg.band_samples} samples into the 128^3 grid "
          f"{times['integrate_ms']:.3f} ms (peak {times['integrate_mib']:.1f} MiB above its "
          f"inputs), of one make_alignment_edge of {len(pts)} points {times['edge_ms']:.3f} ms "
          f"({card})")
    return dict(times, aten=aten, err_live=err_live, err_edge=err_edge, gaps=gaps)


def lidar_phase(dev, card, cpu_poses=None):
    """The port's app in lidar mode, as a user runs it, on the phase's
    dataset (`lidar_dataset`: LIDAR_FRAMES frames of the circuit at 752x480
    with the hall sweeps, under build/lidar_phase/) with LIDAR_SE2 on the
    default device (cuda:0) or on `dev` when that is the CPU.  Checks the
    ATEs, the sweeps integrated, the live constraints, the submaps and
    map-to-map edges, map.ply and the grids (`grid_stats`) against the JAX
    app's on the same frames (JAX_LIDAR); on the card also
    `lidar_device_checks` (`cpu_poses`: a future of `drift_cpu_poses`).
    Prints the frame times, the stage means, the peak memory and the
    launches by site; returns the launches."""
    import os

    import torch
    from okvis2x_tpu_torch.apps import okvis2x_app
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.pipeline.lidar_vio import LidarVioPipeline
    from okvis2x_tpu_torch.utils import timing

    what = "LiDAR"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "lidar_phase")
    t0 = time.perf_counter()
    ds_dir, argv = lidar_dataset(root, LIDAR_FRAMES)
    t_data = time.perf_counter() - t0
    start_mib = None
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    else:
        start_mib = torch.cuda.memory_allocated(dev) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
    timing.reset()
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    with LidarRecorder(LidarVioPipeline) as rec:
        okvis2x_app.main(argv)
    t_run = time.perf_counter() - t0
    sites = dict(hamming.hamming_match.site_launches)
    ERRORS.check(what)
    pipe = rec.pipe
    if pipe.device != dev:
        raise RuntimeError(f"{what}: the app ran on {pipe.device}, not {dev}")
    m = lidar_metrics(rec, ds_dir, os.path.join(root, "out"))
    ref = JAX_LIDAR
    if m["n_frames"] != LIDAR_FRAMES:
        raise RuntimeError(f"{what}: trajectory.tum has {m['n_frames']} rows for {LIDAR_FRAMES}")
    b_online = min(max(2.0 * ref["ate_online_m"], 0.05), ATE_LIMIT_M)
    if not m["ate_online_m"] <= b_online or not m["ate_final_m"] <= ATE_LIMIT_M:
        raise RuntimeError(f"{what}: ATE online {m['ate_online_m']} m (bound {b_online}: twice "
                           f"the JAX app's {ref['ate_online_m']}, floor 0.05), final "
                           f"{m['ate_final_m']} m (bound {ATE_LIMIT_M})")
    for k in ("n_sweeps", "n_integrated", "n_submaps", "n_align"):
        if m[k] != ref[k]:
            raise RuntimeError(f"{what}: {k} {m[k]}, the JAX app's {ref[k]}")
    if not (m["n_align"] >= 1 and m["n_live"] >= 1):
        raise RuntimeError(f"{what}: {m['n_align']} map-to-map edges, {m['n_live']} live "
                           "constraints (at least one of each)")
    if not abs(m["map_points"] - ref["map_points"]) <= MAP_POINTS_TOL * ref["map_points"]:
        raise RuntimeError(f"{what}: map.ply has {m['map_points']} points, the JAX app's "
                           f"{ref['map_points']} (tolerance {MAP_POINTS_TOL:.0%})")
    for k in ("total_weight", "logodds_sum", "observed_voxels", "positive_voxels"):
        if not (ref[k] != 0 and abs(m[k] - ref[k]) <= GRID_TOL * abs(ref[k])):
            raise RuntimeError(f"{what}: the grids' {k} is {m[k]}, the JAX app's {ref[k]} "
                               f"(tolerance {GRID_TOL:.0%})")
    if dev.type == "cuda" and sites.get("assoc", 0) <= 0:
        raise RuntimeError(f"{what}: the fused kernel's launches by site {sites} lack the "
                           "association")
    ms = np.asarray(rec.wall) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None)
    print(f"{what}: dataset of {LIDAR_FRAMES} frames with {m['n_sweeps']} sweeps written in "
          f"{t_data:.1f} s; okvis2x_app --mode lidar on {pipe.device}: {t_run:.1f} s; ATE online "
          f"{m['ate_online_m']:.4f} m (bound {b_online:.4f}; JAX app {ref['ate_online_m']:.4f}), "
          f"final {m['ate_final_m']:.4f} m over {m['n_final']} states; sweeps integrated "
          f"{m['n_integrated']} (JAX app {ref['n_integrated']}), live constraints {m['n_live']} "
          f"({ref['n_live']}), submaps {m['n_submaps']} ({ref['n_submaps']}), map-to-map edges "
          f"{m['n_align']} ({ref['n_align']}) after frames {m['align_frames']}; map.ply "
          f"{m['map_points']} points ({ref['map_points']}); grids: counts {m['total_weight']:.0f} "
          f"({ref['total_weight']:.0f}), log-odds sum {m['logodds_sum']:.1f} "
          f"({ref['logodds_sum']:.1f}), observed {m['observed_voxels']} "
          f"({ref['observed_voxels']}), log-odds > 0 {m['positive_voxels']} "
          f"({ref['positive_voxels']}); ms/frame p50 {np.percentile(ms, 50):.1f} p90 "
          f"{np.percentile(ms, 90):.1f} max {ms.max():.1f}; 8 LidarSweep mean "
          f"{timing.mean_ms('8 LidarSweep'):.2f} ms, window solve (2.5 CollectSolve) mean "
          f"{timing.mean_ms('2.5 CollectSolve'):.2f} ms, 3.2 SolveDevice mean "
          f"{timing.mean_ms('3.2 SolveDevice'):.2f} ms; peak allocated "
          f"{'not measured' if peak is None else f'{peak:.1f} MiB ({start_mib:.1f} at the start)'}"
          f"; fused match launches by site {sites} ({card})")
    if dev.type == "cuda":
        lidar_device_checks(dev, card, pipe, cpu_poses)
    return sites


def drifted_circle(K, rng, radius=5.0):
    """K keyframes on a circle with drifting estimates, noisy odometry edges
    to the next two keyframes and loop edges from the last quarter to the
    first four: the pose graph of a loop closure."""
    from okvis2x_tpu_torch.core import se3np

    gt, est = [], []
    for k in range(K):
        th = 2 * np.pi * k / K
        T = np.concatenate([[radius * np.cos(th), radius * np.sin(th), 0.0],
                            se3np.delta_q(np.array([0.0, 0.0, th + np.pi / 2]))])
        gt.append(T)
        est.append(se3np.retract(T, np.concatenate([[1.0, 0.5, 0.1], [0, 0, 1.0]]) * 0.8 * k / K))
    ei, ej, eT, eS = [], [], [], []
    for a, b, w, noise in ([(k, k + 1, 100.0, 1e-3) for k in range(K - 1)]
                           + [(k, k + 2, 100.0, 1e-3) for k in range(K - 2)]
                           + [(k % 4, k, 50.0, 2e-3) for k in range(K - K // 4, K)]):
        ei.append(a)
        ej.append(b)
        eT.append(se3np.retract(se3np.se3_multiply(se3np.se3_inverse(gt[a]), gt[b]),
                                rng.normal(0, noise, 6)))
        eS.append(np.eye(6) * w)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (np.stack(est), fixed, np.array(ei), np.array(ej), np.stack(eT), np.stack(eS),
            np.stack(gt))


def record_weights(vio, out):
    """Keep (uv, valid, w) of every camera of every consumed frame of the
    deferred frontend in `out`, in frame order."""
    consume = vio.frontend_consume

    def run(h, crit):
        frame_data, counts = consume(h, crit)
        out.append([(fd.uv, fd.valid, fd.w) for fd in frame_data])
        return frame_data, counts

    vio.frontend_consume = run


def segmentation_phase(dev, card, seq):
    """The flagship configuration on the textured world (`seq`,
    seg_sequence()) with the semantic weighting off and "net": ATEs, the
    fourth column, the association's launches; FastSCNN on the card against
    the CPU on frame 0 and its time.  Returns the fused kernel's launches by
    site."""
    import torch
    from okvis2x_tpu_torch.io import trajectory_io
    from okvis2x_tpu_torch.models import segmentation
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    runs, all_sites = {}, {}
    for mode in ("off", "net"):
        hamming.reset_launch_counts()
        timing.reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec = []
        t0 = time.perf_counter()
        vio, infos, wall, _, _, _ = run_pipeline(
            seq, dev, SEG_FRAMES, record_times=True, est_kw=FLAGSHIP_EST,
            pipe_kw=FLAGSHIP_PIPE | dict(segmentation=mode), wrap=lambda v: record_weights(v, rec))
        t_run = time.perf_counter() - t0
        sites = dict(hamming.hamming_match.site_launches)
        peak = peak_text(dev)
        ts, Ts = check_positions(vio, SEG_FRAMES, f"segmentation {mode}")
        ate = float(trajectory_io.ate_rmse(ts, Ts[:, :3], seq.gt[:, 0], seq.gt[:, 1:4]))
        if dev.type == "cuda" and sites.get("assoc", 0) != 4 * SEG_FRAMES:
            raise RuntimeError(f"segmentation {mode}: the association launched the fused "
                               f"kernel {sites} times over {SEG_FRAMES} frames")
        if not ate <= SEG_ATE_LIMIT_M:
            raise RuntimeError(f"segmentation {mode}: ATE {ate} m exceeds {SEG_ATE_LIMIT_M} m")
        if len(rec) != SEG_FRAMES:
            raise RuntimeError(f"segmentation {mode}: {len(rec)} frames consumed")
        for k, n in sites.items():
            all_sites[k] = all_sites.get(k, 0) + n
        ms = np.asarray(wall) * 1e3
        runs[mode] = dict(ate=ate, rec=rec, vio=vio)
        print(f"segmentation {mode}: {SEG_FRAMES} frames in {t_run:.1f} s, online ATE {ate:.4f} m, "
              f"ms/frame p50 {np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max "
              f"{ms.max():.1f}, peak allocated {peak}, fused launches {sites}; stage means ms: "
              + ", ".join(f"{k} {timing.mean_ms(k):.2f}" for k in SEG_STAGES) + f" ({card})")
    ERRORS.check("segmentation phase")

    # the fourth column: the class weights of every keypoint of the "net" run
    w_off = [w for frame in runs["off"]["rec"] for _, _, w in frame]
    if any(w is not None for w in w_off):
        raise RuntimeError("segmentation off: the frames carry weights")
    ws = [(w, valid) for frame in runs["net"]["rec"] for _, valid, w in frame]
    if any(w is None for w, _ in ws):
        raise RuntimeError("segmentation net: a frame without weights")
    vals = np.concatenate([w[v] for w, v in ws])
    if not set(np.unique(vals)) <= {1.0, 3.0, 5.0} or not (vals > 1).any():
        raise RuntimeError(f"segmentation net: weights {np.unique(vals)}, none above 1 or "
                           "outside {1, 3, 5}")
    down = np.concatenate([w[v] > 1 for (w, v) in ws[::2]])  # cam0
    on_cls = np.concatenate([
        seq.classmaps[k][np.clip(np.round(uv[v, 1]).astype(int), 0, seq.classmaps.shape[1] - 1),
                         np.clip(np.round(uv[v, 0]).astype(int), 0, seq.classmaps.shape[2] - 1)]
        for k, frame in enumerate(runs["net"]["rec"]) for uv, v, _ in frame[:1]])
    print(f"segmentation net: {len(vals)} keypoints, weights 1/3/5: {int((vals == 1).sum())}/"
          f"{int((vals == 3).sum())}/{int((vals == 5).sum())}; cam0 keypoints on the renderer's "
          f"sky / distractor pixels {int((on_cls == 1).sum())} / {int((on_cls == 2).sum())}, "
          f"downweighted there {int(down[on_cls == 1].sum())} / {int(down[on_cls == 2].sum())}, "
          f"on static pixels {int(down[on_cls == 0].sum())} of {int((on_cls == 0).sum())}")

    # the accuracy: the JAX bounds, then the JAX pipeline's own ATE
    ate_off, ate_net = runs["off"]["ate"], runs["net"]["ate"]
    if not ate_net <= 1.15 * ate_off + 0.02:
        raise RuntimeError(f"segmentation hurt: ATE {ate_net} m against {ate_off} m off")
    gap = abs(ate_net - JAX_SEG["net"])
    print(f"segmentation ATE off {ate_off:.4f} m, net {ate_net:.4f} m; the JAX pipeline on the "
          f"CPU {JAX_SEG['off']:.4f} / {JAX_SEG['net']:.4f} m, net gap {gap:.2e} m")
    if not gap <= SEG_JAX_TOL_M:
        raise RuntimeError(f"segmentation net: ATE {ate_net} m, the JAX pipeline's "
                           f"{JAX_SEG['net']} m")

    # FastSCNN on the card against the CPU on frame 0 (both cameras, padded
    # as the fused frontend pads them), and its time
    vio = runs["net"]["vio"]
    imgs = torch.from_numpy(vio._pack_images(list(seq.images[0]))).to(torch.float32) / 255.0
    net_card = segmentation.trained_net(str(dev))[0]
    net_cpu = segmentation.trained_net("cpu")[0]
    with torch.no_grad():
        got = net_card(imgs.to(dev)).cpu()
        ref = net_cpu(imgs)
        err = float((got - ref).abs().max())
        t_net = (f"{time_ms(lambda: net_card(imgs.to(dev)), 20):.3f} ms a frame (CUDA events)"
                 if dev.type == "cuda" else "time not measured")
    if not err <= SEG_LOGIT_TOL:
        raise RuntimeError(f"FastSCNN: card and CPU logits differ by {err}")
    n_kp = n_clear = 0
    for c, (uv, valid, _) in enumerate(runs["net"]["rec"][0]):
        uv_t = torch.from_numpy(uv[valid]).to(torch.float32)
        x, y = segmentation.nearest_pixels(uv_t, *ref.shape[1:3])
        top2 = ref[c][y, x].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * SEG_LOGIT_TOL
        same = segmentation.sample_classes(got[c], uv_t) == segmentation.sample_classes(ref[c],
                                                                                        uv_t)
        if not bool(same[clear].all()):
            raise RuntimeError(f"FastSCNN: camera {c}'s classes differ on the card")
        n_kp, n_clear = n_kp + len(uv_t), n_clear + int(clear.sum())
    print(f"FastSCNN 2x{tuple(imgs.shape[1:])}: card vs CPU logits max |diff| {err:.2e} "
          f"(tolerance {SEG_LOGIT_TOL}), classes equal at {n_clear} of {n_kp} frame-0 keypoints "
          f"(the rest within 2x the tolerance of a tie); {t_net} ({card})")
    del runs, vio
    return all_sites


def trainer_batch(name, rng):
    """A batch at the trainer's default size and batch from a pool of 4 (2
    for stereo and MVS), as numpy arrays, and the trainer's module."""
    from okvis2x_tpu_torch.tools import train_mvs, train_segmentation, train_stereo

    if name == "segmentation":
        ims, cs = train_segmentation.make_pool(train_segmentation.camera(240, 376), rng, 4)
        img, lab = train_segmentation.draw_batch(rng, ims, cs, 4)
        return train_segmentation, (img, lab, train_segmentation.class_weights())
    cam = train_stereo.camera(192, 256)
    if name == "stereo":
        pool = train_stereo.make_pool(cam, rng, train_stereo.make_scenes(rng), 2)
        return train_stereo, train_stereo.draw_batch(rng, pool, 4)
    pool = train_mvs.make_pool(cam, rng, train_mvs.make_scenes(rng), 2, 2)
    return train_mvs, train_mvs.draw_batch(rng, pool, 2, 0.06)


def cpu_vocabulary(desc):
    """The 64x64 vocabulary tree of packed descriptors `desc` ((n, 12) int32
    numpy) trained on the CPU, and the descriptors' words: (branches, leaves,
    words, seconds)."""
    import torch
    from okvis2x_tpu_torch.frontend import bow

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    d = torch.from_numpy(desc)
    vocab = bow.train_vocabulary_hier(d, branch=64, leaf=64, iters=8)
    words = bow.assign_packed(d, None, vocab)
    return (vocab.branches.numpy(), vocab.leaves.numpy(), words.numpy(),
            time.perf_counter() - t0)


def trainers_phase(dev, card, pool):
    """The vocabulary trainer on VOCAB_N descriptors, its tree against the
    CPU's (trained meanwhile in `pool`); each net trainer's `main` on the
    card (TRAIN_STEPS steps, a pool of TRAIN_POOL at its default size), its
    artifact loaded back, one step's loss and gradients against the CPU's.
    Returns the fused kernel's launches by site."""
    import copy
    import os

    import torch
    from okvis2x_tpu_torch import optim
    from okvis2x_tpu_torch.frontend import bow
    from okvis2x_tpu_torch.models import mvs_net, segmentation, stereo_net
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.tools import train_vocab

    root = os.path.join("build", "trainers_phase")
    os.makedirs(root, exist_ok=True)
    on_cpu = [] if dev.type == "cuda" else ["--device", str(dev)]  # the trainers' default: cuda:0

    hamming.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    vocab_out = os.path.join(root, "vocab.npz")
    voc = train_vocab.main(["--n", str(VOCAB_N), "--out", vocab_out] + on_cpu)
    sites = dict(hamming.hamming_match.site_launches)
    vocab_peak = peak_text(dev)
    cpu_tree = pool.submit(cpu_vocabulary, voc["desc"].cpu().numpy())

    for name in ("segmentation", "stereo", "mvs"):
        mod, batch = trainer_batch(name, np.random.default_rng(1))
        out = os.path.join(root, f"{name}.npz")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = mod.main(["--steps", str(TRAIN_STEPS), "--pool", str(TRAIN_POOL[name]), "--out", out]
                       + on_cpu)
        t_main = time.perf_counter() - t0
        peak = peak_text(dev)
        losses = np.asarray(res["losses"])
        if not np.isfinite(losses).all() or not losses[:3].mean() > losses[-3:].mean():
            raise RuntimeError(f"train_{name}: losses {losses.tolist()} do not fall")
        if name == "segmentation":
            state, _ = segmentation.load_params(out)
            segmentation.FastSCNN().to(dev).load_state_dict(state)
        elif (stereo_net.trained(out, 64, str(dev)) if name == "stereo"
              else mvs_net.trained(out, str(dev))) is None:
            raise RuntimeError(f"train_{name}: {out} does not load")
        # one step from the same initial weights and batch on the card and the CPU
        net = mod.new_net()
        cpu_loss, cpu_grads = optim.loss_and_grads(net, mod.loss, *map(torch.from_numpy, batch))
        gpu_loss, gpu_grads = optim.loss_and_grads(
            copy.deepcopy(net).to(dev), mod.loss, *(torch.from_numpy(x).to(dev) for x in batch))
        loss_err = abs(float(gpu_loss) - float(cpu_loss)) / abs(float(cpu_loss))
        grad_err = max(float((gpu_grads[k].cpu() - g).abs().max() / g.abs().max().clamp(min=1e-30))
                       for k, g in cpu_grads.items())
        if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL):
            raise RuntimeError(f"train_{name}: the card's step differs from the CPU's: loss "
                               f"{loss_err:.2e} relative, gradients {grad_err:.2e}")
        step_s = np.asarray(res["step_s"][1:])
        print(f"train_{name}: {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{np.median(step_s):.4f} s a step (median after the first; first "
              f"{res['step_s'][0]:.3f} s), main {t_main:.1f} s, peak allocated {peak}; "
              f"one step card vs CPU: loss {loss_err:.1e} relative, gradients {grad_err:.1e} of "
              f"their largest entry ({card})")
    ERRORS.check("trainers phase")

    branches, leaves, cpu_words, t_cpu = cpu_tree.result()
    loaded = bow.HierVocabulary.load(vocab_out, device=dev)
    for what, a, b in (("branches", voc["vocab"].branches, branches),
                       ("leaves", voc["vocab"].leaves, leaves),
                       ("the file", loaded.leaves, leaves),
                       ("assignments", voc["words"], cpu_words)):
        if not np.array_equal(a.cpu().numpy(), b):
            raise RuntimeError(f"train_vocab: {what} on the card differ from the CPU's")
    print(f"train_vocab: {VOCAB_N} descriptors collected in {voc['collect_s']:.1f} s, the "
          f"64x64 tree trained in {voc['train_s']:.1f} s on the card ({t_cpu:.1f} s on the CPU "
          f"in the background process, equal), {len(np.unique(cpu_words))} words used, peak "
          f"allocated {vocab_peak}, fused launches {sites} ({card})")
    return sites


def pcg_phase(dev, card, cpu_solves):
    """The matrix-free PCG pose-graph solver at 300 and 1000 nodes on the
    card, against the CPU's solves (`cpu_solves`, a future of
    `pcg_cpu_solves`); the card's time a solve."""
    import torch
    from okvis2x_tpu_torch.parallel import dist_posegraph

    for K in PCG_NODES:
        *args, gt = drifted_circle(K, np.random.default_rng(K))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_gpu, cost_gpu = dist_posegraph.optimize_pose_graph_pcg(
            *args, iterations=PCG_ITERATIONS, device=dev)
        t_gpu = time.perf_counter() - t0  # the result is on the host: synchronised
        T_cpu, cost_cpu, t_cpu = cpu_solves.result()[K]
        gap = float(np.abs(T_gpu - T_cpu).max())
        err = float(np.linalg.norm(T_gpu[:, :3] - gt[:, :3], axis=1).max())
        err0 = float(np.linalg.norm(args[0][:, :3] - gt[:, :3], axis=1).max())
        Kp = dist_posegraph.bucket(K, 64)
        print(f"PCG pose graph {K} nodes, {len(args[2])} edges (padded {Kp} nodes, "
              f"{dist_posegraph.bucket(len(args[2]), 256)} edges, {max(128, Kp)} CG iterations "
              f"x {PCG_ITERATIONS} LM steps): card {t_gpu * 1e3:.1f} ms a solve, CPU "
              f"{t_cpu * 1e3:.1f} ms; card vs CPU max pose gap "
              f"{gap:.3e}, cost {cost_gpu:.6e} vs {cost_cpu:.6e}; max position error "
              f"{err0:.3f} -> {err:.4f} m ({card})")
        if not gap <= PCG_TOL or not np.isfinite(T_gpu).all():
            raise RuntimeError(f"PCG pose graph at {K} nodes: card and CPU differ by {gap}")
        if not err < err0:
            raise RuntimeError(f"PCG pose graph at {K} nodes did not reduce the drift")
    ERRORS.check("PCG phase")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger().addHandler(ERRORS)

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- phases 2 and 3: the kernels against their plain versions, their times
    t0 = time.perf_counter()
    entries = check_kernels(dev, card)
    time_sites(dev, card)
    device_ms.stream = None
    torch.cuda.empty_cache()
    ERRORS.check("kernel phase")
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s; it leaves "
          f"{torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB allocated (the library "
          "yardstick's cuBLAS workspace), which the phases' peaks below include")

    # ---- phases 4 to 10: the main paths, then the PCG pose graph; the CPU
    # halves of their card-vs-CPU checks run meanwhile in a process of
    # their own (one core of the host; the card's phases are host-bound on
    # one other)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_positions = pool.submit(vio_cpu_positions)
        cpu_flagship = pool.submit(flagship_cpu_positions)
        cpu_solves = pool.submit(pcg_cpu_solves)
        cpu_drift = pool.submit(drift_cpu_poses)
        seg_seq = pool.submit(seg_sequence)
        t0 = time.perf_counter()
        match_sites, phase_sites = {}, {}

        def add_sites(sites, phase):
            phase_sites[phase] = dict(sites)
            for k, n in sites.items():
                match_sites[k] = match_sites.get(k, 0) + n

        sites, on_matrix = vio_phase(dev, card, cpu_positions)
        add_sites(sites, "vio")
        print(f"VIO phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        seq = render(max(LC_FRAMES.values()), **SMALL_CIRCUIT)
        print(f"rendered {max(LC_FRAMES.values())} frames at 752x480, circuit radius "
              f"{SMALL_CIRCUIT['radius']} m: {time.perf_counter() - t0:.1f} s")
        for mode in LC_PIPES:
            t0 = time.perf_counter()
            sites, vio = loop_closure_phase(dev, card, mode, seq, cpu_flagship)
            add_sites(sites, mode)
            print(f"{mode} loop-closure phase: {time.perf_counter() - t0:.1f} s")
            if mode == "synchronous":
                t0 = time.perf_counter()
                add_sites(multisession_phase(dev, card, vio, seq), "multi-session")
                print(f"multi-session phase: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                add_sites(app_phase(dev, card), "app")
                print(f"app phase: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                add_sites(bag_phase(dev, card), "bag")
                print(f"bag-replay phase: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                add_sites(live_nodes_phase(dev, card), "live nodes")
                print(f"live-nodes phase: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                add_sites(gnss_phase(dev, card), "gnss")
                print(f"GNSS phase: {time.perf_counter() - t0:.1f} s")
                kept = {}
                for mode in ("rgbd", "depth"):
                    t0 = time.perf_counter()
                    sites, rec, cap, ds_dir = depth_phase(dev, card, mode)
                    kept[mode] = (rec, cap, ds_dir)
                    add_sites(sites, mode)
                    print(f"{mode} phase: {time.perf_counter() - t0:.1f} s")
                    if mode == "rgbd":
                        t0 = time.perf_counter()
                        async_submapping_phase(dev, card, rec, ds_dir)
                        print(f"asynchronous submapping phase: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                (rgbd_rec, rgbd_cap, _), (depth_rec, _, depth_dir) = kept["rgbd"], kept["depth"]
                add_sites(fine_phase(dev, card, depth_dir, rgbd_cap, rgbd_rec.last_integration,
                                     depth_rec.submapping), "fine")
                del kept, rgbd_rec, rgbd_cap, depth_rec
                print(f"fine-grid phase: {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                add_sites(lidar_phase(dev, card, cpu_drift), "lidar")
                print(f"LiDAR phase: {time.perf_counter() - t0:.1f} s")
            del vio
        t0 = time.perf_counter()
        pcg_phase(dev, card, cpu_solves)
        print(f"PCG phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add_sites(segmentation_phase(dev, card, seg_seq.result()), "segmentation")
        print(f"segmentation phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add_sites(trainers_phase(dev, card, pool), "trainers")
        print(f"trainers phase: {time.perf_counter() - t0:.1f} s")

    # times at 704x1024, the map matching's shape; launches over phases 4-9,
    # the app, bag-replay, live-nodes, GNSS, RGB-D, depth-mode, fine-grid,
    # LiDAR, segmentation and trainers phases
    print(json.dumps({"kernels": [
        {"name": "hamming_match", "route": "cuda",
         "source": "okvis2x_tpu_torch/csrc/hamming_match.cu",
         "replaces": "okvis2x_tpu/ops/hamming_pallas.py:67",
         "launches": sum(match_sites.values()), "site_launches": match_sites,
         "phase_site_launches": phase_sites,
         **entries["match"]},
        {"name": "hamming_matrix_packed", "route": "cuda",
         "source": "okvis2x_tpu_torch/csrc/hamming.cu",
         "replaces": "okvis2x_tpu/ops/hamming_pallas.py:67",
         "launches": on_matrix, **entries["matrix"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
