"""The port's network node (`okvis2x_tpu_torch/apps/okvis2x_network_node.py`)
against `apps/okvis2x_network_node.py`: the case of
tests/test_ros2_layer.py::test_network_node_graph (the generator's 96x64
dataset at 10 Hz, tests/test_ros2_layer.py's small estimator and pipeline,
16 disparities) through both packages' `build_network_graph` over their
`LocalTransport`s, in this process, each fed the same messages
(`chip_smoke.publish_dataset`), the port on the CPU.

Both runs must publish a depth, a sigma and an odometry message a frame;
the depth and sigma of each frame must agree (census stereo in float32 in
both: where the two aggregated cost volumes tie, C-H3, the winning
disparity may differ, so a pixel agrees when both are invalid or both are
valid within DEPTH_RTOL, relative, and at least DEPTH_SHARE of each
frame's pixels agree); the odometry positions within POS_TOL_M (tests/test_torch_app.py's
tolerance for the `vio` mode).

    python tests/test_torch_network_node.py

runs the JAX network node on the CPU on `chip_smoke.py`'s live-nodes phase
(the app phase's 12 frames at 752x480, the JAX `main`'s defaults) and prints
`chip_smoke.network_metrics` of its run, the bound of that phase
(`chip_smoke.JAX_NETWORK_NODE`).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from okvis2x_tpu import ros2 as jros2  # noqa: E402
from okvis2x_tpu.graph import EstimatorConfig as JEstimatorConfig  # noqa: E402
from okvis2x_tpu.io import synthetic as jsyn  # noqa: E402
from okvis2x_tpu.pipeline.vio import PipelineConfig as JPipelineConfig  # noqa: E402
from okvis2x_tpu.ros2 import messages as jm  # noqa: E402
from okvis2x_tpu_torch import convert  # noqa: E402
from okvis2x_tpu_torch import ros2 as tros2  # noqa: E402
from okvis2x_tpu_torch.apps.okvis2x_network_node import build_network_graph  # noqa: E402
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig  # noqa: E402
from okvis2x_tpu_torch.pipeline.vio import PipelineConfig  # noqa: E402
from okvis2x_tpu_torch.ros2 import messages as tm  # noqa: E402
from test_torch_app import POS_TOL_M  # noqa: E402

torch.set_num_threads(1)

EST = dict(num_keyframes=3, num_imu_frames=2, cap_frames=6, cap_landmarks=128, cap_obs=1024,
           cap_imu_links=5, cap_imu_samples=64, max_iterations=2)
PIPE = dict(max_keypoints=64, octaves=1, harris_threshold=1e-6)
MAX_DISP = 16
DEPTH_RTOL = 1e-5
DEPTH_SHARE = 0.995  # the 96x64 frames part on at most 8 of 6144 pixels


def jax_network_graph():
    """The JAX package's `build_network_graph` (apps/ on the path, as its
    tests import it)."""
    sys.path.insert(0, os.path.join(REPO, "apps"))
    try:
        from okvis2x_network_node import build_network_graph as jbuild
    finally:
        sys.path.pop(0)
    return jbuild


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port network node on the dataset; returns (the
    frames published, {package: transport})."""
    ds = str(tmp_path_factory.mktemp("network") / "ds")
    cam, T_SC, _ = jsyn.generate(ds, duration=0.8, frame_rate=10.0, width=96, height=64)
    trs = {"jax": jros2.LocalTransport(), "port": tros2.LocalTransport()}
    jcore, _, _, _ = jax_network_graph()(trs["jax"], [cam, cam], T_SC,
                                         est_cfg=JEstimatorConfig(**EST),
                                         pipe_cfg=JPipelineConfig(**PIPE), max_disp=MAX_DISP)
    tcam = convert.camera(cam)
    core, _, _, _ = build_network_graph(trs["port"], [tcam, tcam], T_SC,
                                        est_cfg=EstimatorConfig(**EST),
                                        pipe_cfg=PipelineConfig(**PIPE), max_disp=MAX_DISP,
                                        device="cpu")
    n = len(chip_smoke.publish_dataset(trs["jax"], ds, jm))
    assert len(chip_smoke.publish_dataset(trs["port"], ds, tm)) == n
    jcore.pipe.finish()
    core.pipe.finish()
    return n, trs


def test_topics_a_message_a_frame(runs):
    """tests/test_ros2_layer.py's counts on both nodes: a depth, a sigma and
    an odometry message a frame, depth of the image's shape, finite where
    valid."""
    n, trs = runs
    assert n >= 3
    for tr in trs.values():
        assert tr.count("okvis/network/depth") == n
        assert tr.count("okvis/network/depth_sigma") == n
        assert tr.count("okvis/odometry") == n
        d = tr.last("okvis/network/depth").data
        assert d.shape == (64, 96) and np.isfinite(d[d > 0]).all()


@pytest.mark.parametrize("topic", ["okvis/network/depth", "okvis/network/depth_sigma"])
def test_depth_and_sigma_match_jax(runs, topic):
    _, trs = runs
    for a, b in zip(trs["port"].history[topic], trs["jax"].history[topic]):
        assert (a.header.stamp, a.header.frame_id, a.encoding) == (
            b.header.stamp, b.header.frame_id, b.encoding)
        x, y = np.asarray(a.data), np.asarray(b.data, np.float32)
        assert x.dtype == np.float32 and x.shape == y.shape
        # invalid: depth 0, sigma inf
        ok_x, ok_y = ((np.isfinite(v) if topic.endswith("sigma") else v > 0) for v in (x, y))
        with np.errstate(invalid="ignore"):
            same = np.where(ok_y, ok_x & (np.abs(x - y) <= DEPTH_RTOL * np.abs(y)), ~ok_x)
        assert same.mean() >= DEPTH_SHARE, same.mean()


def test_odometry_matches_jax(runs):
    _, trs = runs
    a, b = (tr.history["okvis/odometry"] for tr in (trs["port"], trs["jax"]))
    assert [o.header.stamp for o in a] == [o.header.stamp for o in b]
    pa, pb = (np.stack([np.asarray(o.T_WB[:3], np.float64) for o in h]) for h in (a, b))
    assert np.isfinite(pa).all()
    gap = float(np.abs(pa - pb).max())
    assert gap < POS_TOL_M, gap


def jax_network_bound(root):
    """The JAX network node on the CPU on the live-nodes phase's input (the
    app phase's dataset and config, written under `root`) under its `main`'s
    defaults: `chip_smoke.network_metrics` of its run."""
    from okvis2x_tpu.io import config as jconfig
    from okvis2x_tpu.utils import jaxconfig

    jaxconfig.setup()
    ds_dir, cfg, _ = chip_smoke.app_dataset(root)
    vi = jconfig.load(cfg)
    cameras = [c.camera for c in vi.cameras[:2]]
    T_SC = np.stack([c.T_SC for c in vi.cameras[:2]])
    tr = jros2.LocalTransport()
    core, _, _, _ = jax_network_graph()(tr, cameras, T_SC, num_cams=len(cameras),
                                        prefix=chip_smoke.NETWORK_PREFIX,
                                        max_disp=chip_smoke.NETWORK_MAX_DISP)
    chip_smoke.publish_dataset(tr, ds_dir, jm)
    core.pipe.finish()
    return chip_smoke.network_metrics(tr, ds_dir)


if __name__ == "__main__":
    print(json.dumps(jax_network_bound(os.path.join(REPO, "build", "network_rehearsal"))))
