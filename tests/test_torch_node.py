"""The port's synchronous node against `apps/okvis2x_node_synchronous.py`:
tests/test_node_synchronous.py's dataset (1.2 s of the JAX package's
synthetic EuRoC layout at 160x120 and 10 Hz) repacked as a ROS1 and a ROS2
bag by `chip_smoke.write_bags`, and `MINIMAL_YAML`, `--max-frames 5 --max-keypoints 128 --no-loop-closures`,
through the port's node on the CPU and through the JAX node in a process of
its own on two cores; and what the port refuses (a missing CUDA device).

Both nodes' trajectory files must have the same rows and stamps, with
positions within POS_TOL_M (tests/test_torch_app.py's tolerance for the
`vio` mode).  The ROS2 bag carries the same messages, so the port's run on
it must equal its run on the ROS1 bag.

    python tests/test_torch_node.py

runs the JAX node on the CPU on the ROS1 bag of `chip_smoke.py`'s
bag-replay phase (the app phase's 12 frames at 752x480, the node's
defaults) and prints `chip_smoke.node_metrics`, the bound of that phase
(`chip_smoke.JAX_NODE`).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from okvis2x_tpu.io import synthetic as jsyn  # noqa: E402
from okvis2x_tpu_torch.apps import okvis2x_node_synchronous as node  # noqa: E402
from test_node_synchronous import MINIMAL_YAML  # noqa: E402
from test_torch_app import POS_TOL_M, jax_app_env  # noqa: E402

torch.set_num_threads(1)

MAX_FRAMES = 5
TRAJECTORIES = ("okvis2_trajectory.csv", "okvis2_final_trajectory.csv")


@pytest.fixture(scope="module")
def node_runs(tmp_path_factory):
    """The JAX node on the ROS1 bag in a spawned process meanwhile the port's
    node runs here on both bags.  Returns the output dirs by run."""
    root = tmp_path_factory.mktemp("node")
    ds = str(root / "synth")
    jsyn.generate(ds, duration=1.2, frame_rate=10.0, width=160, height=120, n_points=200)
    bag1, bag2, _ = chip_smoke.write_bags(ds, str(root))
    bags = {"ros1": bag1, "ros2": bag2}
    cfg = str(root / "mini.yaml")
    with open(cfg, "w") as f:
        f.write(MINIMAL_YAML)
    outs = {k: str(root / k) for k in ("jax", "ros1", "ros2")}

    def args(bag, out):
        return ["--bag", bag, "--config", cfg, "--output", out, "--max-frames", str(MAX_FRAMES),
                "--max-keypoints", "128", "--no-loop-closures"]

    # the JAX node on two cores of its own, as tests/test_torch_app.py spawns
    # the JAX app (XLA's idle CPU threads spin)
    cores = sorted(os.sched_getaffinity(0))
    pick = sorted(set(cores[-8:][:2]) or set(cores))
    run = (f"import os, runpy, sys; os.sched_setaffinity(0, {pick}); sys.argv = sys.argv[1:]; "
           "runpy.run_path(sys.argv[0], run_name='__main__')")
    os.makedirs(outs["jax"])
    with open(os.path.join(outs["jax"], "log.txt"), "w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", run, os.path.join(REPO, "apps", "okvis2x_node_synchronous.py"),
             *args(bags["ros1"], outs["jax"])],
            cwd=REPO, env=jax_app_env(tmp_path_factory), stdout=log, stderr=subprocess.STDOUT)
        try:
            for k in ("ros1", "ros2"):
                assert node.main([*args(bags[k], outs[k]), "--device", "cpu"]) == 0
            rc = ref.wait(timeout=900)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    with open(os.path.join(outs["jax"], "log.txt")) as f:
        assert rc == 0, f.read()[-3000:]
    return outs


@pytest.mark.parametrize("name", TRAJECTORIES)
def test_node_matches_jax_node(node_runs, name):
    """The same rows and stamps; positions within POS_TOL_M, rotations close;
    everything finite; the online file a row a frame."""
    a = np.loadtxt(os.path.join(node_runs["ros1"], name))
    b = np.loadtxt(os.path.join(node_runs["jax"], name))
    assert a.shape == b.shape and a.shape[1] == 8
    if name == TRAJECTORIES[0]:
        assert a.shape[0] == MAX_FRAMES
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    assert np.isfinite(a).all()
    gap = float(np.abs(a[:, 1:4] - b[:, 1:4]).max())
    assert gap < POS_TOL_M, gap
    assert float(np.abs(np.abs((a[:, 4:] * b[:, 4:]).sum(1)) - 1).max()) < 1e-4


def test_ros2_bag_replays_as_ros1(node_runs):
    """The ROS2 bag holds the same messages, so both trajectory files equal
    the ROS1 run's to the digit."""
    for name in TRAJECTORIES:
        a = np.loadtxt(os.path.join(node_runs["ros2"], name))
        b = np.loadtxt(os.path.join(node_runs["ros1"], name))
        np.testing.assert_array_equal(a, b)


def test_node_needs_cuda_without_device(tmp_path):
    """Without --device the node runs on cuda:0; where there is no CUDA
    device it raises `default_device`'s error before it reads the bag or
    writes anything, and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (chip_smoke.py replays a bag there)")
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA"):
        node.main(["--bag", str(tmp_path / "missing.bag"), "--config",
                   str(tmp_path / "missing.yaml"), "--output", out])
    assert not os.path.exists(out)


def jax_node_bound(root):
    """The JAX node on the CPU on the bag-replay phase's ROS1 bag (the app
    phase's dataset and config, written under `root`):
    `chip_smoke.node_metrics` of its run."""
    ds_dir, cfg, _ = chip_smoke.app_dataset(root)
    bag1, _, _ = chip_smoke.write_bags(ds_dir, root)
    out = os.path.join(root, "jax_out")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_CACHE_DIR=os.path.join(root, "jax_cache"))
    subprocess.run([sys.executable, os.path.join(REPO, "apps", "okvis2x_node_synchronous.py"),
                    "--bag", bag1, "--config", cfg, "--output", out], cwd=REPO, env=env,
                   check=True)
    return chip_smoke.node_metrics(ds_dir, out)


if __name__ == "__main__":
    print(json.dumps(jax_node_bound(os.path.join(REPO, "build", "node_rehearsal"))))
