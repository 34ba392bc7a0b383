"""The port's dataset app in lidar mode: its synthetic test on the CPU, and
both dataset apps in lidar mode on one dataset: the 8 m circuit at
320x240 and 10 Hz with tools/lidar_scale_run.py's hall sweeps
(`chip_smoke.write_sweeps`) and an se2.yaml of 2-keyframe submaps, so that
submaps close and hand map-to-map edges to the window within 10 frames; the
JAX app in a spawned process on two cores meanwhile the port's runs here.

Tolerances: the trajectories to 1e-5 m; the sweeps integrated, live edges
and map-to-map edges equal; the grids with at most GRID_FLIP_TOL of the
voxels' counts differing (a ray sample on a voxel boundary moves with an ulp
of the float32 sweep points, which XLA computes with fused multiply-adds);
map.ply's vertices equal in number, at most MAP_DIGIT_TOL of them printed
differently, each within a print digit (1e-4 m) of one of the other app's."""

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
from okvis2x_tpu_torch.apps import okvis2x_app  # noqa: E402
from okvis2x_tpu_torch.io import trajectory_io  # noqa: E402
from test_torch_app import jax_app_env, read_ply, record_maps, write_config  # noqa: E402

torch.set_num_threads(1)

APP_FRAMES = 10
APP_POS_TOL_M = 1e-5
GRID_FLIP_TOL = 1e-4
MAP_DIGIT_TOL = 0.05
APP_SE2 = chip_smoke.LIDAR_SE2.replace("submap_kf_threshold: 5", "submap_kf_threshold: 1") \
    .replace("submap_min_frames: 4", "submap_min_frames: 2")


def record_lidar(pkg, argv, out_dir):
    """Run `pkg`'s app in lidar mode on `argv` (`record_maps`, the submaps
    in out_dir/maps.npz) with `chip_smoke.LidarRecorder` around its LiDAR
    pipeline; the recorded counts go to out_dir/counts.json."""
    mod = __import__(f"{pkg}.pipeline.lidar_vio", fromlist=["LidarVioPipeline"])
    with chip_smoke.LidarRecorder(mod.LidarVioPipeline) as rec:
        record_maps(pkg, argv, os.path.join(out_dir, "maps.npz"))
    with open(os.path.join(out_dir, "counts.json"), "w") as f:
        json.dump(dict(sweeps=rec.n_sweeps, integrated=rec.n_integrated, live=rec.n_live,
                       align=rec.n_align, align_frames=rec.align_frames), f)


@pytest.fixture(scope="module")
def lidar_runs(tmp_path_factory):
    """Both apps in lidar mode on APP_FRAMES frames of the circuit with the
    hall sweeps and APP_SE2: the JAX app in a spawned process on two cores
    meanwhile the port's runs here.  Returns (port output, JAX output)."""
    root = tmp_path_factory.mktemp("lidar")
    ds = str(root / "ds")
    duration = 0.3 + APP_FRAMES / 10.0 - 0.05
    _, T_SC, _ = jsyn.generate(ds, duration=duration, frame_rate=10.0, width=320, height=240,
                               trajectory="circuit")
    chip_smoke.write_sweeps(ds, duration - 0.3)
    cfg, se2 = str(root / "okvis2.yaml"), str(root / "se2.yaml")
    write_config(cfg, 320, 240, 280.0, [-0.25, 0.06, 1e-4, -1e-4], T_SC)
    with open(se2, "w") as f:
        f.write(APP_SE2)
    outs = {k: str(root / k) for k in ("port", "jax")}
    for d in outs.values():
        os.makedirs(d)

    def args(k):
        return ["--dataset", ds, "--config", cfg, "--mode", "lidar", "--reader", "xdataset",
                "--se2-config", se2, "--output", outs[k], "--max-frames", str(APP_FRAMES)]

    cores = sorted(os.sched_getaffinity(0))
    pick = sorted(set(cores[-8:][:2]) or set(cores))
    run = (f"import os, sys; os.sched_setaffinity(0, {pick}); "
           f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r}); "
           "import test_torch_lidar_app as t; "
           f"t.record_lidar('okvis2x_tpu', {args('jax')!r}, {outs['jax']!r})")
    env = jax_app_env(tmp_path_factory)
    with open(os.path.join(outs["jax"], "log.txt"), "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", run], cwd=REPO, env=env, stdout=log,
                               stderr=subprocess.STDOUT)
        try:
            record_lidar("okvis2x_tpu_torch", args("port"), outs["port"])
            rc = ref.wait(timeout=1200)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    with open(os.path.join(outs["jax"], "log.txt")) as f:
        assert rc == 0, f.read()[-3000:]
    return outs["port"], outs["jax"]


def test_lidar_app_matches_jax_app(lidar_runs):
    """`--mode lidar`: both trajectories within APP_POS_TOL_M of the JAX
    app's; the same sweeps integrated, live edges and map-to-map edges; the
    same submaps with their grids; map.ply's vertices the JAX app's (to the
    print digit)."""
    port, ref = lidar_runs
    for name in ("trajectory.tum", "final_trajectory.tum"):
        a = np.loadtxt(os.path.join(port, name))
        b = np.loadtxt(os.path.join(ref, name))
        assert a.shape == b.shape and len(a) >= (APP_FRAMES if name[0] == "t" else 1)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        assert float(np.abs(a[:, 1:4] - b[:, 1:4]).max()) < APP_POS_TOL_M, name
    with open(os.path.join(port, "counts.json")) as f, open(os.path.join(ref, "counts.json")) as g:
        ca, cb = json.load(f), json.load(g)
    # sweeps end every 0.1 s from 0.4 s on: 6 before the tenth frame
    assert ca == cb and ca["integrated"] == ca["sweeps"] >= 5 and ca["live"] >= 1 \
        and ca["align"] >= 1, (ca, cb)
    ma, mb = np.load(os.path.join(port, "maps.npz")), np.load(os.path.join(ref, "maps.npz"))
    assert int(ma["n"]) == int(mb["n"]) >= 3
    for i in range(int(ma["n"])):
        np.testing.assert_array_equal(ma[f"meta{i}"], mb[f"meta{i}"])
        np.testing.assert_allclose(ma[f"T_WK{i}"], mb[f"T_WK{i}"], rtol=0, atol=1e-6)
        same = ma[f"weight{i}"] == mb[f"weight{i}"]
        assert (~same).mean() <= GRID_FLIP_TOL and (mb[f"weight{i}"] > 0).sum() > 1000
        np.testing.assert_allclose(ma[f"logodds{i}"][same], mb[f"logodds{i}"][same], rtol=0,
                                   atol=1e-5)
    pa, _ = read_ply(os.path.join(port, "map.ply"))
    pb, _ = read_ply(os.path.join(ref, "map.ply"))
    assert len(pa) == len(pb) > 50
    # vertices printed differently: float32 world coordinates of the same
    # voxel centres, rounded to 1e-4 m on either side of a last digit
    xa, xb = (np.array([[float(v) for v in p.split()] for p in x]).reshape(-1, 3)
              for x in (pa - pb, pb - pa))
    assert len(xa) == len(xb) <= MAP_DIGIT_TOL * len(pb)
    if len(xa):
        assert np.abs(xa[:, None] - xb[None]).max(-1).min(1).max() <= 1.5e-4


def test_lidar_synthetic_test_writes_trajectories_and_map(tmp_path):
    """`--synthetic-test --mode lidar --device cpu` on a few frames: the
    sweeps go into a submap, and the online and final-BA trajectories and
    map.ply are written."""
    from okvis2x_tpu_torch.pipeline.lidar_vio import LidarVioPipeline

    out = str(tmp_path / "out")
    made = []
    init = LidarVioPipeline.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    LidarVioPipeline.__init__ = spy
    try:
        ate = okvis2x_app.main(["--synthetic-test", "--mode", "lidar", "--output", out,
                                "--device", "cpu", "--max-frames", "5"])
    finally:
        LidarVioPipeline.__init__ = init
    assert np.isfinite(ate) and made[0].submapper.maps
    assert made[0].submapper.active.n_frames >= 1
    for name in ("trajectory.tum", "final_trajectory.tum", "map.ply"):
        assert os.path.exists(os.path.join(out, name))
    assert len(trajectory_io.read_tum(os.path.join(out, "trajectory.tum"))[0]) == 5
