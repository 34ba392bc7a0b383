"""The port's dataset app against `apps/okvis2x_app.py` in `depth` mode with an
se2.yaml finer than 256^3: 25.6 m at 0.05 m (512^3), so both apps map into the
brick-sparse grid (a 64^3 table, 8192 bricks); 8 frames at 320x240 and 10 Hz
of tests/test_torch_app.py's dataset with an rgb cam0, the JAX app in a
process of its own on two cores meanwhile the port's runs here.

Tolerances: the trajectories within 1e-5 m; the submaps' tables, slot
coordinates and allocated counts exactly; integration counts on all but
BRICK_FLIP_TOL of the observed voxels and log-odds within 1e-5 on the others
(a ray sample on a voxel boundary moves with an ulp of the float32 keyframe
anchor, C-H10: 202 of 601,893 voxels here, 3.4e-4, where the 0.2 m grid of
tests/test_torch_app.py flips under 1e-4, its voxels 64 times the volume),
colours within 1e-4 there; map.ply's voxel centres as sets within 2% of the
JAX app's points, the colours of the common points within 1/255, as
tests/test_torch_app.py holds the dense grid."""

import os
import subprocess
import sys

import numpy as np

from okvis2x_tpu.io import synthetic as jsyn
from okvis2x_tpu_torch.apps import okvis2x_app

from test_torch_app import (DEPTH_POS_TOL_M, MAP_SET_TOL, REPO, jax_app_env, read_ply,
                            write_config)

N_FRAMES = 8
BRICK_FLIP_TOL = 1e-3
FINE_SE2 = """general:
  submap_kf_threshold: 50
  submap_overlap_ratio: 0.1
  submap_min_frames: 4
  depth_image_resolution_downsampling: 4
  far_plane: 20.0
map:
  dim: [25.6, 25.6, 25.6]
  res: 0.05
"""


def record_bricks(pkg, argv, out_npz):
    """Run `pkg`'s dataset app on `argv` and keep its brick submaps (anchor,
    keyframes, frames, table, slot coordinates, count, pool, colour sums) in
    `out_npz` when it exports map.ply."""
    import runpy

    sub = __import__(f"{pkg}.pipeline.submapping", fromlist=["SubmappingInterface"])
    export = sub.SubmappingInterface.export_occupied_ply

    def keep(self, path, *a, **kw):
        arr = {}
        for i, e in enumerate(self.maps):
            arr[f"meta{i}"] = np.array([e.anchor_fid, e.n_frames, len(e.kf_ids)])
            for k in ("T_WK", "table", "brick_xyz", "n_alloc", "pool_lo", "pool_w"):
                arr[f"{k}{i}"] = np.asarray(getattr(e.sm, k))
            if e.col is not None:
                arr[f"col{i}"] = np.asarray(e.col.col)
        np.savez(out_npz, n=len(self.maps), **arr)
        return export(self, path, *a, **kw)

    sub.SubmappingInterface.export_occupied_ply = keep
    try:
        if pkg == "okvis2x_tpu":
            saved, sys.argv = sys.argv, ["okvis2x_app.py", *argv]
            try:
                runpy.run_path(os.path.join(REPO, "apps", "okvis2x_app.py"), run_name="__main__")
            finally:
                sys.argv = saved
        else:
            okvis2x_app.main([*argv, "--device", "cpu"])
    finally:
        sub.SubmappingInterface.export_occupied_ply = export


def test_fine_depth_app_matches_jax_app(tmp_path, tmp_path_factory):
    """Both apps `--mode depth --se2-config` at 0.05 m: the same trajectories,
    the same brick submaps (allocation exactly), grids and colours, and
    map.ply."""
    ds = str(tmp_path / "ds")
    _, T_SC, _ = jsyn.generate(ds, duration=0.3 + N_FRAMES / 10.0 - 0.05, frame_rate=10.0,
                               width=320, height=240, with_depth=True)
    cfg = str(tmp_path / "okvis2.yaml")
    write_config(cfg, 320, 240, 280.0, [-0.25, 0.06, 1e-4, -1e-4], T_SC)
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("camera_type: gray", "camera_type: rgb", 1))
    se2 = str(tmp_path / "se2.yaml")
    with open(se2, "w") as f:
        f.write(FINE_SE2)
    outs = {k: str(tmp_path / k) for k in ("port", "jax")}
    for d in outs.values():
        os.makedirs(d)

    def args(k):
        return ["--dataset", ds, "--config", cfg, "--mode", "depth", "--reader", "xdataset",
                "--se2-config", se2, "--output", outs[k], "--max-frames", str(N_FRAMES)]

    cores = sorted(os.sched_getaffinity(0))
    pick = sorted(set(cores[-8:][4:6]) or set(cores))
    npz = {k: os.path.join(outs[k], "maps.npz") for k in outs}
    run = (f"import os, sys; os.sched_setaffinity(0, {pick}); "
           f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r}); import test_torch_fine_app as t; "
           f"t.record_bricks('okvis2x_tpu', {args('jax')!r}, {npz['jax']!r})")
    env = jax_app_env(tmp_path_factory)
    with open(os.path.join(outs["jax"], "log.txt"), "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", run], cwd=REPO, env=env, stdout=log,
                               stderr=subprocess.STDOUT)
        try:
            record_bricks("okvis2x_tpu_torch", args("port"), npz["port"])
            rc = ref.wait(timeout=1200)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    with open(os.path.join(outs["jax"], "log.txt")) as f:
        assert rc == 0, f.read()[-3000:]

    for name in ("trajectory.tum", "final_trajectory.tum"):
        a = np.loadtxt(os.path.join(outs["port"], name))
        b = np.loadtxt(os.path.join(outs["jax"], name))
        assert a.shape == b.shape and len(a) >= (N_FRAMES if name[0] == "t" else 1)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        assert float(np.abs(a[:, 1:4] - b[:, 1:4]).max()) < DEPTH_POS_TOL_M, name
    ma, mb = np.load(npz["port"]), np.load(npz["jax"])
    assert int(ma["n"]) == int(mb["n"]) >= 1
    for i in range(int(ma["n"])):
        np.testing.assert_array_equal(ma[f"meta{i}"], mb[f"meta{i}"])
        np.testing.assert_allclose(ma[f"T_WK{i}"], mb[f"T_WK{i}"], rtol=0, atol=1e-6)
        for k in ("table", "brick_xyz", "n_alloc"):
            np.testing.assert_array_equal(ma[f"{k}{i}"], mb[f"{k}{i}"])
        assert 100 < int(mb[f"n_alloc{i}"]) < 8192  # allocated, not capped by the pool
        wa, wb = ma[f"pool_w{i}"], mb[f"pool_w{i}"]
        same = wa == wb
        assert (~same).sum() <= BRICK_FLIP_TOL * (wb > 0).sum() and (wb > 0).sum() > 10000
        np.testing.assert_allclose(ma[f"pool_lo{i}"][same], mb[f"pool_lo{i}"][same], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(ma[f"col{i}"][:-1][same[:-1]], mb[f"col{i}"][:-1][same[:-1]],
                                   rtol=0, atol=1e-4)
    pa, ca = read_ply(os.path.join(outs["port"], "map.ply"))
    pb, cb = read_ply(os.path.join(outs["jax"], "map.ply"))
    assert len(pa ^ pb) <= MAP_SET_TOL * len(pb), (len(pa), len(pb), len(pa ^ pb))
    assert (ca is not None) == (cb is not None) == (len(pb) > 0)
    if ca is not None and pa & pb:
        assert max(max(abs(x - y) for x, y in zip(ca[p], cb[p])) for p in pa & pb) <= 1
