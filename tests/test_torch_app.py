"""The port's dataset app against `apps/okvis2x_app.py`: both apps on one
EuRoC-layout dataset written by the JAX package's generator and one
okvis2.yaml-schema config, in `vio` mode on the CPU (the JAX app in a
process of its own on two cores), and again on an extended-layout dataset
with a GNSS stream and online extrinsics calibration in the config, and on
one with a depth0/ stream in the `rgbd` and `depth` modes; the `slam` mode
on a synthetic dataset; the recorder; the config's calibration sigmas; and
what the port refuses (a missing CUDA device).  The lidar mode is in
tests/test_torch_lidar_app.py, the depth mode on a brick-sparse grid in
tests/test_torch_fine_app.py."""

import filecmp
import os
import runpy
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from okvis2x_tpu.io import synthetic as jsyn
from okvis2x_tpu_torch.apps import okvis2x_app
from okvis2x_tpu_torch.io import euroc, png, synthetic, trajectory_io

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8
POS_TOL_M = 0.01  # as tests/test_torch_slice.py holds the two pipelines
# the GNSS run: 12 frames of the flagship circuit at 320x240 and 10 Hz (the
# alignment needs 6 fixes over 1 m of motion: "Initialised" at frame 10)
GNSS_FRAMES = 12
# the two apps agree to 1e-8 on these 12 frames; held to 1e-6 (T_GW in m and
# quaternion entries, T_SC likewise) and 1e-5 m on the positions of the TUM files
GNSS_TOL = 1e-6
GNSS_POS_TOL_M = 1e-5
# the depth modes at 320x240 and 10 Hz with depth0/ (every frame a keyframe:
# the rgbd mode fuses from the third keyframe on), the depth mode on a dataset
# of 12 frames and the rgbd mode on one of 8; the trajectories agree to 1e-7 m
# over these frames, held to 1e-5 m (until the descriptors' extraction
# direction took XLA's cosf and sinf, both parted at the ninth frame, C4 in
# ROADMAP.md; at 12 frames the rgbd mode's trajectories hold too, but the two
# apps' states at keyframe 6 move its fused depth, in the JAX program itself,
# by 1.75e-3 m, and with it 6 of its 2M voxels' log-odds by up to 1.28e-5,
# past the 1e-5 below: C-H14, tests/test_torch_descriptor_parity.py::
# test_state_difference_moves_fused_depth_in_jax).  The submaps' grids: integration
# counts equal on all but 1e-4 of the voxels and log-odds within 1e-5 on the
# others (a ray sample on a voxel boundary moves with an ulp of the float32
# keyframe anchor, which XLA inverts with fused multiply-adds); map.ply's
# voxel centres as sets, the symmetric difference within 2% of the JAX app's
# points, the colours of the common points within 1/255
DEPTH_FRAMES = {"rgbd": 8, "depth": 12}
DEPTH_POS_TOL_M = 1e-5
GRID_FLIP_TOL = 1e-4
MAP_SET_TOL = 0.02


def jax_app_env(tmp_path_factory):
    """The environment of a spawned JAX app: the CPU platform, and the test
    run's compile cache (`run_cache_dir`) in place of the app's own under
    the checkout, so that the apps spawned within one run compile each XLA
    program once between them."""
    from test_torch_lc_slice import run_cache_dir

    return dict(os.environ, JAX_PLATFORMS="cpu", JAX_CACHE_DIR=run_cache_dir(tmp_path_factory))


def write_config(path, width, height, fx, dist, T_SC, calibration=""):
    """An okvis2.yaml-schema config for the generator's stereo rig, written
    as the reference's files are: the %YAML header, flow-mapping cameras;
    `calibration` is the body of a camera_parameters section."""
    cams = []
    for T in T_SC:
        M = np.eye(4)
        M[:3, 3] = T[:3]
        rows = ",\n         ".join(", ".join(repr(float(v)) for v in r) for r in M)
        cams.append(f"""    - {{T_SC:
        [ {rows}],
        image_dimension: [{width}, {height}],
        distortion_coefficients: [{", ".join(repr(d) for d in dist)}],
        distortion_type: radialtangential,
        focal_length: [{fx!r}, {fx!r}],
        principal_point: [{width / 2!r}, {height / 2!r}],
        camera_type: gray, # gray, rgb, gray+depth, rgb+depth
        slam_use: okvis}}""")
    if calibration:
        calibration = "\ncamera_parameters:\n" + calibration
    with open(path, "w") as f:
        f.write("%YAML:1.0\ncameras:\n" + "\n".join(cams) + "\n" + calibration + """
imu_parameters:
    use: true
    a_max: 176.0 # acceleration saturation [m/s^2]
    g_max: 7.8 # gyro saturation [rad/s]
    sigma_g_c: 12.0e-4
    sigma_a_c: 8.0e-3
    sigma_bg: 0.03
    sigma_ba: 0.1
    sigma_gw_c: 4.0e-6
    sigma_aw_c: 4.0e-5
    g: 9.81007

estimator_parameters:
    num_keyframes: 5
    num_loop_closure_frames: 5
    num_imu_frames: 3
    do_loop_closures: true
    realtime_max_iterations: 4
""")


@pytest.fixture(scope="module")
def vio_runs(tmp_path_factory):
    """Both apps in `vio` mode with both debug CSVs on one dataset and
    config: the JAX app in a spawned process meanwhile the port's runs here.
    Returns (dataset dir, port output dir, JAX output dir, port's ATE)."""
    root = tmp_path_factory.mktemp("app")
    ds = str(root / "ds")
    kw = dict(duration=0.3 + N_FRAMES / 10.0 - 0.05, frame_rate=10.0, width=320, height=240)
    _, T_SC, _ = jsyn.generate(ds, **kw)
    cfg = str(root / "okvis2.yaml")
    write_config(cfg, 320, 240, 280.0, [-0.25, 0.06, 1e-4, -1e-4], T_SC)
    outs = {k: str(root / k) for k in ("port", "jax")}
    for d in outs.values():
        os.makedirs(d)

    def args(k):
        return ["--dataset", ds, "--config", cfg, "--mode", "vio", "--output", outs[k],
                "--max-frames", str(N_FRAMES), "--imu-csv", os.path.join(outs[k], "imu.csv"),
                "--tracks-csv", os.path.join(outs[k], "tracks.csv")]

    # the reference app on two cores of its own: XLA's idle CPU threads spin
    # (tests/test_torch_lc_slice.py's `pin_to_cores` takes the last six)
    cores = sorted(os.sched_getaffinity(0))
    pick = sorted(set(cores[-8:][:2]) or set(cores))
    run = (f"import os, runpy, sys; os.sched_setaffinity(0, {pick}); sys.argv = sys.argv[1:]; "
           "runpy.run_path(sys.argv[0], run_name='__main__')")
    env = jax_app_env(tmp_path_factory)
    with open(os.path.join(outs["jax"], "log.txt"), "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", run,
                                os.path.join(REPO, "apps", "okvis2x_app.py"), *args("jax")],
                               cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            ate = okvis2x_app.main([*args("port"), "--device", "cpu"])
            rc = ref.wait(timeout=1200)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    with open(os.path.join(outs["jax"], "log.txt")) as f:
        assert rc == 0, f.read()[-3000:]
    return ds, outs["port"], outs["jax"], ate


def test_vio_app_matches_jax_app(vio_runs):
    """The same frame times; positions within 1 cm and rotations close; the
    IMU CSVs identical; the ATE finite."""
    _, port, ref, ate = vio_runs
    a = np.loadtxt(os.path.join(port, "trajectory.tum"))
    b = np.loadtxt(os.path.join(ref, "trajectory.tum"))
    assert a.shape == b.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    gap = float(np.abs(a[:, 1:4] - b[:, 1:4]).max())
    assert gap < POS_TOL_M, gap
    assert float(np.abs(np.abs((a[:, 4:] * b[:, 4:]).sum(1)) - 1).max()) < 1e-4
    assert filecmp.cmp(os.path.join(port, "imu.csv"), os.path.join(ref, "imu.csv"),
                       shallow=False)
    assert np.isfinite(ate) and ate < 0.5
    assert not os.path.exists(os.path.join(port, "final_trajectory.tum"))


def test_vio_app_tracks_csv(vio_runs):
    """The tracks CSV has the reference's header and a row per tracked
    keypoint of cam 0 in every frame, as many as the JAX app's within 10%."""
    ds, port, ref, _ = vio_runs
    rows = {}
    for k, d in (("port", port), ("jax", ref)):
        with open(os.path.join(d, "tracks.csv")) as f:
            lines = f.read().splitlines()
        assert lines[0] == "timestamp, landmark_id, z_tilde_x, z_tilde_y, z_tilde_stdev, descriptor"
        rows[k] = [ln.split(", ") for ln in lines[1:]]
    times = sorted({float(r[0]) for r in rows["port"]})
    assert len(times) == N_FRAMES
    np.testing.assert_allclose(times, [f.t for f in euroc.EurocDataset(ds).frames[:N_FRAMES]],
                               rtol=0, atol=1e-9)
    assert all(len(r[5]) == 96 for r in rows["port"])  # 12 words of 4 bytes, in hex
    assert abs(len(rows["port"]) - len(rows["jax"])) <= 0.1 * len(rows["jax"])


def record_app(pkg, argv, out_npz):
    """Run `pkg`'s dataset app on `argv`, recording after each frame the GNSS
    status, T_GW and T_SC (`chip_smoke.GnssRecorder`), into `out_npz`."""
    sys.path.insert(0, REPO)
    import chip_smoke

    vio = __import__(f"{pkg}.pipeline.vio", fromlist=["VioPipeline"])
    est = __import__(f"{pkg}.graph.estimator", fromlist=["SlidingWindowEstimator"])
    with chip_smoke.GnssRecorder(vio.VioPipeline, est.SlidingWindowEstimator) as rec:
        if pkg == "okvis2x_tpu":
            saved, sys.argv = sys.argv, ["okvis2x_app.py", *argv]
            try:
                runpy.run_path(os.path.join(REPO, "apps", "okvis2x_app.py"), run_name="__main__")
            finally:
                sys.argv = saved
        else:
            okvis2x_app.main([*argv, "--device", "cpu"])
    np.savez(out_npz, status=np.array(rec.status), T_GW=np.stack(rec.T_GW),
             T_SC=np.stack(rec.T_SC), n_gps_solves=getattr(rec.pipe.est, "n_gps_solves", -1))


@pytest.fixture(scope="module")
def gnss_runs(tmp_path_factory):
    """Both apps in `vio` mode on GNSS_FRAMES frames of the GNSS phase's
    dataset and config of `chip_smoke.py` (the flagship circuit with its gps0/
    stream, online extrinsics calibration at the default sigmas, 10 LM
    iterations: with fewer, the early positions are too short for the
    alignment within 16 frames) at 320x240 and 10 Hz: the JAX app in a
    spawned process on two cores meanwhile the port's runs here.  Returns
    (port output dir, JAX output dir)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    root = tmp_path_factory.mktemp("gnss")
    ds, cfg, _ = chip_smoke.gnss_dataset(str(root), GNSS_FRAMES, width=320, height=240,
                                         fx=196.0, frame_rate=10.0)
    outs = {k: str(root / k) for k in ("port", "jax")}
    for d in outs.values():
        os.makedirs(d)

    def args(k):
        return ["--dataset", ds, "--config", cfg, "--mode", "vio", "--output", outs[k],
                "--max-frames", str(GNSS_FRAMES)]

    cores = sorted(os.sched_getaffinity(0))
    pick = sorted(set(cores[-8:][:2]) or set(cores))
    rec = os.path.join(outs["jax"], "rec.npz")
    run = (f"import os, sys; os.sched_setaffinity(0, {pick}); "
           f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r}); import test_torch_app as t; "
           f"t.record_app('okvis2x_tpu', {args('jax')!r}, {rec!r})")
    env = jax_app_env(tmp_path_factory)
    with open(os.path.join(outs["jax"], "log.txt"), "w") as log:
        ref = subprocess.Popen([sys.executable, "-c", run], cwd=REPO, env=env, stdout=log,
                               stderr=subprocess.STDOUT)
        try:
            record_app("okvis2x_tpu_torch", args("port"), os.path.join(outs["port"], "rec.npz"))
            rc = ref.wait(timeout=1200)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    with open(os.path.join(outs["jax"], "log.txt")) as f:
        assert rc == 0, f.read()[-3000:]
    return outs["port"], outs["jax"]


def test_gnss_calibration_app_matches_jax_app(gnss_runs):
    """GNSS fixes and online calibration through both apps: the status of
    every frame equal (Idle, then Initialised within the run), at least one
    window solve with a GNSS row, T_GW and T_SC within GNSS_TOL of the JAX
    app's every frame and T_SC moved, positions within GNSS_POS_TOL_M."""
    port, ref = gnss_runs
    a, b = np.load(os.path.join(port, "rec.npz")), np.load(os.path.join(ref, "rec.npz"))
    assert list(a["status"]) == list(b["status"])
    assert "Initialised" in list(a["status"]) and a["status"][0] == "Idle"
    assert int(a["n_gps_solves"]) >= 1
    np.testing.assert_allclose(a["T_GW"], b["T_GW"], rtol=0, atol=GNSS_TOL)
    np.testing.assert_allclose(a["T_SC"], b["T_SC"], rtol=0, atol=GNSS_TOL)
    assert np.abs(a["T_SC"][-1] - a["T_SC"][0]).max() > 1e-4
    ta = np.loadtxt(os.path.join(port, "trajectory.tum"))
    tb = np.loadtxt(os.path.join(ref, "trajectory.tum"))
    assert ta.shape == tb.shape == (GNSS_FRAMES, 8)
    assert float(np.abs(ta[:, 1:4] - tb[:, 1:4]).max()) < GNSS_POS_TOL_M


def read_ply(path):
    """(vertex lines as a set of strings of the xyz, {xyz: rgb} or None)."""
    with open(path) as f:
        lines = f.read().splitlines()
    body = lines[lines.index("end_header") + 1:]
    has_rgb = any("red" in ln for ln in lines[:12])
    pts = {" ".join(ln.split()[:3]): tuple(int(v) for v in ln.split()[3:]) for ln in body}
    return set(pts), (pts if has_rgb else None)


def record_maps(pkg, argv, out_npz):
    """Run `pkg`'s dataset app on `argv` and keep its submaps (anchor,
    keyframes, frames, grids, colour sums) in `out_npz` when it exports
    map.ply."""
    sub = __import__(f"{pkg}.pipeline.submapping", fromlist=["SubmappingInterface"])
    export = sub.SubmappingInterface.export_occupied_ply

    def keep(self, path, *a, **kw):
        arr = {}
        for i, e in enumerate(self.maps):
            arr[f"T_WK{i}"] = np.asarray(e.sm.T_WK)
            arr[f"meta{i}"] = np.array([e.anchor_fid, e.n_frames, len(e.kf_ids)])
            arr[f"logodds{i}"] = np.asarray(e.sm.logodds)
            arr[f"weight{i}"] = np.asarray(e.sm.weight)
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


@pytest.fixture(scope="module")
def depth_runs(tmp_path_factory):
    """Both apps in `rgbd` and in `depth` mode, each on a dataset of its
    DEPTH_FRAMES frames with depth0/ (the generator's noise depends on the
    dataset's length) and a config whose cam0 is an rgb camera (the depth
    mode splats its colour): the two JAX apps in spawned processes on two
    cores each meanwhile the port's run here.  Returns {mode: (port output,
    JAX output, the port's depth integrations)}; each output holds the
    submaps in maps.npz (`record_maps`)."""
    from okvis2x_tpu_torch.pipeline.submapping import SubmappingInterface

    root = tmp_path_factory.mktemp("depth")
    modes = ("rgbd", "depth")
    ds = {m: str(root / f"ds_{m}") for m in modes}
    for m in modes:
        _, T_SC, _ = jsyn.generate(ds[m], duration=0.3 + DEPTH_FRAMES[m] / 10.0 - 0.05,
                                   frame_rate=10.0, width=320, height=240, with_depth=True)
    cfg = str(root / "okvis2.yaml")
    write_config(cfg, 320, 240, 280.0, [-0.25, 0.06, 1e-4, -1e-4], T_SC)
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("camera_type: gray", "camera_type: rgb", 1))
    outs = {(m, k): str(root / f"{m}_{k}") for m in modes for k in ("port", "jax")}
    for d in outs.values():
        os.makedirs(d)

    def args(m, k):
        return ["--dataset", ds[m], "--config", cfg, "--mode", m, "--reader", "xdataset",
                "--output", outs[m, k], "--max-frames", str(DEPTH_FRAMES[m])]

    cores = sorted(os.sched_getaffinity(0))
    env = jax_app_env(tmp_path_factory)
    refs = {}
    for i, m in enumerate(modes):
        pick = sorted(set(cores[-8:][2 * i:2 * i + 2]) or set(cores))
        npz = os.path.join(outs[m, "jax"], "maps.npz")
        run = (f"import os, sys; os.sched_setaffinity(0, {pick}); "
               f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r}); import test_torch_app as t; "
               f"t.record_maps('okvis2x_tpu', {args(m, 'jax')!r}, {npz!r})")
        log = open(os.path.join(outs[m, "jax"], "log.txt"), "w")
        refs[m] = (subprocess.Popen([sys.executable, "-c", run], cwd=REPO, env=env, stdout=log,
                                    stderr=subprocess.STDOUT), log)
    integrations = {}
    integrate = SubmappingInterface.integrate_depth
    try:
        for m in modes:
            n = [0]

            def counted(self, *a, n=n, **kw):
                n[0] += 1
                return integrate(self, *a, **kw)

            SubmappingInterface.integrate_depth = counted
            record_maps("okvis2x_tpu_torch", args(m, "port"),
                        os.path.join(outs[m, "port"], "maps.npz"))
            integrations[m] = n[0]
        rcs = {m: p.wait(timeout=1200) for m, (p, _) in refs.items()}
    finally:
        SubmappingInterface.integrate_depth = integrate
        for p, log in refs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for m in modes:
        with open(os.path.join(outs[m, "jax"], "log.txt")) as f:
            assert rcs[m] == 0, f.read()[-3000:]
    return {m: (outs[m, "port"], outs[m, "jax"], integrations[m]) for m in modes}


@pytest.mark.parametrize("mode", ["rgbd", "depth"])
def test_depth_modes_match_jax_app(depth_runs, mode):
    """`--mode rgbd` (sensor depth priors, learned stereo and multi-view depth
    fused on every keyframe) and `--mode depth` (learned stereo depth with
    cam0's colour): both trajectories within DEPTH_POS_TOL_M of the JAX app's;
    the same submaps with their grids and colours; the occupied voxels of
    map.ply the JAX app's within MAP_SET_TOL, with their colours in depth
    mode."""
    port, ref, n_integrated = depth_runs[mode]
    n_frames = DEPTH_FRAMES[mode]
    assert n_integrated >= (n_frames - 2 if mode == "rgbd" else n_frames)
    for name in ("trajectory.tum", "final_trajectory.tum"):
        a = np.loadtxt(os.path.join(port, name))
        b = np.loadtxt(os.path.join(ref, name))
        assert a.shape == b.shape and len(a) >= (n_frames if name[0] == "t" else 1)
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        assert float(np.abs(a[:, 1:4] - b[:, 1:4]).max()) < DEPTH_POS_TOL_M, name
    ma, mb = np.load(os.path.join(port, "maps.npz")), np.load(os.path.join(ref, "maps.npz"))
    assert int(ma["n"]) == int(mb["n"]) >= 1
    for i in range(int(ma["n"])):
        np.testing.assert_array_equal(ma[f"meta{i}"], mb[f"meta{i}"])
        np.testing.assert_allclose(ma[f"T_WK{i}"], mb[f"T_WK{i}"], rtol=0, atol=1e-6)
        same = ma[f"weight{i}"] == mb[f"weight{i}"]
        assert (~same).mean() <= GRID_FLIP_TOL and (mb[f"weight{i}"] > 0).sum() > 1000
        np.testing.assert_allclose(ma[f"logodds{i}"][same], mb[f"logodds{i}"][same], rtol=0,
                                   atol=1e-5)
        assert (f"col{i}" in ma) == (f"col{i}" in mb) == (mode == "depth")
        if mode == "depth":
            np.testing.assert_allclose(ma[f"col{i}"][:-1][same.reshape(-1)],
                                       mb[f"col{i}"][:-1][same.reshape(-1)], rtol=0, atol=1e-4)
    pa, ca = read_ply(os.path.join(port, "map.ply"))
    pb, cb = read_ply(os.path.join(ref, "map.ply"))
    assert len(pa ^ pb) <= MAP_SET_TOL * len(pb), (len(pa), len(pb), len(pa ^ pb))
    assert (ca is not None) == (cb is not None) == (mode == "depth" and len(pb) > 0)
    if ca is not None and pa & pb:
        assert max(max(abs(x - y) for x, y in zip(ca[p], cb[p])) for p in pa & pb) <= 1


def test_slam_synthetic_test_writes_both_trajectories(tmp_path):
    """`--synthetic-test --mode slam` on a few frames: the online and the
    final-BA trajectories."""
    out = str(tmp_path / "out")
    ate = okvis2x_app.main(["--synthetic-test", "--mode", "slam", "--output", out,
                            "--device", "cpu", "--max-frames", "3"])
    assert np.isfinite(ate)
    ts, Ts = trajectory_io.read_tum(os.path.join(out, "trajectory.tum"))
    assert len(ts) == 3 and np.isfinite(Ts).all()
    fts, fTs = trajectory_io.read_tum(os.path.join(out, "final_trajectory.tum"))
    assert 1 <= len(fts) <= 3 and np.isfinite(fTs).all()
    assert set(fts) <= set(ts)


def test_record_mode_round_trip(tmp_path):
    """--record: a dataset replayed through the fake driver into the
    writer, read back with every frame and image exact."""
    src = str(tmp_path / "src")
    synthetic.generate(src, duration=1.0, frame_rate=10.0, width=64, height=48)
    n_src = len(euroc.EurocDataset(src).frames)
    out = str(tmp_path / "rec")
    okvis2x_app.record_mode(types.SimpleNamespace(record=out, dataset=src, reader="euroc",
                                                  max_frames=0))
    a, b = euroc.EurocDataset(src), euroc.EurocDataset(out)
    assert len(b.frames) == n_src >= 3
    for fa, fb in zip(a.frames, b.frames):
        for pa, pb in zip(fa.paths, fb.paths):
            np.testing.assert_array_equal(png.read(pa), png.read(pb))
    assert sum(1 for k, _ in b.events() if k == "imu") > 50


def test_gps_event_raises(tmp_path):
    """A dataset with a GNSS stream: every fix reaches the estimator in
    order, none is dropped (and none raises, as the first fix did before
    GNSS was ported)."""
    from okvis2x_tpu_torch.graph.estimator import SlidingWindowEstimator

    ds = str(tmp_path / "ds")
    _, T_SC, _ = synthetic.generate(ds, duration=0.6, width=64, height=48, with_gps=True)
    cfg = str(tmp_path / "okvis2.yaml")
    write_config(cfg, 64, 48, 280.0, [-0.25, 0.06, 1e-4, -1e-4], T_SC)
    fixes = []
    add = SlidingWindowEstimator.add_gps_measurement
    SlidingWindowEstimator.add_gps_measurement = lambda est, *a: (fixes.append(a[0]),
                                                                  add(est, *a))
    try:
        okvis2x_app.main(["--dataset", ds, "--config", cfg, "--mode", "vio", "--output",
                          str(tmp_path / "out"), "--device", "cpu"])
    finally:
        SlidingWindowEstimator.add_gps_measurement = add
    reader = okvis2x_app.pick_reader("auto", ds, 2)
    assert fixes == [d[0] for k, d in reader.events() if k == "gps"]
    assert len(fixes) >= 2


class _Built(Exception):
    """Raised by a patched `VioPipeline.__init__` once it has the estimator
    config, so an app stops before it runs anything."""


def test_calibration_sigmas_reach_the_estimator(tmp_path):
    """The config's online calibration switches and its four sigmas reach
    `EstimatorConfig` as in the JAX app: both apps' configs are equal."""
    from okvis2x_tpu_torch import convert

    ds = str(tmp_path / "ds")
    _, T_SC, _ = synthetic.generate(ds, duration=0.5, width=64, height=48)
    cfg = str(tmp_path / "okvis2.yaml")
    write_config(cfg, 64, 48, 280.0, [-0.25, 0.06, 1e-4, -1e-4], T_SC, calibration="""\
    online_calibration:
        do_extrinsics: true
        do_extrinsics_final_ba: false
        sigma_r: 0.002
        sigma_alpha: 0.007
        sigma_r_final_ba: 0.0005
        sigma_alpha_final_ba: 0.003
""")
    argv = ["--dataset", ds, "--config", cfg, "--mode", "vio", "--output", str(tmp_path / "o")]
    got = {}
    for pkg in ("okvis2x_tpu", "okvis2x_tpu_torch"):
        cls = __import__(f"{pkg}.pipeline.vio", fromlist=["VioPipeline"]).VioPipeline
        init = cls.__init__

        def capture(self, cameras, T_SC, est_config, *a, pkg=pkg, **kw):
            got[pkg] = est_config
            raise _Built

        cls.__init__ = capture
        saved = sys.argv
        try:
            with pytest.raises(_Built):
                if pkg == "okvis2x_tpu":
                    sys.argv = ["okvis2x_app.py", *argv]
                    runpy.run_path(os.path.join(REPO, "apps", "okvis2x_app.py"),
                                   run_name="__main__")
                else:
                    okvis2x_app.main([*argv, "--device", "cpu"])
        finally:
            cls.__init__ = init
            sys.argv = saved
    port = got["okvis2x_tpu_torch"]
    assert port == convert.estimator_config(got["okvis2x_tpu"])
    assert (port.do_extrinsics, port.do_extrinsics_final_ba) == (True, False)
    assert (port.extrinsics_sigma_r, port.extrinsics_sigma_alpha,
            port.extrinsics_sigma_r_final_ba, port.extrinsics_sigma_alpha_final_ba) == (
        0.002, 0.007, 0.0005, 0.003)


def test_default_device_needs_cuda(tmp_path):
    """Without --device the app runs on cuda:0; where there is no CUDA
    device it raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (tests/test_torch_cuda.py runs the app there)")
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA"):
        okvis2x_app.main(["--synthetic-test", "--mode", "vio", "--output", out])
    assert not os.path.exists(out)
