"""The port's ROS2 layer (`okvis2x_tpu_torch/ros2/`) against the JAX
package's, over the in-process transport: the cases of
tests/test_ros2_layer.py up to the node graph on the port (the publisher's
estimator-update fan-out, the path rewritten on a loop closure, the CSV, the
rate-limited realtime propagation, the submap-mesh cache and z-cutoff, the
re-publisher, the subscriber's stereo synchronisation, and the node graph of
`okvis2x_tpu_torch/apps/okvis2x_node.py` end to end on the CPU); and both
packages' `Publisher`, `Subscriber` and `RePublisher` driven by one seeded
stream, every message on every topic equal (exactly, but for the
propagated odometry and the alignment points, host float64 math in other
orders: within FLOAT_TOL), the CSVs equal byte for byte."""

import dataclasses

import numpy as np
import torch

from okvis2x_tpu import api as japi
from okvis2x_tpu import ros2 as jros2
from okvis2x_tpu_torch import api as tapi
from okvis2x_tpu_torch import ros2 as tros2
from okvis2x_tpu_torch.api import State
from okvis2x_tpu_torch.io import euroc, synthetic
from okvis2x_tpu_torch.ros2 import LocalTransport, Publisher, RePublisher, Subscriber
from okvis2x_tpu_torch.ros2 import messages as m

torch.set_num_threads(1)

FLOAT_TOL = 1e-12
PKGS = {"jax": (japi, jros2), "port": (tapi, tros2)}


def _state(k, t):
    return State(
        id=k, timestamp=t,
        T_WS=np.array([float(k), 0, 0, 0, 0, 0, 1.0]),
        v_W=np.array([1.0, 0, 0]), b_g=np.zeros(3), b_a=np.zeros(3),
        omega_S=np.zeros(3), is_keyframe=True,
    )


def test_publisher_estimator_update():
    tr = LocalTransport()
    pub = Publisher(tr, prefix="okvis")
    lms = np.array([[1.0, 2, 3, 1.0], [2.0, 4, 6, 2.0]])  # homogeneous
    for k in range(3):
        pub.process_state_update(_state(k, 0.1 * k), landmarks=lms)

    odom = tr.last("okvis/odometry")
    assert isinstance(odom, m.Odometry) and odom.T_WB[0] == 2.0
    assert tr.count("okvis/odometry") == 3
    assert tr.count("okvis/transform") == 3
    path = tr.last("okvis/path")
    assert path.poses.shape == (3, 7)
    pc = tr.last("okvis/points_matched")
    np.testing.assert_allclose(pc.points[1], [1.0, 2.0, 3.0])  # dehomogenised


def test_publisher_path_rewritten_on_loop_closure():
    tr = LocalTransport()
    pub = Publisher(tr)
    pub.process_state_update(_state(0, 0.0))
    # loop closure moves state 0
    s0_new = _state(0, 0.0)
    s0_new.T_WS = np.array([9.0, 9, 9, 0, 0, 0, 1.0])
    pub.process_state_update(_state(1, 0.1), updated_states=[s0_new])
    path = tr.last("okvis/path")
    np.testing.assert_allclose(path.poses[0][:3], [9.0, 9, 9])


def test_publisher_csv(tmp_path):
    f = str(tmp_path / "traj.csv")
    tr = LocalTransport()
    pub = Publisher(tr)
    pub.set_csv_file(f)
    pub.process_state_update(_state(0, 1.5))
    pub.close()
    with open(f) as fh:
        lines = fh.read().strip().splitlines()
    assert lines[0].startswith("# timestamp")
    assert lines[1].startswith("1500000000, 0.0")


def test_odometry_published_inline():
    """Odometry and TF go out on the caller's thread: each state update has
    put its odometry, transform and path on the transport when it returns.
    The transform carries the odometry's pose and stamp, and every message
    names the configured world and body frames."""
    tr = LocalTransport()
    pub = Publisher(tr, world_frame="map", body_frame="imu")
    for k in range(20):
        pub.process_state_update(_state(k, 0.1 * k))
        assert tr.count("okvis/odometry") == tr.count("okvis/transform") == k + 1
        assert tr.count("okvis/path") == k + 1
        odom, tf = tr.last("okvis/odometry"), tr.last("okvis/transform")
        assert odom.T_WB[0] == float(k)
        np.testing.assert_array_equal(tf.T, odom.T_WB)
        assert tf.header.stamp == odom.header.stamp == 0.1 * k
        assert odom.header.frame_id == tf.header.frame_id == "map"
        assert odom.child_frame_id == tf.child_frame_id == "imu"
        assert tr.last("okvis/path").header.frame_id == "map"
    pub.close()


def test_realtime_propagation_rate_limit():
    tr = LocalTransport()
    pub = Publisher(tr, odometry_rate=20.0)
    pub.process_state_update(_state(0, 0.0))
    g = 9.81
    for k in range(1, 101):  # 100 Hz IMU for 1 s
        pub.add_imu_measurement(0.01 * k, np.zeros(3), np.array([0, 0, g]))
    n = tr.count("okvis/propagated_odometry")
    assert 15 <= n <= 25  # ~20 Hz from 100 Hz input
    prop = tr.last("okvis/propagated_odometry")
    # constant velocity 1 m/s under hover acceleration
    np.testing.assert_allclose(prop.T_WB[0], prop.header.stamp, atol=0.05)


def test_submap_meshes_cache_and_cutoff():
    tr = LocalTransport()
    pub = Publisher(tr, mesh_z_cutoff=0.5)
    verts = np.array([[0, 0, 0.0], [1, 0, 0.0], [0, 1, 0.0],
                      [0, 0, 2.0], [1, 0, 2.0], [0, 1, 2.0]])
    tris = np.array([[0, 1, 2], [3, 4, 5]])
    pub.publish_submaps({7: np.array([0, 0, 0, 0, 0, 0, 1.0])},
                        {7: (verts, tris)}, t=1.0)
    arr = tr.last("okvis/submap_meshes")
    assert len(arr.markers) == 1
    # the z=2 triangle is cut off
    assert arr.markers[0].triangles.shape == (1, 3)
    pub.republish_meshes()
    assert tr.count("okvis/submap_meshes") == 2


def test_republisher_passthrough():
    tr = LocalTransport()
    rp = RePublisher(tr, prefix="ns", num_cams=2)
    img = np.zeros((4, 6), np.uint8)
    rp.republish_images(0.5, [img, img])
    rp.republish_imu(0.5, np.ones(3), np.ones(3))
    rp.republish_network_depth(0.5, np.ones((4, 6), np.float32),
                               np.ones((4, 6), np.float32) * 0.1)
    assert tr.count("ns/cam0/image") == 1
    assert tr.count("ns/cam1/image") == 1
    assert tr.last("ns/imu").gyr[0] == 1.0
    assert tr.last("ns/depth").encoding == "32FC1"
    assert tr.last("ns/depth_sigma").data[0, 0] == np.float32(0.1)


class _FakeTarget:
    def __init__(self):
        self.frames = []
        self.imu = []
        self.gps = []

    def on_images(self, t, images, depth_images=None):
        self.frames.append((t, images, depth_images))

    def on_imu(self, t, gyr, acc):
        self.imu.append(t)

    def on_gps(self, t, pos, sigma):
        self.gps.append((t, tuple(pos)))


def test_subscriber_synchronises_stereo():
    tr = LocalTransport()
    tgt = _FakeTarget()
    Subscriber(tr, tgt, num_cams=2, prefix="ns", gps_topic="ns/gps")
    cam0 = tr.advertise("ns/cam0/image")
    cam1 = tr.advertise("ns/cam1/image")
    imu = tr.advertise("ns/imu")
    gps = tr.advertise("ns/gps")

    img = np.zeros((2, 2), np.uint8)
    imu.publish(m.Imu(m.Header(0.005), np.zeros(3), np.zeros(3)))
    cam0.publish(m.Image(m.Header(0.01), img))
    assert not tgt.frames  # waiting for cam1
    cam1.publish(m.Image(m.Header(0.0101), img))  # within tolerance
    assert len(tgt.frames) == 1 and abs(tgt.frames[0][0] - 0.01) < 1e-6
    assert tgt.imu == [0.005]
    gps.publish(m.NavSat(m.Header(0.02), np.array([1.0, 2, 3]), 0.5))
    assert tgt.gps == [(0.02, (1.0, 2.0, 3.0))]


def test_node_graph_end_to_end(tmp_path):
    """build_node_graph over LocalTransport on the CPU: publish raw sensor
    streams in, odometry/path out (the whole node minus rclpy)."""
    from okvis2x_tpu_torch.apps.okvis2x_node import build_node_graph
    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig

    out = str(tmp_path / "ds")
    cam, T_SC, gt = synthetic.generate(out, duration=1.2, frame_rate=10.0, width=160, height=120)
    ds = euroc.EurocDataset(out)

    tr = LocalTransport()
    est_cfg = EstimatorConfig(num_keyframes=3, num_imu_frames=2,
                              cap_frames=6, cap_landmarks=256, cap_obs=2048,
                              cap_imu_links=5, cap_imu_samples=64,
                              max_iterations=3)
    pipe_cfg = PipelineConfig(max_keypoints=128, octaves=1, harris_threshold=1e-6)
    core, pub, sub = build_node_graph(tr, [cam, cam], T_SC, est_cfg=est_cfg, pipe_cfg=pipe_cfg,
                                      odometry_rate=50.0, device="cpu")
    assert core.pipe.device == torch.device("cpu")
    cam0 = tr.advertise("cam0/image")
    cam1 = tr.advertise("cam1/image")
    imu = tr.advertise("imu")
    n = 0
    for kind, data in ds.events():
        if kind == "imu":
            t, gyr, acc = data
            imu.publish(m.Imu(m.Header(t), np.asarray(gyr), np.asarray(acc)))
        elif data.paths[0]:
            cam0.publish(m.Image(m.Header(data.t), ds.load_image(data.paths[0])))
            cam1.publish(m.Image(m.Header(data.t), ds.load_image(data.paths[1])))
            n += 1
    core.pipe.finish()
    assert n == len(ds.frames) > 5
    assert tr.count("okvis/odometry") == n
    assert tr.count("okvis/path") == n
    assert tr.count("okvis/propagated_odometry") > 5
    path = tr.last("okvis/path")
    assert path.poses.shape[0] == n
    np.testing.assert_array_equal(path.stamps, [t for t, _ in core.pipe.states_log])
    assert np.isfinite(path.poses).all()


# ---------------------------------------------------------------- against JAX


def assert_same_msg(a, b, tol=0.0):
    """Two messages of the two packages: the same type and fields, arrays
    equal (within `tol` where given)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            assert_same_msg(getattr(a, f.name), getattr(b, f.name), tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_msg(x, y, tol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if tol:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def assert_same_history(ja, ta, tols=()):
    """Both transports carried the same topics, the same messages on each."""
    assert sorted(ja.history) == sorted(ta.history)
    for topic, msgs in ja.history.items():
        assert len(msgs) == len(ta.history[topic]), topic
        for a, b in zip(msgs, ta.history[topic]):
            assert_same_msg(a, b, dict(tols).get(topic, 0.0))


def state_stream(rng, n=40):
    """(state fields, updated states' fields or None, landmarks or None,
    the IMU samples after it) of a seeded trajectory: poses on a noisy
    circle, a loop closure moving three earlier states at k = 25."""
    out = []
    for k in range(n):
        t = 0.05 * k
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        fields = dict(id=k, timestamp=t,
                      T_WS=np.concatenate([[np.cos(t), np.sin(t), 0.1 * t], q]),
                      v_W=rng.normal(size=3), b_g=1e-3 * rng.normal(size=3),
                      b_a=1e-2 * rng.normal(size=3), omega_S=rng.normal(size=3),
                      is_keyframe=bool(k % 3 == 0))
        upd = None
        if k == 25:
            upd = [dict(fields_k, T_WS=fields_k["T_WS"] + 0.1) for fields_k in
                   (o[0] for o in out[5:8])]
        lms = rng.normal(size=(int(rng.integers(0, 6)), 4)) if k % 4 else None
        imu = [(t + 0.005 * (j + 1), rng.normal(size=3), np.array([0, 0, 9.81]) +
                rng.normal(size=3)) for j in range(10)]
        out.append((fields, upd, lms, imu))
    return out


def test_publisher_matches_jax(tmp_path):
    """Both packages' publishers (odometry at 50 Hz) on one seeded stream of
    states, loop-closure updates, landmarks and IMU, then submap meshes,
    alignment points and debug images: every topic's messages equal, and
    the EuRoC and RPG CSVs byte for byte."""
    rng = np.random.default_rng(9)
    stream = state_stream(rng)
    verts = rng.normal(size=(30, 3))
    tris = rng.integers(0, 30, (20, 3))
    cols = rng.integers(0, 256, (30, 3)).astype(np.uint8)
    poses = {3: np.array([0.1, 0.2, 0.3, 0, 0, 0, 1.0]), 8: np.array([1.0, 0, 0, 0, 0, 0, 1.0])}
    pts = rng.normal(size=(25, 3))
    T = np.concatenate([rng.normal(size=3), [0.1, -0.2, 0.3, 0.9]])
    T[3:] /= np.linalg.norm(T[3:])
    imgs = {"tracks": rng.integers(0, 256, (6, 8)).astype(np.uint8),
            "matches": rng.integers(0, 256, (6, 8, 3)).astype(np.uint8)}
    trs, csvs = {}, {}
    for k, (api, ros2) in PKGS.items():
        tr = ros2.LocalTransport()
        pub = ros2.Publisher(tr, prefix="ok", odometry_rate=50.0, mesh_z_cutoff=0.5)
        rpg = ros2.Publisher(ros2.LocalTransport(), prefix="ok")
        csvs[k] = [str(tmp_path / f"{k}_euroc.csv"), str(tmp_path / f"{k}_rpg.csv")]
        pub.set_csv_file(csvs[k][0])
        rpg.set_csv_file(csvs[k][1], rpg=True)
        for fields, upd, lms, imu in stream:
            s = api.State(**fields)
            updated = [api.State(**u) for u in upd] if upd else None
            pub.process_state_update(s, updated_states=updated, landmarks=lms)
            rpg.process_state_update(s)
            for t, g, a in imu:
                pub.add_imu_measurement(t, g, a)
        pub.publish_submaps(poses, {3: (verts, tris, cols), 8: (verts + 1.0, tris)}, t=2.0)
        pub.republish_meshes()
        pub.publish_alignment_points(2.0, T, pts)
        pub.publish_images(imgs, t=2.0)
        pub.close()
        rpg.close()
        trs[k] = tr
    assert trs["port"].count("ok/propagated_odometry") > 20
    assert_same_history(trs["jax"], trs["port"], {"ok/propagated_odometry": FLOAT_TOL,
                                                  "ok/points_alignment": FLOAT_TOL})
    for a, b in zip(*csvs.values()):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()


def test_subscriber_and_republisher_match_jax():
    """Both packages' subscribers (three cameras, a depth and a GNSS topic
    under a prefix) on one seeded stream with missing, doubled and
    out-of-order images, and both re-publishers on what they forward: the
    same calls on the targets and the same republished messages."""
    rng = np.random.default_rng(4)
    events = []
    for k in range(60):
        t = 0.05 * k
        events.append(("imu", m.Imu(m.Header(t), rng.normal(size=3), rng.normal(size=3))))
        if k % 7 == 0:
            events.append(("gps", m.NavSat(m.Header(t), rng.normal(size=3), 0.3)))
        if k % 2 == 0:
            events.append(("depth", m.Image(m.Header(t), rng.random((3, 4)).astype(np.float32),
                                            "32FC1")))
        for c in range(3):
            if rng.random() < 0.1:
                continue
            img = rng.integers(0, 256, (3, 4)).astype(np.uint8)
            jitter = rng.uniform(-2e-3, 2e-3) if c else 0.0
            events.append((f"cam{c}", m.Image(m.Header(t + jitter), img)))
            if rng.random() < 0.1:
                events.append((f"cam{c}", m.Image(m.Header(t + 1e-3), img + 1)))
    for i in range(len(events) - 1):
        if rng.random() < 0.2:
            events[i], events[i + 1] = events[i + 1], events[i]

    class Target:
        def __init__(self, rp):
            self.calls = []
            self.rp = rp

        def on_images(self, t, images, depth_images=None):
            self.calls.append(("images", t, images, depth_images))
            self.rp.republish_images(t, images)
            if depth_images:
                self.rp.republish_network_depth(t, depth_images[0], depth_images[0] * 0.1)

        def on_imu(self, t, gyr, acc):
            self.calls.append(("imu", t, gyr, acc))
            self.rp.republish_imu(t, gyr, acc)

        def on_gps(self, t, pos, sigma):
            self.calls.append(("gps", t, pos, sigma))

    trs, tgts = {}, {}
    for k, (_, ros2) in PKGS.items():
        tr = ros2.LocalTransport()
        out = ros2.LocalTransport()
        tgts[k] = Target(ros2.RePublisher(out, prefix="re", num_cams=3))
        ros2.Subscriber(tr, tgts[k], num_cams=3, prefix="in", depth_topic="in/depth",
                        gps_topic="in/gps")
        topics = {name: tr.advertise(f"in/{name}/image" if name.startswith("cam")
                                     else f"in/{name}")
                  for name in ("cam0", "cam1", "cam2", "imu", "gps", "depth")}
        for name, msg in events:
            topics[name].publish(msg)
        trs[k] = out
    calls = [tgts[k].calls for k in PKGS]
    assert len(calls[0]) == len(calls[1])
    n_frames = sum(c[0] == "images" for c in calls[1])
    assert 30 <= n_frames < 60 and any(c[0] == "images" and c[3] for c in calls[1])
    for a, b in zip(*calls):
        assert_same_msg(list(a), list(b))
    assert_same_history(trs["jax"], trs["port"])
