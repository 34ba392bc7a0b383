"""The port's live nodes without ROS: the realsense publisher
(`okvis2x_tpu_torch/apps/okvis_node_realsense_publisher.py`, the case of
tests/test_ros2_layer.py::test_realsense_publisher_graph, against the JAX
package's `run_publisher` on the same fake device), `RclpyTransport`'s
conversions against the JAX package's, and the rclpy `main`s of
`okvis2x_node.py` and `okvis2x_network_node.py`.

rclpy and the ROS message packages are not installed: the tests put
stand-ins into `sys.modules` for their own duration (`monkeypatch`).  A
stand-in message makes its nested messages on first read and holds the
fields the conversions set; the stand-in node records its parameters,
subscriptions and publishers, and `rclpy.spin` delivers a few frames of a
dataset's IMU and mono8 image messages to its subscriptions, in the order of
the dataset's events, then returns.  Each node's published ROS messages must
equal, per topic and in order, the conversion of what the same node graph
(`build_node_graph`, `build_network_graph`) publishes over a `LocalTransport`
when it is fed the same samples directly, on the CPU.  Both runs construct
the mains' default configurations, which these tests make small (the
estimator and pipeline of tests/test_ros2_layer.py's network-node case,
`small_defaults`): at the defaults a frame's solve takes seconds on the CPU,
and chip_smoke.py drives the defaults at full size on the card."""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

from okvis2x_tpu.io import euroc as jeuroc
from okvis2x_tpu.io.realsense import FakeRealsense as JFakeRealsense
from okvis2x_tpu.ros2 import messages as jm
from okvis2x_tpu.ros2.transport import LocalTransport as JLocalTransport
from okvis2x_tpu.ros2.transport import RclpyTransport as JRclpyTransport
from okvis2x_tpu_torch.apps import okvis2x_network_node, okvis2x_node
from okvis2x_tpu_torch.apps import okvis_node_realsense_publisher as rs_node
from okvis2x_tpu_torch.graph import estimator
from okvis2x_tpu_torch.pipeline import vio
from okvis2x_tpu_torch.io import euroc, synthetic
from okvis2x_tpu_torch.io.realsense import FakeRealsense
from okvis2x_tpu_torch.ros2 import messages as m
from okvis2x_tpu_torch.ros2.transport import LocalTransport, RclpyTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

NODE_FRAMES = 2  # frames delivered to each live node
SMALL_EST = dict(num_keyframes=3, num_imu_frames=2, cap_frames=6, cap_landmarks=128,
                 cap_obs=1024, cap_imu_links=5, cap_imu_samples=64, max_iterations=2)
SMALL_PIPE = dict(max_keypoints=64, octaves=1, harris_threshold=1e-6)


# ------------------------------------------------------------ the realsense node
@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    """tests/test_ros2_layer.py's realsense dataset: 0.6 s at 10 Hz, 64x48."""
    out = str(tmp_path_factory.mktemp("live") / "ds")
    synthetic.generate(out, duration=0.6, frame_rate=10.0, width=64, height=48)
    return out


def published(driver, tr, run_publisher):
    run_publisher(tr, driver, prefix="rs")
    driver.start_streaming()
    driver.wait_done(timeout=60.0)
    driver.stop_streaming()
    assert not driver._thread.is_alive()
    return tr


def test_realsense_publisher_graph(small_ds):
    """tests/test_ros2_layer.py's case on the port, and the JAX package's
    `run_publisher` on the same dataset: the same messages on the same
    topics."""
    sys.path.insert(0, os.path.join(REPO, "apps"))
    try:
        from okvis_node_realsense_publisher import run_publisher as jrun
    finally:
        sys.path.pop(0)
    tr = published(FakeRealsense(euroc.EurocDataset(small_ds)), LocalTransport(),
                   rs_node.run_publisher)
    assert tr.count("rs/imu") > 10
    assert tr.count("rs/cam0/image") >= 3
    assert tr.count("rs/cam1/image") == tr.count("rs/cam0/image")
    jtr = published(JFakeRealsense(jeuroc.EurocDataset(small_ds)), JLocalTransport(), jrun)
    assert sorted(tr.history) == sorted(jtr.history)
    for topic, msgs in tr.history.items():
        assert len(msgs) == len(jtr.history[topic])
        for a, b in zip(msgs, jtr.history[topic]):
            assert (a.header.stamp, a.header.frame_id) == (b.header.stamp, b.header.frame_id)
            for f in ("data", "gyr", "acc"):
                if hasattr(a, f):
                    np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_realsense_main_without_rclpy(small_ds, capsys):
    """Without rclpy the node replays the fake dataset over the local
    transport and reports what it published; the live driver needs
    pyrealsense2."""
    assert rs_node.main(["--fake-dataset", small_ds, "--prefix", "rs"]) == 0
    out = capsys.readouterr().out
    ds = euroc.EurocDataset(small_ds)
    total = len(ds.imu.t) + 2 * len(ds.frames)
    assert f"published {total} messages on 3 topics (local transport)" in out
    with pytest.raises(ImportError):
        rs_node.main([])


# ------------------------------------------------------------- ROS stand-ins
class Msg:
    """A ROS message stand-in: keyword construction, the fields in `_lists`
    start as lists, any other field read before it is set is a nested
    message."""

    _lists = ()

    def __init__(self, **kw):
        for f in self._lists:
            setattr(self, f, [])
        for k, v in kw.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        sub = Msg()
        setattr(self, name, sub)
        return sub


def as_tree(x):
    """A message as nested dicts (with its type's name) and lists."""
    if isinstance(x, Msg):
        return {"@": type(x).__name__, **{k: as_tree(v) for k, v in sorted(vars(x).items())}}
    if isinstance(x, (list, tuple)):
        return [as_tree(v) for v in x]
    return x


def message_modules():
    """{module name: module} of the ROS message packages the conversions and
    the nodes import."""
    def msg_type(name, lists=(), **consts):
        return type(name, (Msg,), dict(_lists=lists, **consts))

    spec = {
        "builtin_interfaces.msg": [msg_type("Time")],
        "geometry_msgs.msg": [msg_type("TransformStamped"), msg_type("PoseStamped"),
                              msg_type("Point")],
        "nav_msgs.msg": [msg_type("Odometry"), msg_type("Path", ("poses",))],
        "sensor_msgs.msg": [msg_type("Image"), msg_type("Imu"), msg_type("PointCloud2"),
                            msg_type("PointField", FLOAT32=7)],
        "std_msgs.msg": [msg_type("ColorRGBA")],
        "visualization_msgs.msg": [msg_type("Marker", ("points", "colors"), TRIANGLE_LIST=11,
                                            ADD=0, DELETE=2),
                                   msg_type("MarkerArray", ("markers",))],
    }
    mods = {}
    for name, classes in spec.items():
        pkg = types.ModuleType(name.split(".")[0])
        mod = types.ModuleType(name)
        for cls in classes:
            setattr(mod, cls.__name__, cls)
        pkg.msg = mod
        mods[pkg.__name__], mods[name] = pkg, mod
    return mods


@pytest.fixture
def ros(monkeypatch):
    """The stand-in ROS message packages in sys.modules."""
    mods = message_modules()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return mods


class Publisher:
    def __init__(self, msg_type, topic):
        self.msg_type, self.topic, self.sent = msg_type, topic, []

    def publish(self, msg):
        assert isinstance(msg, self.msg_type)
        self.sent.append(msg)


class Node:
    """The stand-in `rclpy.node.Node`."""

    params = {}  # the parameters the test sets, by name
    created = []  # every node made, in order

    def __init__(self, name):
        self.name, self._params, self.subs, self.pubs = name, {}, {}, {}
        self.created.append(self)

    def declare_parameter(self, name, default):
        self._params[name] = self.params.get(name, default)

    def get_parameter(self, name):
        return types.SimpleNamespace(value=self._params[name])

    def create_subscription(self, msg_type, topic, callback, qos):
        self.subs[topic] = (msg_type, callback)

    def create_publisher(self, msg_type, topic, qos):
        assert topic not in self.pubs
        self.pubs[topic] = Publisher(msg_type, topic)
        return self.pubs[topic]


def stand_in_rclpy(monkeypatch, params, inbox):
    """`rclpy` and `rclpy.node` stand-ins: `spin` delivers `inbox` (topic,
    message) to the node's subscriptions, in order, and returns."""
    rclpy = types.ModuleType("rclpy")
    node_mod = types.ModuleType("rclpy.node")
    node_cls = type("Node", (Node,), dict(params=params, created=[]))
    node_mod.Node = node_cls
    rclpy.node = node_mod
    rclpy.init = lambda: None

    def spin(node):
        for topic, msg in inbox:
            msg_type, callback = node.subs[topic]
            assert isinstance(msg, msg_type)
            callback(msg)

    rclpy.spin = spin
    monkeypatch.setitem(sys.modules, "rclpy", rclpy)
    monkeypatch.setitem(sys.modules, "rclpy.node", node_mod)
    return node_cls


# ------------------------------------------------------------ the conversions
def samples(pkg, rng):
    """One numpy message of each family the conversions cover, in `pkg`'s
    message types."""
    q = rng.normal(size=4)
    T = np.r_[rng.normal(size=3), q / np.linalg.norm(q)]
    verts = rng.normal(size=(5, 3))
    tris = np.array([[0, 1, 2], [2, 3, 4]])
    cols = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    h = pkg.Header(12.345678912, "world")
    marker = pkg.MeshMarker(h, "submaps", 3, T, verts, tris, colors=cols)
    return [
        pkg.Odometry(h, "body", T, rng.normal(size=3), rng.normal(size=3)),
        pkg.TransformStamped(h, "body", T),
        pkg.Path(h, np.array([1.5, 2.25]), np.stack([T, T[::-1]])),
        pkg.PointCloud(h, rng.normal(size=(6, 3))),
        pkg.Image(h, rng.integers(0, 256, (4, 5)).astype(np.uint8)),
        pkg.Image(h, rng.normal(size=(4, 5)).astype(np.float32), encoding="32FC1"),
        pkg.Imu(h, rng.normal(size=3), rng.normal(size=3)),
        marker,
        pkg.MeshMarker(h, "submaps", 4, T, verts, tris, action="delete"),
        pkg.MarkerArray([marker, pkg.MeshMarker(h, "submaps", 5, T, verts, tris)]),
    ]


def test_rclpy_conversions_match_jax(ros):
    """Each message family through both packages' `_to_ros`: the same ROS
    type and the same fields; an unknown type raises."""
    convs = {"jax": JRclpyTransport(node=None), "port": RclpyTransport(node=None)}
    got = {k: [conv._to_ros(msg) for msg in samples(pkg, np.random.default_rng(0))]
           for (k, conv), pkg in zip(convs.items(), (jm, m))}
    for (a, ta), (b, tb) in zip(got["port"], got["jax"]):
        assert ta is tb and type(a) is ta
        assert as_tree(a) == as_tree(b)
    marker = got["port"][7][0]
    assert len(marker.points) == 6 and len(marker.colors) == 6 and marker.type == 11
    assert got["port"][8][0].action == 2
    with pytest.raises(TypeError):
        convs["port"]._to_ros(m.NavSat(m.Header(0.0), np.zeros(3)))


def test_rclpy_transport_publishes_and_dispatches(ros):
    """`_dispatch` makes one ROS publisher a topic, publishes the converted
    message and hands the numpy message to local subscribers."""
    node = Node("n")
    tr = RclpyTransport(node)
    seen = []
    tr.subscribe("imu", seen.append)
    msgs = [m.Imu(m.Header(0.1 * k), np.ones(3) * k, np.zeros(3)) for k in range(3)]
    for msg in msgs:
        tr.advertise("imu").publish(msg)
    assert seen == msgs and list(node.pubs) == ["imu"]
    sent = node.pubs["imu"].sent
    assert [s.angular_velocity.x for s in sent] == [0.0, 1.0, 2.0]
    assert [(s.header.stamp.sec, s.header.stamp.nanosec) for s in sent] == [
        (0, 0), (0, 100000000), (0, 200000000)]


# ------------------------------------------------------------- the live mains
@pytest.fixture(scope="module")
def live_inputs(tmp_path_factory):
    """A 96x64 dataset, its okvis2.yaml, the rig, and its first NODE_FRAMES
    frames' events as numpy samples (the stamps as the stand-in ROS messages
    carry them)."""
    root = tmp_path_factory.mktemp("nodes")
    ds_dir = str(root / "ds")
    cam, T_SC, _ = synthetic.generate(ds_dir, duration=0.6, frame_rate=10.0, width=96,
                                      height=64)
    fx, fy, cx, cy = (float(v) for v in cam.fxfycxcy)
    cfg = str(root / "okvis2.yaml")
    chip_smoke.app_config(cfg, types.SimpleNamespace(
        camera=dict(width=96, height=64, fx=fx, fy=fy, cx=cx, cy=cy,
                    dist_params=[float(v) for v in cam.dist_params]), T_SC=T_SC))
    ds = euroc.EurocDataset(ds_dir)
    events, n = [], 0
    for kind, ev in ds.events():
        if kind == "imu":
            t, gyr, acc = ev
            events.append(("imu", stamp_of(t), (np.asarray(gyr), np.asarray(acc))))
        elif ev.paths[0]:
            for c in range(2):
                events.append((f"cam{c}", stamp_of(ev.t), ds.load_image(ev.paths[c])))
            n += 1
            if n == NODE_FRAMES:
                break
    return cfg, events


def stamp_of(t):
    """(sec, nanosec) of a time, as `RclpyTransport._stamp` writes it."""
    return int(t), int((t - int(t)) * 1e9)


def ros_inbox(events, ros):
    """The events as stand-in ROS messages on the live node's topics."""
    sensor = ros["sensor_msgs.msg"]
    inbox = []
    for kind, (sec, ns), data in events:
        if kind == "imu":
            msg = sensor.Imu()
            (msg.angular_velocity.x, msg.angular_velocity.y,
             msg.angular_velocity.z) = map(float, data[0])
            (msg.linear_acceleration.x, msg.linear_acceleration.y,
             msg.linear_acceleration.z) = map(float, data[1])
            topic = "imu0"
        else:
            img = np.round(data * 255.0).astype(np.uint8)
            msg = sensor.Image(height=img.shape[0], width=img.shape[1], encoding="mono8",
                               data=img.tobytes())
            topic = f"{kind}/image_raw"
        msg.header.stamp.sec, msg.header.stamp.nanosec = sec, ns
        inbox.append((topic, msg))
    return inbox


def feed_local(tr, events):
    """The same samples straight onto a LocalTransport's input topics."""
    for kind, (sec, ns), data in events:
        t = sec + ns * 1e-9
        if kind == "imu":
            tr._dispatch("imu", m.Imu(m.Header(t, "imu"), *data))
        else:
            tr._dispatch(f"{kind}/image", m.Image(m.Header(t, kind), data))


@pytest.fixture
def small_defaults(monkeypatch):
    """`EstimatorConfig()` and `PipelineConfig()` as the node cores construct
    them, made small for the test's duration."""
    monkeypatch.setattr(estimator, "EstimatorConfig",
                        functools.partial(estimator.EstimatorConfig, **SMALL_EST))
    monkeypatch.setattr(vio, "PipelineConfig",
                        functools.partial(vio.PipelineConfig, **SMALL_PIPE))


@pytest.mark.parametrize("which", ["node", "network"])
def test_live_main_matches_local_graph(which, live_inputs, ros, small_defaults, monkeypatch):
    """The node's `main` under stand-in rclpy with `config` and `device`
    cpu: every message it publishes equals the conversion of what its graph
    publishes over a LocalTransport on the same samples; the pipeline is
    finished when `spin` returns."""
    cfg, events = live_inputs
    params = dict(config=cfg, device="cpu")
    if which == "node":
        params["odometry_rate"] = 50.0
    node_cls = stand_in_rclpy(monkeypatch, params, ros_inbox(events, ros))
    mod = okvis2x_node if which == "node" else okvis2x_network_node
    assert mod.main() == 0
    node, = node_cls.created
    assert sorted(node.subs) == ["cam0/image_raw", "cam1/image_raw", "imu0"]

    cameras, T_SC = okvis2x_node.load_rig(cfg)
    tr = LocalTransport()
    if which == "node":
        core, _, _ = okvis2x_node.build_node_graph(tr, cameras, T_SC, odometry_rate=50.0,
                                                   num_cams=2, device="cpu")
    else:
        core, _, _, _ = okvis2x_network_node.build_network_graph(tr, cameras, T_SC,
                                                                 num_cams=2, device="cpu")
    feed_local(tr, events)
    core.pipe.finish()
    live = node.core.pipe if which == "node" else node.graph[0].pipe
    assert live._lc_thread is None and live.device == torch.device("cpu")
    want = tr.history  # the inputs too: the transport publishes what it dispatches
    assert sorted(node.pubs) == sorted(want)
    conv = RclpyTransport(node=None)
    for topic, history in want.items():
        sent = node.pubs[topic].sent
        assert len(sent) == len(history), topic
        for a, b in zip(sent, history):
            assert as_tree(a) == as_tree(conv._to_ros(b)[0]), topic
    n = sum(kind == "cam0" for kind, _, _ in events)
    assert len(node.pubs["okvis/odometry"].sent) == n
    if which == "network":
        assert len(node.pubs["okvis/network/depth"].sent) == n
    else:
        assert len(node.pubs["okvis/propagated_odometry"].sent) > 0


@pytest.mark.parametrize("mod", [okvis2x_node, okvis2x_network_node],
                         ids=["node", "network"])
def test_live_main_without_rclpy(mod, monkeypatch, capsys):
    """Without rclpy each node's `main` prints the JAX node's message and
    returns 1."""
    monkeypatch.setitem(sys.modules, "rclpy", None)
    assert mod.main() == 1
    assert "rclpy not available" in capsys.readouterr().err
