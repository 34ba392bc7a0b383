"""The port's queues (`okvis2x_tpu_torch/pipeline/queues.py`) against the JAX
package's: the cases of tests/test_orchestration.py on the port (the queue's
push and pop variants and shutdown, the frame synchroniser's missing,
doubled and out-of-order frames, the threaded runner, the latest-value
publisher); one seeded stream of camera events with missing, doubled and
out-of-order frames through both packages' `FrameSynchronizer`, and one
seeded sequence of queue operations through both `Queue`s, with equal
results; both packages' `ThreadedRunner` on one dataset, delivering equal
events.

Every test that starts a thread runs under `within`: a hang fails that test
after a few seconds instead of stopping the suite."""

import shutil
import threading
import time

import numpy as np
import pytest

from okvis2x_tpu.io import euroc as jeuroc
from okvis2x_tpu.pipeline import queues as jq
from okvis2x_tpu_torch.io import euroc, synthetic
from okvis2x_tpu_torch.pipeline import queues as tq
from okvis2x_tpu_torch.pipeline.queues import (FrameSynchronizer, LatestValuePublisher, Queue,
                                               ShutDown, ThreadedRunner)

LIMIT_S = 30.0  # each threaded test's own limit


def within(fn, *args, limit_s=LIMIT_S):
    """fn(*args) on a thread of its own; fails when it has not returned
    within `limit_s`, raises what it raised, else returns its value."""
    box = {}

    def target():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # handed to the test's thread below
            box["error"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(limit_s)
    assert not th.is_alive(), f"{fn.__name__} did not return within {limit_s} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def test_queue_drop_if_full():
    q = Queue(maxsize=2)
    assert q.push_nonblocking_dropping_if_full(1)
    assert q.push_nonblocking_dropping_if_full(2)
    assert not q.push_nonblocking_dropping_if_full(3)  # drops 1
    assert q.pop_blocking() == 2
    assert q.pop_blocking() == 3


def test_queue_blocking_and_shutdown():
    def case():
        q = Queue(maxsize=1)
        got = []

        def consumer():
            try:
                while True:
                    got.append(q.pop_blocking())
            except ShutDown:
                pass

        th = threading.Thread(target=consumer, daemon=True)
        th.start()
        q.push_blocking_if_full("a")
        q.push_blocking_if_full("b")
        time.sleep(0.1)
        q.shutdown()
        th.join(2.0)
        assert not th.is_alive()
        assert got == ["a", "b"]

    within(case)


def test_queue_pop_timeout():
    def case():
        q = Queue()
        t0 = time.monotonic()
        assert q.pop_timeout(0.15) is None
        assert time.monotonic() - t0 >= 0.14

    within(case)


def test_queue_shutdown_wakes_blocked_push():
    """A producer blocked on a full queue leaves with `ShutDown`."""
    def case():
        q = Queue(maxsize=1)
        q.push_nonblocking("a")
        out = []

        def producer():
            try:
                q.push_blocking_if_full("b")
            except ShutDown:
                out.append("shut")

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        time.sleep(0.05)
        q.shutdown()
        th.join(2.0)
        assert not th.is_alive() and out == ["shut"]

    within(case)


def test_queue_pop_wakes_blocked_push():
    """A push blocked on a full queue returns as soon as a pop makes room,
    not at the end of its 0.1 s wait (after which it would find room all
    the same: half of that wait on average)."""
    def case():
        lat = []
        for _ in range(10):
            q = Queue(maxsize=1)
            q.push_nonblocking("a")
            done = []

            def producer():
                q.push_blocking_if_full("b")
                done.append(time.monotonic())

            th = threading.Thread(target=producer, daemon=True)
            th.start()
            time.sleep(0.03)
            t0 = time.monotonic()
            assert q.pop_blocking() == "a"
            th.join(2.0)
            assert not th.is_alive() and q.pop_nonblocking() == "b"
            lat.append(done[0] - t0)
        assert np.median(lat) < 0.02, lat

    within(case)


def test_queue_operations_match_jax():
    """One seeded sequence of the non-blocking pushes and pops through both
    packages' queues: the same return values and lengths at every step."""
    rng = np.random.default_rng(11)
    qs = [jq.Queue(maxsize=3), tq.Queue(maxsize=3)]
    for i in range(400):
        op = int(rng.integers(4))
        out = []
        for q in qs:
            if op == 0:
                out.append(q.push_nonblocking(i))
            elif op == 1:
                out.append(q.push_nonblocking_dropping_if_full(i))
            elif op == 2:
                out.append(q.pop_nonblocking())
            else:
                out.append(q.pop_timeout(0.0))
            out.append(len(q))
        assert out[:2] == out[2:], (i, op, out)


def test_frame_synchronizer_in_order():
    fs = FrameSynchronizer(2, tolerance=0.005)
    assert fs.add(0, 0.0, "a0") == []
    out = fs.add(1, 0.002, "a1")
    assert len(out) == 1
    assert set(out[0]["images"]) == {0, 1}


def test_frame_synchronizer_missing_and_out_of_order():
    fs = FrameSynchronizer(2, tolerance=0.005)
    fs.add(0, 0.0, "a0")  # cam1 never arrives for t=0
    fs.add(1, 0.1, "b1")  # next bundle, out of order: cam1 first
    out = fs.add(0, 0.101, "b0")
    # the complete t=0.1 bundle emits, and the stale t=0 bundle flushes
    ts = [b["t"] for b in out]
    assert any(abs(t - 0.1) < 0.01 for t in ts)
    assert any(abs(t - 0.0) < 0.01 and len(b["images"]) == 1 for t, b in zip(ts, out))


def test_frame_synchronizer_double_frame():
    fs = FrameSynchronizer(2, tolerance=0.005)
    fs.add(0, 0.0, "first")
    fs.add(0, 0.001, "dup")  # same bundle, replaces cam0
    out = fs.add(1, 0.002, "c1")
    assert len(out) == 1
    assert out[0]["images"][0] == "dup"


def camera_events(rng, num_cams, n_frames):
    """(cam, t, image id) at 20 Hz with 2 ms jitter, each camera's image
    missing with probability 0.1 and doubled with 0.1, and neighbouring
    events swapped with probability 0.2."""
    ev = []
    for k in range(n_frames):
        for c in range(num_cams):
            if rng.random() < 0.1:
                continue
            t = 0.05 * k + float(rng.uniform(-0.002, 0.002))
            ev.append((c, t, f"{k}.{c}"))
            if rng.random() < 0.1:
                ev.append((c, t + float(rng.uniform(-0.001, 0.001)), f"{k}.{c}'"))
    for i in range(len(ev) - 1):
        if rng.random() < 0.2:
            ev[i], ev[i + 1] = ev[i + 1], ev[i]
    return ev


def test_frame_synchronizer_matches_jax():
    """A seeded stream with missing, doubled and out-of-order frames from two
    and from three cameras: both packages emit the same bundles (times,
    cameras and images) after every event."""
    rng = np.random.default_rng(5)
    n_complete = n_flushed = 0
    for num_cams in (2, 3):
        a, b = jq.FrameSynchronizer(num_cams), tq.FrameSynchronizer(num_cams)
        for cam, t, img in camera_events(rng, num_cams, 200):
            ra, rb = a.add(cam, t, img), b.add(cam, t, img)
            assert [(x["t"], x["images"]) for x in ra] == [(x["t"], x["images"]) for x in rb]
            n_complete += sum(len(x["images"]) == num_cams for x in rb)
            n_flushed += sum(len(x["images"]) < num_cams for x in rb)
    assert n_complete > 100 and n_flushed > 10  # both kinds of bundle occurred


class FakePipe:
    """Records what a runner hands the pipeline."""

    def __init__(self):
        self.calls = []

    def add_imu_measurement(self, t, g, a):
        self.calls.append(("imu", t, np.asarray(g), np.asarray(a)))

    def process_frame(self, t, images):
        self.calls.append(("frames", t, images))
        return dict(t=t)


@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    """tests/test_orchestration.py's dataset: 0.8 s at 10 Hz, 48x36."""
    out = str(tmp_path_factory.mktemp("queues") / "ds")
    synthetic.generate(out, duration=0.8, frame_rate=10.0, width=48, height=36, n_points=40)
    return out


def test_threaded_runner_with_fake_pipeline(small_ds):
    out = small_ds
    pipe = FakePipe()
    runner = ThreadedRunner(euroc.EurocDataset(out), pipe, queue_size=4)
    results = within(runner.run)
    frames = [c for c in pipe.calls if c[0] == "frames"]
    assert len(frames) >= 4 and all(c[2][0].ndim == 2 for c in frames)
    assert sum(c[0] == "imu" for c in pipe.calls) > 50
    assert len(results) == len(frames)


def test_threaded_runner_stops_at_max_frames(small_ds):
    """`max_frames` ends the run; the reader thread, blocked on the full
    queue, ends with it."""
    out = small_ds
    runner = ThreadedRunner(euroc.EurocDataset(out), FakePipe(), queue_size=2)
    assert len(within(runner.run, 2)) == 2
    runner._producer.join(5.0)
    assert not runner._producer.is_alive()


def test_threaded_runner_matches_jax(small_ds):
    """Both packages' runners on one dataset, each through its package's
    reader: the same IMU samples and frames in the same order, the images
    equal."""
    out = small_ds
    pipes = [FakePipe(), FakePipe()]
    # a queue that never fills: the JAX package's pops wake no waiting push
    within(jq.ThreadedRunner(jeuroc.EurocDataset(out), pipes[0], queue_size=256).run)
    within(tq.ThreadedRunner(euroc.EurocDataset(out), pipes[1], queue_size=4).run)
    assert [c[:2] for c in pipes[0].calls] == [c[:2] for c in pipes[1].calls]
    for a, b in zip(*(p.calls for p in pipes)):
        for x, y in zip(a[2:], b[2:]):
            if isinstance(x, list):
                assert len(x) == len(y)
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_array_equal(x, y)


def test_threaded_runner_raises_reader_error(small_ds, tmp_path):
    """An image the reader thread cannot decode is raised on the consumer's
    thread instead of leaving it waiting."""
    out = str(tmp_path / "ds")
    shutil.copytree(small_ds, out)
    ds = euroc.EurocDataset(out)
    with open(ds.frames[2].paths[0], "wb") as f:
        f.write(b"not an image")
    runner = ThreadedRunner(ds, FakePipe(), queue_size=2)
    try:
        within(runner.run)
    except ValueError:
        pass
    else:
        raise AssertionError("the reader's error did not reach the consumer")


def test_latest_value_publisher():
    """≙ okvis::ThreadedPublisher: slow consumers see only the freshest
    value; all published values are coalesced, none block the producer."""
    def case():
        seen = []
        gate = threading.Event()

        def slow_cb(v):
            gate.wait(5.0)  # consumer blocked until we open the gate
            seen.append(v)

        pub = LatestValuePublisher(slow_cb)
        for i in range(50):
            pub.publish(i)  # never blocks
        gate.set()
        pub.shutdown(wait=True)
        assert seen, "nothing delivered"
        assert seen[-1] == 49  # freshest value wins
        assert len(seen) < 50  # intermediate values coalesced
        assert pub.n_published == 50
        assert not pub._thread.is_alive()

    within(case)
