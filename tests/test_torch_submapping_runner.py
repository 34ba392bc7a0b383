"""The port's asynchronous submapping runner
(`okvis2x_tpu_torch/pipeline/submapping_runner.py`) against the JAX
package's: the two asynchronous cases of tests/test_submapping.py (a
measurement held back until the trajectory covers it; a submap re-anchored
on a loop-closure correction), each run through both packages' runners on
the same inputs, the port on the CPU.

The runner reads the newest keyframe when it assembles a measurement, so
which keyframe anchors it depends on the threads' timing; both runs are fed
in the same steps, each next step only once the runner has integrated what
the last one made available (`wait_integrated`), so that both anchor every
measurement to the same keyframe.  `finish()` gives up on its joins after
5 s, and a measurement that the assembly thread holds while `finish()` finds
both queues empty is never integrated (ROADMAP.md C-R17, in both packages):
the tests wait for every integration before `finish()` and join both
threads themselves, each under LIMIT_S, before they assert anything.

Tolerances: the grids' integration counts exactly, log-odds within 1e-6
(float32 sums of the same updates in another order), anchors exactly."""

import time

import jax.numpy as jnp
import numpy as np
import torch

from okvis2x_tpu import api as japi
from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.mapping import submap as jsm
from okvis2x_tpu.pipeline import submapping as jsub
from okvis2x_tpu.pipeline.submapping_runner import AsyncSubmapping as JAsync
from okvis2x_tpu_torch import api as tapi
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.mapping import submap as tsm
from okvis2x_tpu_torch.pipeline import submapping as tsub
from okvis2x_tpu_torch.pipeline.submapping_runner import AsyncSubmapping

torch.set_num_threads(1)

LIMIT_S = 30.0  # each wait and each join of a test's own
LOGODDS_TOL = 1e-6


def configs():
    """tests/test_submapping.py's CFG in both packages."""
    kw = dict(min_frames_integrated=2, align_points=128)
    return (jsub.SubmappingConfig(submap=jsm.SubmapConfig(dim=64, res=0.2), **kw),
            tsub.SubmappingConfig(submap=tsm.SubmapConfig(dim=64, res=0.2), **kw))


def cameras():
    """tests/test_submapping.py's `make_cam` in both packages."""
    jcam = jpin.make_pinhole(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96,
                             model="none", dtype=jnp.float64)
    return jcam, convert.camera(jcam)


def wall_depth(z=3.0):
    return np.full((96, 128), z, np.float32)


def state(pkg, fid, t, x, kf=True):
    return pkg.State(id=fid, timestamp=t, T_WS=np.array([x, 0, 0, 0, 0, 0, 1.0]),
                     v_W=np.zeros(3), b_g=np.zeros(3), b_a=np.zeros(3),
                     omega_S=np.zeros(3), is_keyframe=kf)


def runners():
    """(JAX runner, port runner) over fresh interfaces, the port's on the CPU."""
    jcfg, tcfg = configs()
    jcam, tcam = cameras()
    return (JAsync(jsub.SubmappingInterface(jcfg), cam=jcam),
            AsyncSubmapping(tsub.SubmappingInterface(tcfg, device="cpu"), cam=tcam))


def wait_integrated(runner, n):
    t0 = time.monotonic()
    while runner.n_integrated < n and time.monotonic() - t0 < LIMIT_S:
        time.sleep(0.005)
    assert runner.n_integrated == n, (runner.n_integrated, n, runner.n_dropped)


def finish_and_join(runner):
    runner.finish()
    for th in (runner._t_assembly, runner._t_integrate):
        th.join(LIMIT_S)
        assert not th.is_alive(), f"{th.name} did not stop within {LIMIT_S} s"


def assert_same_maps(jsi, tsi):
    assert len(tsi.maps) == len(jsi.maps)
    for j, t in zip(jsi.maps, tsi.maps):
        assert (t.anchor_fid, t.n_frames, t.kf_ids) == (j.anchor_fid, j.n_frames, j.kf_ids)
        np.testing.assert_array_equal(np.asarray(t.sm.T_WK), np.asarray(j.sm.T_WK))
        np.testing.assert_array_equal(t.sm.weight.numpy(), np.asarray(j.sm.weight))
        np.testing.assert_allclose(t.sm.logodds.numpy(), np.asarray(j.sm.logodds),
                                   rtol=0, atol=LOGODDS_TOL)


def test_async_submapping_waits_for_states():
    """Measurements queued before their bracketing states arrive are held
    back, posed once the trajectory covers them and integrated on the worker
    thread, into the same grid as the JAX runner's."""
    pair = runners()
    for r, pkg in zip(pair, (japi, tapi)):
        r.add_depth_measurement(0.05, wall_depth())
        r.add_depth_measurement(0.15, wall_depth())
        time.sleep(0.15)
        assert r.n_integrated == 0  # held back: the trajectory is empty
        r.state_update_callback(state(pkg, 0, 0.0, 0.0))
        r.state_update_callback(state(pkg, 1, 0.1, 0.05))
        wait_integrated(r, 1)
        r.state_update_callback(state(pkg, 2, 0.2, 0.10))
        wait_integrated(r, 2)
        finish_and_join(r)
    jr, tr = pair
    assert tr.n_integrated == 2 and tr.n_dropped == 0
    assert tr.si.active is not None and tr.si.active.n_frames >= 1
    assert (tr.si.active.sm.logodds > 0).sum() > 0  # wall voxels marked occupied
    assert (tr.n_integrated, tr.n_dropped) == (jr.n_integrated, jr.n_dropped)
    assert_same_maps(jr.si, tr.si)


def test_async_submapping_reanchors_on_correction():
    """A loop-closure correction of the anchor keyframe moves the submap,
    as in the JAX package."""
    pair = runners()
    for r, pkg in zip(pair, (japi, tapi)):
        r.state_update_callback(state(pkg, 0, 0.0, 0.0))
        r.add_depth_measurement(0.0, wall_depth())
        wait_integrated(r, 1)
        r.state_update_callback(state(pkg, 1, 0.1, 0.05))
        finish_and_join(r)
    jr, tr = pair
    assert_same_maps(jr.si, tr.si)
    for r, pkg in zip(pair, (japi, tapi)):
        anchor = r.si.active.anchor_fid
        # loop-closure correction: the keyframe's pose moved by 1 m
        corrected = state(pkg, anchor, 0.0, 1.0)
        r.si.on_state_update({corrected.id: corrected.T_WS})
    np.testing.assert_allclose(np.asarray(tr.si.active.sm.T_WK)[:3], [1, 0, 0])
    assert_same_maps(jr.si, tr.si)
