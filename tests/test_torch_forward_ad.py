"""The port's linearisations stay out of PyTorch's Python reference
implementations under forward-mode AD (`utils/forward_ad.lift`).

Under `jacfwd` a binary op between a tensor that carries a tangent and an
operand that carries none runs through `torch._refs`, in Python, several
times slower than the op; `lift` gives such an operand a zero tangent
first.  Nothing but timing would show a factor that skips it, so these
tests count the calls that enter the reference implementations from the
port during one `linearize`, by the line that made them: none for the
visual-inertial window with depth rows, and at most today's count for the
GNSS window (every visual-inertial family with the GNSS and extrinsics
rows) and the ICP rows, whose GNSS and grid code is not lifted yet
(ROADMAP.md)."""

import collections
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch.func import jacfwd

import test_torch_depth
import test_torch_gps
import test_torch_icp
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.imu import preintegration as pre
from okvis2x_tpu_torch.solver import gauss_newton as gn
from okvis2x_tpu_torch.utils.forward_ad import lift

torch.set_num_threads(1)

TORCH = os.path.dirname(torch.__file__)
REFERENCE = tuple(os.path.join(TORCH, d) + os.sep
                  for d in ("_refs", "_prims", "_prims_common", "_decomp"))
# the calls into the reference implementations that one linearisation makes
# today on torch 2.13: the GNSS rows (gps.py, the preintegration it
# repropagates, their quaternion products) and the ICP rows (the grid's
# trilinear interpolation)
UNLIFTED = {"gnss": 88, "icp": 69}


def reference_calls(fn):
    """{port file:line: calls} of PyTorch's Python reference implementations
    entered from outside torch while `fn()` runs, after one warm call (a
    first call also takes one-time paths)."""
    fn()
    calls = collections.Counter()

    def trace(frame, event, arg):  # called on each Python call; no line events
        if (frame.f_code.co_filename.startswith(REFERENCE) and frame.f_back is not None
                and not frame.f_back.f_code.co_filename.startswith(TORCH)):
            caller = frame.f_back
            calls[f"{os.path.basename(caller.f_code.co_filename)}:{caller.f_lineno}"] += 1

    sys.settrace(trace)
    try:
        fn()
    finally:
        sys.settrace(None)
    return calls


def test_counter_sees_the_reference_path():
    """A tangent plus a constant enters the reference implementations; the
    same sum with the constant lifted does not."""
    c = torch.tensor([0.3, 0.2, 0.1], dtype=torch.float64)
    z = torch.zeros(3, dtype=torch.float64)
    assert sum(reference_calls(lambda: jacfwd(lambda d: d + c)(z)).values()) >= 1
    assert not reference_calls(lambda: jacfwd(lambda d: d + lift(c, d))(z))
    np.testing.assert_array_equal(jacfwd(lambda d: d + lift(c, d))(z).numpy(), np.eye(3))


def problem(name):
    """(port problem, cameras, solver config) of `name`."""
    if name == "vio_depth":
        p, cams = test_torch_depth.depth_window_problem()
        cfg = gn.SolverConfig(use_depth=True)
    elif name == "gnss":
        p, cams = test_torch_gps.gnss_window_problem(True)
        cfg = gn.SolverConfig(imu_params=pre.ImuParams(), use_ext_priors=True)
    else:
        _, _, pt, ct = test_torch_icp.port_problem(-0.06, 64)
        return pt, ct, gn.SolverConfig(icp_cfg=convert.submap_config(test_torch_icp.J_CFG_GRID),
                                       estimate_landmarks=False)
    return (convert.ba_problem(jax.tree.map(np.asarray, p)),
            convert.stacked_cameras(jax.tree.map(np.asarray, cams)), cfg)


@pytest.mark.parametrize("name", ["vio_depth", "gnss", "icp"])
def test_linearize_stays_off_the_reference_path(name):
    """One `linearize`: no reference-implementation call for the window with
    reprojection, IMU and depth rows; at most UNLIFTED for the others."""
    pt, ct, cfg = problem(name)
    calls = reference_calls(lambda: gn.linearize(pt, ct, cfg))
    assert sum(calls.values()) <= UNLIFTED.get(name, 0), dict(calls)
    if name == "gnss":  # every visual-inertial family of this window is lifted
        assert not {k for k in calls if k.split(":")[0] in ("imu_factor.py", "reprojection.py",
                                                           "priors.py")}, dict(calls)
