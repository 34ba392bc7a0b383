"""Background full-graph optimisation (torch counterpart of
``okvis2x_tpu/graph/fullgraph.py``).

The realtime window and the whole-history pose graph are optimised apart:

  * `dispatch` takes an immutable snapshot of the estimator's long-term pose
    graph (`SlidingWindowEstimator.snapshot_pose_graph`, plain numpy) and
    solves it on a worker thread, on a CUDA stream of its own when the
    estimator runs on a card (the dense pose-graph LM up to `pcg_threshold`
    nodes, the matrix-free PCG solver above);
  * the frame thread never waits for it: it polls
    `is_loop_closure_available` and calls `synchronise`, which writes the
    optimised poses back and moves the frames added since the snapshot
    rigidly with the newest snapshot frame of the window;
  * a result whose snapshot predates a correction applied since (a loop
    surgery, another synchronisation) is discarded (`n_stale_discarded`):
    applied, it would re-anchor the window into the world before that
    correction.

A failed solve is logged and leaves the window uncorrected until the next
dispatch, as in the JAX package.  The background complete-factor-graph BA
below `full_ba_threshold` keyframes (`snapshot_full_ba`) is not ported: a
threshold above 0 raises.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np
import torch

from okvis2x_tpu_torch.graph import posegraph
from okvis2x_tpu_torch.parallel import dist_posegraph
from okvis2x_tpu_torch.utils import timing


class FullGraphOptimizer:
    """One background pose-graph optimisation in flight at a time."""

    def __init__(self, iterations: int = 15, dtype=torch.float64, pcg_threshold: int = 256,
                 full_ba_threshold: int = 0):
        """Above `pcg_threshold` keyframes the dense (6K)^2 normal equations
        give way to the matrix-free PCG solver (`parallel/dist_posegraph`)."""
        if full_ba_threshold > 0:
            raise NotImplementedError("the background complete-factor-graph BA "
                                      "(full_ba_threshold > 0) is not ported yet")
        self.iterations = iterations
        self.dtype = dtype
        self.pcg_threshold = pcg_threshold
        self._thread: Optional[threading.Thread] = None
        self._stream = None  # the worker's CUDA stream, made at the first dispatch on a card
        self._snap: Optional[dict] = None
        self._result: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self.n_dispatched = 0
        self.n_synchronised = 0
        self.n_stale_discarded = 0

    # -- status -----------------------------------------------------------
    @property
    def is_loop_closing(self) -> bool:
        """An optimisation is in flight."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def is_loop_closure_available(self) -> bool:
        """A finished result waits for `synchronise`."""
        with self._lock:
            return self._result is not None and not self.is_loop_closing

    # -- lifecycle --------------------------------------------------------
    def dispatch(self, est) -> bool:
        """Snapshot the estimator's long-term pose graph and optimise it on a
        worker thread.  False when one is in flight, a result is pending, or
        the graph has fewer than two nodes."""
        if self.is_loop_closing:
            return False
        with self._lock:
            if self._result is not None:
                return False
        snap = est.snapshot_pose_graph()
        if snap is None:
            return False
        self._snap = snap
        device = est.device
        if device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream if device.type == "cuda" else None

        def work():
            try:
                # the snapshot is host numpy: it reaches the card on this
                # stream (None on the CPU: no-op), the result comes back as numpy
                with torch.cuda.stream(stream), timing.Timer("4.1 FullGraphSolve"):
                    solve = (dist_posegraph.optimize_pose_graph_pcg
                             if snap["T"].shape[0] > self.pcg_threshold
                             else posegraph.optimize_pose_graph)
                    T_opt, _ = solve(snap["T"], snap["fixed"], snap["ei"], snap["ej"],
                                     snap["eT"], snap["eS"], iterations=self.iterations,
                                     dtype=self.dtype, device=device)
            except Exception:  # noqa: BLE001 — logged; the window continues uncorrected
                logging.exception("background pose-graph solve failed")
                return
            with self._lock:
                self._result = T_opt

        self._thread = threading.Thread(target=work, name="full-graph-optimisation",
                                        daemon=True)
        self._thread.start()
        self.n_dispatched += 1
        return True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the optimisation in flight, if any; True once none is."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        return not self.is_loop_closing

    def synchronise(self, est) -> bool:
        """Apply a finished result: the snapshot's poses are written back and
        the frames added since move rigidly with the newest snapshot frame of
        the window (`apply_pose_graph_result`).  No-op unless a result is
        available; a stale result is discarded."""
        with self._lock:
            if self.is_loop_closing or self._result is None:
                return False
            T_opt, snap = self._result, self._snap
            self._result, self._snap = None, None
        if snap.get("epoch") != est.correction_epoch:
            self._log_stale(est, snap.get("epoch"))
            return False
        ok = est.apply_pose_graph_result(snap["fids"], T_opt)
        if ok:
            self.n_synchronised += 1
        return ok

    def _log_stale(self, est, snap_epoch):
        """A correction landed between the snapshot and the result: the
        snapshot's world is no longer the window's, so the result is
        dropped; the next dispatch snapshots a consistent state."""
        self.n_stale_discarded += 1
        logging.info("full-graph result discarded: snapshot epoch %s != current %d "
                     "(corrections applied while solving)", snap_epoch, est.correction_epoch)
