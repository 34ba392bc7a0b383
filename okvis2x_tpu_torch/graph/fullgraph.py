"""Background full-graph optimisation (torch counterpart of
``okvis2x_tpu/graph/fullgraph.py``).

The realtime window and the whole history are optimised apart:

  * `dispatch` takes an immutable snapshot of the estimator and solves it on
    a worker thread, on a CUDA stream of its own when the estimator runs on
    a card.  Up to `full_ba_threshold` keyframes the snapshot is the
    complete factor graph (`SlidingWindowEstimator.snapshot_full_ba`:
    archived observations re-expanded, IMU links re-propagated, loop edges
    kept), built on the caller's thread and solved by the worker; above it,
    the long-term pose graph (`snapshot_pose_graph`, plain numpy: the dense
    pose-graph LM up to `pcg_threshold` nodes, the matrix-free PCG solver
    above);
  * the frame thread never waits for it: it polls
    `is_loop_closure_available` and calls `synchronise`, which writes the
    optimised poses (and, after a full BA, speed/biases and landmarks) back
    and moves the frames added since the snapshot rigidly with the newest
    snapshot frame of the window;
  * a result whose snapshot predates a correction applied since (a loop
    surgery, another synchronisation) is discarded (`n_stale_discarded`):
    applied, it would re-anchor the window into the world before that
    correction.

A failed solve is logged and leaves the window uncorrected until the next
dispatch, as in the JAX package.  The solves linearise through
``torch.func`` under `utils/forward_ad.LOCK`, which they take a
linearisation at a time, never for a whole solve: the frame thread's window
solve takes turns with them.
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
                 full_ba_threshold: int = 64):
        """Up to `full_ba_threshold` keyframes the complete factor graph is
        solved (0: never); above `pcg_threshold` keyframes the dense (6K)^2
        pose-graph normal equations give way to the matrix-free PCG solver
        (`parallel/dist_posegraph`)."""
        self.iterations = iterations
        self.dtype = dtype
        self.pcg_threshold = pcg_threshold
        self.full_ba_threshold = full_ba_threshold
        self._thread: Optional[threading.Thread] = None
        self._stream = None  # the worker's CUDA stream, made at the first dispatch on a card
        self._snap: Optional[dict] = None
        self._result: Optional[np.ndarray] = None
        self._full_snap: Optional[dict] = None
        self._full_result = None  # the solved problem, the fields the writeback reads on the host
        self._lock = threading.Lock()
        self.n_dispatched = 0
        self.n_synchronised = 0
        self.n_full_ba = 0
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
            return ((self._result is not None or self._full_result is not None)
                    and not self.is_loop_closing)

    # -- lifecycle --------------------------------------------------------
    def dispatch(self, est) -> bool:
        """Snapshot the estimator (its complete factor graph up to
        `full_ba_threshold` keyframes, else its long-term pose graph) and
        optimise it on a worker thread.  False when one is in flight, a
        pose-graph result is pending, or the graph has fewer than two
        nodes."""
        if self.is_loop_closing:
            return False
        with self._lock:
            if self._result is not None:
                return False
        device = est.device
        if device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream if device.type == "cuda" else None
        if len(est.pose_graph()[0]) <= self.full_ba_threshold:
            full = est.snapshot_full_ba(self.iterations)
            if full is not None:
                return self._dispatch_full_ba(est, full, stream)
        snap = est.snapshot_pose_graph()
        if snap is None:
            return False
        self._snap = snap

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

    def _dispatch_full_ba(self, est, full: dict, stream) -> bool:
        """Solve a `snapshot_full_ba` problem on the worker.  The problem
        was built on the caller's stream: the worker's stream waits for it.
        The fields the writeback reads come back to the host on the worker,
        so that the frame thread needs no event of the worker's stream."""
        self._full_snap = full
        built = None
        if stream is not None:
            built = torch.cuda.Event()
            built.record()

        def work():
            try:
                with torch.cuda.stream(stream), timing.Timer("4.1 FullGraphSolve"):
                    if built is not None:
                        stream.wait_event(built)
                    p_opt, _ = est._full_ba_run_fn(full["problem"], full["iterations"])
                    p_opt = p_opt._replace(**{k: getattr(p_opt, k).cpu()
                                              for k in ("T_WS", "sb", "sb_fixed", "hp_W")})
            except Exception:  # noqa: BLE001 — logged; the window continues uncorrected
                logging.exception("background full-graph BA failed")
                return
            with self._lock:
                self._full_result = p_opt

        self._thread = threading.Thread(target=work, name="full-graph-ba", daemon=True)
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
        the window (`apply_pose_graph_result`; after a full BA
        `apply_full_ba_result`, which also writes speed/biases and
        landmarks).  No-op unless a result is available; a stale result is
        discarded."""
        with self._lock:
            if self.is_loop_closing:
                return False
            p_opt, full = self._full_result, self._full_snap
            T_opt, snap = self._result, self._snap
            if p_opt is not None:
                self._full_result, self._full_snap = None, None
            elif T_opt is not None:
                self._result, self._snap = None, None
            else:
                return False
        if p_opt is not None:
            if full["epoch"] != est.correction_epoch:
                self._log_stale(est, full["epoch"])
                return False
            ok = est.apply_full_ba_result(full["aux"], p_opt)
            if ok:
                self.n_synchronised += 1
                self.n_full_ba += 1
            return ok
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
