"""NumPy twin of the IMU preintegration path (imu/preintegration.py).

Hosts two responsibilities the device programs are wrong for:

1. Per-frame state *prediction* in `SlidingWindowEstimator.add_state` —
   dq/dp/dv over the ~10-20 samples between two frames is microseconds of
   math; a device program execution costs ~22 ms fixed on the remote TPU
   runtime (`predict_state`).
2. The *chained* per-link preintegration cache (`preintegrate_full` +
   `compose`): the reference never re-preintegrates a window link from raw
   samples — `ImuError` is constructed incrementally
   (okvis_ceres/include/okvis/ceres/ImuError.hpp:296 `append`), non-keyframe
   elimination MERGES adjacent IMU chains
   (okvis_ceres/src/ViSlamBackend.cpp:511 `eliminateImuFrames`), and
   `redoPreintegration` runs lazily only when the bias moved past a
   threshold (okvis_ceres/src/ImuError.cpp:258).  The TPU rebuild mirrors
   that host-side in f64: each chain link caches a `Preintegrated` (+ its
   sqrt-information), merged links are composed in closed form, and the
   device factor applies first-order bias correction around the cached
   linearisation point (factors/imu_factor.py).  This removes any cap on
   the raw-sample span of a link — the round-2 fixed 512-sample buffer
   overflowed (and crashed) once keyframes aged past 2.56 s.

Property-tested against the jax implementation in tests/test_imu.py
(prediction, full preintegration, and compose == from-raw).
"""

from __future__ import annotations

import numpy as np

from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.imu.preintegration import Preintegrated


def predict_state(
    params,
    t: np.ndarray,  # (n,) sample times covering [t0, t1]
    gyr: np.ndarray,  # (n, 3)
    acc: np.ndarray,  # (n, 3)
    t0: float,
    t1: float,
    T_WS0: np.ndarray,  # (7,)
    v_W0: np.ndarray,  # (3,)
    bg: np.ndarray,
    ba: np.ndarray,
):
    """Returns (T_WS1 (7,), v_W1 (3,)): midpoint-integrated prediction."""
    ta = np.clip(t[:-1], t0, t1)
    tb = np.clip(t[1:], t0, t1)
    dts = np.maximum(tb - ta, 0.0)
    g0 = gyr[:-1] - bg
    g1 = gyr[1:] - bg
    a0 = acc[:-1] - ba
    a1 = acc[1:] - ba

    dq = np.array([0.0, 0.0, 0.0, 1.0])
    dp = np.zeros(3)
    dv = np.zeros(3)
    for k in range(len(dts)):
        dt = dts[k]
        if dt <= 0.0:
            continue
        omega = 0.5 * (g0[k] + g1[k])
        dq_step = se3np.delta_q(omega * dt)
        dq_new = se3np.quat_normalize(se3np.quat_multiply(dq, dq_step))
        C0 = se3np.quat_to_matrix(dq)
        C1 = se3np.quat_to_matrix(dq_new)
        acc_S0 = 0.5 * (C0 @ a0[k] + C1 @ a1[k])
        dp = dp + dv * dt + 0.5 * acc_S0 * dt * dt
        dv = dv + acc_S0 * dt
        dq = dq_new

    g_W = np.array([0.0, 0.0, -params.g])
    C_WS0 = se3np.quat_to_matrix(T_WS0[3:7])
    dt_tot = float(dts.sum())
    t1_W = T_WS0[:3] + v_W0 * dt_tot + 0.5 * g_W * dt_tot**2 + C_WS0 @ dp
    v1_W = v_W0 + g_W * dt_tot + C_WS0 @ dv
    q1 = se3np.quat_normalize(se3np.quat_multiply(T_WS0[3:7], dq))
    return np.concatenate([t1_W, q1]), v1_W


def predict_states_batch(
    params,
    t: np.ndarray,  # (n,) sample times covering [t0, max(tq)]
    gyr: np.ndarray,  # (n, 3)
    acc: np.ndarray,  # (n, 3)
    t0: float,
    tq: np.ndarray,  # (m,) SORTED query times >= t0
    T_WS0: np.ndarray,  # (7,)
    v_W0: np.ndarray,  # (3,)
    bg: np.ndarray,
    ba: np.ndarray,
) -> np.ndarray:
    """Poses T_WS (m, 7) at a sorted batch of query times by ONE
    incremental midpoint integration pass over the raw samples — the
    host-side engine behind per-ray LiDAR deskew (≙ the reference
    propagating IMU per ray, okvis_mapping/include/okvis/
    LidarMotionUndistortion.hpp:22-59, via Propagator/
    BatchedLidarPropagator).  O(n + m), not m restarts."""
    tq = np.asarray(tq, np.float64)
    out = np.zeros((len(tq), 7))
    g_W = np.array([0.0, 0.0, -params.g])
    C_WS0 = se3np.quat_to_matrix(T_WS0[3:7])

    dq = np.array([0.0, 0.0, 0.0, 1.0])
    dp = np.zeros(3)
    dv = np.zeros(3)
    t_cur = t0
    qi = 0
    m = len(tq)

    def emit(up_to, dq, dp, dv, t_cur, omega):
        """Emit all queries <= up_to from the current integrated state:
        first-order hold over the sub-sample gap (rotation advanced with
        the current rate — at rad/s rates a zero-order hold leaves
        centimetres at LiDAR range)."""
        nonlocal qi
        dt_tot = t_cur - t0
        while qi < m and tq[qi] <= up_to + 1e-12:
            dte = max(float(tq[qi]) - t_cur, 0.0)
            dt_q = dt_tot + dte
            p = (T_WS0[:3] + v_W0 * dt_q + 0.5 * g_W * dt_q**2
                 + C_WS0 @ (dp + dv * dte))
            dq_e = se3np.quat_normalize(
                se3np.quat_multiply(dq, se3np.delta_q(omega * dte))
            ) if dte > 0 else dq
            q = se3np.quat_normalize(se3np.quat_multiply(T_WS0[3:7], dq_e))
            out[qi] = np.concatenate([p, q])
            qi += 1

    n = len(t)
    omega = gyr[0] - bg if n else np.zeros(3)
    for k in range(n - 1):
        tb = float(t[k + 1])
        if tb <= t_cur:
            continue
        omega = 0.5 * (gyr[k] + gyr[k + 1]) - bg
        # queries inside this segment: first-order hold forward from the
        # last integrated state at the segment's rate
        emit(tb - 1e-9, dq, dp, dv, t_cur, omega)
        dt = tb - max(float(t[k]), t_cur)
        if dt <= 0:
            continue
        dq_step = se3np.delta_q(omega * dt)
        dq_new = se3np.quat_normalize(se3np.quat_multiply(dq, dq_step))
        C0 = se3np.quat_to_matrix(dq)
        C1 = se3np.quat_to_matrix(dq_new)
        acc_S = 0.5 * (C0 @ (acc[k] - ba) + C1 @ (acc[k + 1] - ba))
        dp = dp + dv * dt + 0.5 * acc_S * dt * dt
        dv = dv + acc_S * dt
        dq = dq_new
        t_cur = tb
        if qi >= m:
            break
    # queries beyond the last sample: first-order extrapolation
    emit(np.inf, dq, dp, dv, t_cur, omega)
    return out


def preintegrate_full(
    params,
    t: np.ndarray,  # (n,) sample times covering [t0, t1]
    gyr: np.ndarray,  # (n, 3)
    acc: np.ndarray,  # (n, 3)
    t0: float,
    t1: float,
    bg: np.ndarray,
    ba: np.ndarray,
) -> Preintegrated:
    """Full preintegration (deltas, bias Jacobians, covariance) on the host.

    Numerically mirrors the jax scan in imu/preintegration.py::preintegrate
    (which itself mirrors ImuError::redoPreintegration,
    okvis_ceres/src/ImuError.cpp:258) so cached host links and device-fused
    spans are interchangeable.  Error-state order [dp, dalpha, dv, dbg, dba].
    """
    t = np.asarray(t, np.float64)
    bg = np.asarray(bg, np.float64)
    ba = np.asarray(ba, np.float64)
    if len(t) >= 2:
        ta = np.clip(t[:-1], t0, t1)
        tb = np.clip(t[1:], t0, t1)
        dts = np.maximum(tb - ta, 0.0)
        g0 = gyr[:-1] - bg
        g1 = gyr[1:] - bg
        a0 = acc[:-1] - ba
        a1 = acc[1:] - ba
    else:
        dts = np.zeros(0)
        g0 = g1 = a0 = a1 = np.zeros((0, 3))

    sg2 = params.sigma_g**2
    sa2 = params.sigma_a**2
    sgw2 = params.sigma_gw**2
    saw2 = params.sigma_aw**2

    I3 = np.eye(3)
    dq = se3np.quat_identity()
    dp = np.zeros(3)
    dv = np.zeros(3)
    dp_dbg = np.zeros((3, 3))
    dp_dba = np.zeros((3, 3))
    dv_dbg = np.zeros((3, 3))
    dv_dba = np.zeros((3, 3))
    dq_dbg = np.zeros((3, 3))
    P = np.zeros((15, 15))

    for k in range(len(dts)):
        dt = dts[k]
        if dt <= 0.0:
            continue
        omega = 0.5 * (g0[k] + g1[k])
        dq_step = se3np.delta_q(omega * dt)
        dq_new = se3np.quat_normalize(se3np.quat_multiply(dq, dq_step))
        C0 = se3np.quat_to_matrix(dq)
        C1 = se3np.quat_to_matrix(dq_new)
        acc_S0 = 0.5 * (C0 @ a0[k] + C1 @ a1[k])
        dv_new = dv + acc_S0 * dt
        dp_new = dp + dv * dt + 0.5 * acc_S0 * dt * dt

        C_step = se3np.quat_to_matrix(dq_step)
        dq_dbg_new = C_step.T @ dq_dbg - I3 * dt

        acc_avg = 0.5 * (a0[k] + a1[k])
        dacc_dbg = -C0 @ se3np.cross_matrix(acc_avg) @ dq_dbg
        dacc_dba = -0.5 * (C0 + C1)

        dv_dbg_new = dv_dbg + dacc_dbg * dt
        dv_dba_new = dv_dba + dacc_dba * dt
        dp_dbg_new = dp_dbg + dv_dbg * dt + 0.5 * dacc_dbg * dt * dt
        dp_dba_new = dp_dba + dv_dba * dt + 0.5 * dacc_dba * dt * dt

        F = np.eye(15)
        F[0:3, 6:9] = I3 * dt
        F[0:3, 3:6] = -0.5 * C0 @ se3np.cross_matrix(acc_avg) * dt * dt
        F[0:3, 12:15] = 0.5 * dacc_dba * dt * dt
        F[3:6, 3:6] = C_step.T
        F[3:6, 9:12] = -I3 * dt
        F[6:9, 3:6] = -C0 @ se3np.cross_matrix(acc_avg) * dt
        F[6:9, 12:15] = dacc_dba * dt
        P = F @ P @ F.T
        P[0:3, 0:3] += I3 * (0.25 * sa2 * dt**3)
        P[3:6, 3:6] += I3 * (sg2 * dt)
        P[6:9, 6:9] += I3 * (sa2 * dt)
        P[9:12, 9:12] += I3 * (sgw2 * dt)
        P[12:15, 12:15] += I3 * (saw2 * dt)

        dq, dp, dv = dq_new, dp_new, dv_new
        dp_dbg, dp_dba = dp_dbg_new, dp_dba_new
        dv_dbg, dv_dba = dv_dbg_new, dv_dba_new
        dq_dbg = dq_dbg_new

    return Preintegrated(
        dq=dq, dp=dp, dv=dv,
        dp_dbg=dp_dbg, dp_dba=dp_dba,
        dv_dbg=dv_dbg, dv_dba=dv_dba,
        dq_dbg=dq_dbg, P=P,
        dt=float(dts.sum()), lin_bg=bg.copy(), lin_ba=ba.copy(),
    )


def compose(A: Preintegrated, B: Preintegrated) -> Preintegrated:
    """Merge two consecutive preintegrated segments into one
    (≙ ImuError::append, okvis_ceres/include/okvis/ceres/ImuError.hpp:296 —
    the chain merge used by eliminateImuFrames).

    A covers [t0, tm] in frame S(t0); B covers [tm, t1] in frame S(tm).  B is
    first rebased to A's bias linearisation point (first order), then deltas,
    bias Jacobians and covariance are composed in closed form.  Gravity terms
    combine exactly: 0.5 g (dtA + dtB)^2 = 0.5 g dtA^2 + g dtA dtB + 0.5 g
    dtB^2 matches dp_AB = dp_A + dv_A dtB + C_A dp_B.
    """
    # rebase B to A's linearisation point
    dbg = A.lin_bg - B.lin_bg
    dba = A.lin_ba - B.lin_ba
    dp_B = B.dp + B.dp_dbg @ dbg + B.dp_dba @ dba
    dv_B = B.dv + B.dv_dbg @ dbg + B.dv_dba @ dba
    dq_B = se3np.quat_normalize(
        se3np.quat_multiply(B.dq, se3np.delta_q(B.dq_dbg @ dbg))
    )

    C_A = se3np.quat_to_matrix(A.dq)
    C_B = se3np.quat_to_matrix(dq_B)
    dtB = float(B.dt)
    I3 = np.eye(3)

    dq = se3np.quat_normalize(se3np.quat_multiply(A.dq, dq_B))
    dv = A.dv + C_A @ dv_B
    dp = A.dp + A.dv * dtB + C_A @ dp_B

    # bias Jacobians: rotation errors compose as
    # dtheta_AB = C_B^T dtheta_A + dtheta_B; translation/velocity pick up
    # the -C_A [x]x dtheta_A sensitivity of the rotated B terms.
    dq_dbg = C_B.T @ A.dq_dbg + B.dq_dbg
    dv_dbg = (A.dv_dbg + C_A @ B.dv_dbg
              - C_A @ se3np.cross_matrix(dv_B) @ A.dq_dbg)
    dv_dba = A.dv_dba + C_A @ B.dv_dba
    dp_dbg = (A.dp_dbg + dtB * A.dv_dbg + C_A @ B.dp_dbg
              - C_A @ se3np.cross_matrix(dp_B) @ A.dq_dbg)
    dp_dba = A.dp_dba + dtB * A.dv_dba + C_A @ B.dp_dba

    # covariance: P_AB = F P_A F^T + G P_B G^T.  F maps A's terminal error
    # (incl. its accumulated bias random walk, which acts as a bias offset
    # throughout B — hence B's bias Jacobians in the bias columns); G
    # rotates B's dp/dv errors from S(tm) into S(t0).
    F = np.eye(15)
    F[0:3, 3:6] = -C_A @ se3np.cross_matrix(dp_B)
    F[0:3, 6:9] = dtB * I3
    F[0:3, 9:12] = C_A @ B.dp_dbg
    F[0:3, 12:15] = C_A @ B.dp_dba
    F[3:6, 3:6] = C_B.T
    F[3:6, 9:12] = B.dq_dbg
    F[6:9, 3:6] = -C_A @ se3np.cross_matrix(dv_B)
    F[6:9, 9:12] = C_A @ B.dv_dbg
    F[6:9, 12:15] = C_A @ B.dv_dba
    G = np.eye(15)
    G[0:3, 0:3] = C_A
    G[6:9, 6:9] = C_A
    P = F @ A.P @ F.T + G @ B.P @ G.T

    return Preintegrated(
        dq=dq, dp=dp, dv=dv,
        dp_dbg=dp_dbg, dp_dba=dp_dba,
        dv_dbg=dv_dbg, dv_dba=dv_dba,
        dq_dbg=dq_dbg, P=0.5 * (P + P.T),
        dt=float(A.dt) + dtB,
        lin_bg=np.asarray(A.lin_bg, np.float64).copy(),
        lin_ba=np.asarray(A.lin_ba, np.float64).copy(),
    )


def sqrt_information(P: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Host twin of factors/imu_factor.py::sqrt_information — W = L^-1 with
    P = L L^T, so W^T W = P^-1.  Computed in f64 where merged-link
    covariances (position variance ~ t^3) stay well-conditioned."""
    n = P.shape[0]
    Preg = 0.5 * (P + P.T) + eps * np.eye(n)
    L = np.linalg.cholesky(Preg)
    return np.linalg.solve(L, np.eye(n))
