"""NumPy twins of the SE(3)/quaternion helpers in core/se3.py.

The host-side orchestration (estimator bookkeeping, trajectory queries,
pose-graph surgery) composes poses one at a time.  Calling the jnp
versions there executes each tiny op eagerly on the accelerator — on a
remote TPU backend every such op is a ~1 ms dispatch round-trip, and the
per-frame host path was measured at 600-3700 eager dispatches/frame.
These numpy implementations keep host math on the host; the jnp versions
in core/se3.py remain the single source of truth inside jitted programs.

Property-tested against core/se3.py on random inputs
(tests/test_se3.py::test_numpy_twins_match_jax).

Conventions identical to se3.py: pose = 7-vector [t(3), q(x,y,z,w)];
retract is OKVIS oplus (t += dt, q <- deltaQ(dalpha) * q,
reference okvis_kinematics Transformation.hpp:208).
"""

from __future__ import annotations

import numpy as np


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0])


def quat_normalize(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(n, 1e-30)


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q)
    return np.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_multiply(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    p, q = np.asarray(p), np.asarray(q)
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        axis=-1,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    q, v = np.asarray(q), np.asarray(v)
    u = q[..., :3]
    w = q[..., 3:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [x,y,z,w] (Shepperd's method, the four
    candidate solutions selected by `where`, as ``core/se3.matrix_to_quat``;
    numpy's sqrt is correctly rounded, as XLA's is)."""
    m = np.asarray(m, np.float64)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    sw = np.sqrt(np.maximum(1.0 + tr, 1e-12))
    sx = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-12))
    sy = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 1e-12))
    sz = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 1e-12))
    qw_w = np.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                     (m10 - m01) / (2 * sw), sw / 2], axis=-1)
    qx_w = np.stack([sx / 2, (m01 + m10) / (2 * sx),
                     (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)], axis=-1)
    qy_w = np.stack([(m01 + m10) / (2 * sy), sy / 2,
                     (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)], axis=-1)
    qz_w = np.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                     sz / 2, (m10 - m01) / (2 * sz)], axis=-1)
    q = np.where((tr > 0.0)[..., None], qw_w,
                 np.where(((m00 > m11) & (m00 > m22))[..., None], qx_w,
                          np.where((m11 > m22)[..., None], qy_w, qz_w)))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def delta_q(dalpha: np.ndarray) -> np.ndarray:
    """Small-angle quaternion exp(dalpha/2) (≙ okvis::kinematics::deltaQ)."""
    dalpha = np.asarray(dalpha, np.float64)
    half = 0.5 * dalpha
    th = np.linalg.norm(half, axis=-1, keepdims=True)
    small = th < 1e-8
    s = np.where(small, 1.0 - th * th / 6.0, np.sin(th) / np.maximum(th, 1e-30))
    w = np.where(small[..., 0], 1.0 - 0.5 * th[..., 0] * th[..., 0], np.cos(th[..., 0]))
    return np.concatenate([half * s, w[..., None]], axis=-1)


def quat_log(q: np.ndarray) -> np.ndarray:
    """Rotation-vector log; sign-safe, Taylor-safe near identity."""
    q = np.asarray(q, np.float64)
    q = np.where(q[..., 3:4] < 0, -q, q)
    v = q[..., :3]
    w = np.clip(q[..., 3], -1.0, 1.0)
    n = np.linalg.norm(v, axis=-1)
    angle = 2.0 * np.arctan2(n, w)
    scale = np.where(n < 1e-12, 2.0 / np.maximum(w, 1e-30),
                     angle / np.maximum(n, 1e-30))
    return v * scale[..., None]


def cross_matrix(v: np.ndarray) -> np.ndarray:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = np.zeros_like(x)
    m = np.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# -- SE(3) as a 7-vector [t, q] ---------------------------------------------


def se3_identity() -> np.ndarray:
    return np.array([0, 0, 0, 0, 0, 0, 1.0])


def se3_t(T: np.ndarray) -> np.ndarray:
    return np.asarray(T)[..., :3]


def se3_q(T: np.ndarray) -> np.ndarray:
    return np.asarray(T)[..., 3:7]


def se3_rotation(T: np.ndarray) -> np.ndarray:
    return quat_to_matrix(se3_q(T))


def se3_matrix(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T)
    C = se3_rotation(T)
    t = se3_t(T)[..., None]
    top = np.concatenate([C, t], axis=-1)
    bottom = np.broadcast_to(
        np.array([0, 0, 0, 1.0]), T.shape[:-1] + (1, 4)
    )
    return np.concatenate([top, bottom], axis=-2)


def se3_multiply(Ta: np.ndarray, Tb: np.ndarray) -> np.ndarray:
    t = se3_t(Ta) + quat_rotate(se3_q(Ta), se3_t(Tb))
    q = quat_normalize(quat_multiply(se3_q(Ta), se3_q(Tb)))
    return np.concatenate([t, q], axis=-1)


def se3_inverse(T: np.ndarray) -> np.ndarray:
    qinv = quat_conjugate(se3_q(T))
    t = -quat_rotate(qinv, se3_t(T))
    return np.concatenate([t, qinv], axis=-1)


def se3_apply(T: np.ndarray, p: np.ndarray) -> np.ndarray:
    return quat_rotate(se3_q(T), p) + se3_t(T)


def se3_apply_homogeneous(T: np.ndarray, hp: np.ndarray) -> np.ndarray:
    hp = np.asarray(hp)
    p3 = hp[..., :3]
    w = hp[..., 3:4]
    return np.concatenate(
        [quat_rotate(se3_q(T), p3) + w * se3_t(T), w], axis=-1
    )


def retract(T: np.ndarray, delta: np.ndarray) -> np.ndarray:
    t = se3_t(T) + np.asarray(delta)[..., :3]
    q = quat_normalize(
        quat_multiply(delta_q(np.asarray(delta)[..., 3:6]), se3_q(T))
    )
    return np.concatenate([t, q], axis=-1)


def local_delta(T_ref: np.ndarray, T: np.ndarray) -> np.ndarray:
    dt = se3_t(T) - se3_t(T_ref)
    dq = quat_multiply(se3_q(T), quat_conjugate(se3_q(T_ref)))
    return np.concatenate([dt, quat_log(dq)], axis=-1)


def se3_interpolate(Ta: np.ndarray, Tb: np.ndarray, alpha) -> np.ndarray:
    """Geodesic interpolation, same formula as se3.se3_interpolate."""
    d = local_delta(Ta, Tb)
    return retract(Ta, alpha * d)


def normalize(T: np.ndarray) -> np.ndarray:
    return np.concatenate([se3_t(T), quat_normalize(se3_q(T))], axis=-1)
