"""SE(3) / quaternion math for the estimator (torch).

Counterpart of ``okvis2x_tpu/core/se3.py`` with the same conventions:

  * quaternions stored ``[x, y, z, w]`` (Eigen layout), Hamilton product;
  * a transformation is a length-7 tensor ``[t(3), q(4)]`` mapping points
    from the child frame into the parent frame: ``p_parent = C(q) p_child + t``;
  * the minimal 6-dof increment is ``delta = [dt(3), dalpha(3)]`` applied as
    ``t <- t + dt``, ``q <- deltaQ(dalpha) * q`` (OKVIS ``oplus``).

Every function broadcasts over leading batch dimensions and is written with
plain tensor ops, so ``torch.func.jacfwd``/``vmap`` differentiate through
``retract`` exactly as the JAX package's autodiff does.
"""

from __future__ import annotations

import torch

from okvis2x_tpu_torch.utils.forward_ad import lift


def quat_identity(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_multiply(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product p ⊗ q, both [x,y,z,w]."""
    px, py, pz, pw = p.unbind(-1)
    qx, qy, qz, qw = q.unbind(-1)
    return torch.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        dim=-1,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q: C(q) v (Rodrigues form)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = lift(2.0, q) * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix C(q), shape (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [x,y,z,w], branch-free (Shepperd's
    method with the four candidate solutions selected by `where`)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    sw = safe_sqrt(1.0 + tr)
    sx = safe_sqrt(1.0 + m00 - m11 - m22)
    sy = safe_sqrt(1.0 - m00 + m11 - m22)
    sz = safe_sqrt(1.0 - m00 - m11 + m22)
    qw_w = torch.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                        (m10 - m01) / (2 * sw), sw / 2], dim=-1)
    qx_w = torch.stack([sx / 2, (m01 + m10) / (2 * sx),
                        (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)], dim=-1)
    qy_w = torch.stack([(m01 + m10) / (2 * sy), sy / 2,
                        (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)], dim=-1)
    qz_w = torch.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                        sz / 2, (m10 - m01) / (2 * sz)], dim=-1)
    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_w, qw_w,
                    torch.where(cond_x, qx_w, torch.where(cond_y, qy_w, qz_w)))
    return quat_normalize(q)


def delta_q(dalpha: torch.Tensor) -> torch.Tensor:
    """Exact exponential of a small rotation vector as a quaternion:
    q = [sinc(|a|/2) * a/2, cos(|a|/2)] with a Taylor-safe sinc."""
    one = lift(1.0, dalpha)
    half = lift(0.5, dalpha) * dalpha
    theta2 = torch.sum(half * half, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    sinc = torch.where(small, one - theta2 / lift(6.0, dalpha), torch.sin(theta) / theta)
    # kept (..., 1): forward AD promotes the tangent of a 0-dim float32
    # `where` to float64
    cos = torch.where(small, one - theta2 / lift(2.0, dalpha), torch.cos(theta))
    return torch.cat([sinc * half, cos], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a unit quaternion (inverse of delta_q)."""
    qv = q[..., :3]
    qw = q[..., 3]
    sign = lift(torch.where(qw < 0, -1.0, 1.0).to(q.dtype), q)
    qv = qv * sign[..., None]
    qw = qw * sign
    n = torch.linalg.norm(qv, dim=-1)
    two = lift(2.0, q)
    angle = two * torch.atan2(n, qw)
    small = n < 1e-8
    scale = torch.where(
        small,
        two / torch.clamp(qw, min=1e-12),
        angle / torch.clamp(n, min=1e-24),
    )
    return qv * scale[..., None]


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]_x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def se3_identity(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)


def se3_t(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def se3_q(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:7]


def se3_multiply(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Composition: (Ta * Tb) p = Ta (Tb p)."""
    t = se3_t(Ta) + quat_rotate(se3_q(Ta), se3_t(Tb))
    q = quat_normalize(quat_multiply(se3_q(Ta), se3_q(Tb)))
    return torch.cat([t, q], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    qinv = quat_conjugate(se3_q(T))
    t = -quat_rotate(qinv, se3_t(T))
    return torch.cat([t, qinv], dim=-1)


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform 3D point(s): C(q) p + t."""
    return quat_rotate(se3_q(T), p) + se3_t(T)


def se3_apply_homogeneous(T: torch.Tensor, hp: torch.Tensor) -> torch.Tensor:
    """Transform homogeneous 4-vector(s): [C p3 + w t, w]."""
    p3 = hp[..., :3]
    w = hp[..., 3:4]
    return torch.cat([quat_rotate(se3_q(T), p3) + w * se3_t(T), w], dim=-1)


def retract(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """OKVIS boxplus: t += dt; q <- deltaQ(dalpha) * q.  Factors
    differentiate through this to get their minimal Jacobians."""
    T = lift(T, delta)
    t = se3_t(T) + delta[..., :3]
    q = quat_normalize(quat_multiply(delta_q(delta[..., 3:6]), se3_q(T)))
    return torch.cat([t, q], dim=-1)


def local_delta(T_ref: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Inverse of `retract`: dt = t - t_ref; dalpha = log(q * q_ref^-1)."""
    T_ref = lift(T_ref, T)
    dt = se3_t(T) - se3_t(T_ref)
    dq = quat_multiply(se3_q(T), quat_conjugate(se3_q(T_ref)))
    return torch.cat([dt, quat_log(dq)], dim=-1)


def se3_interpolate(Ta: torch.Tensor, Tb: torch.Tensor, alpha) -> torch.Tensor:
    """Geodesic interpolation between two poses (t lerp, q slerp through the
    log)."""
    return retract(Ta, alpha * local_delta(Ta, Tb))
