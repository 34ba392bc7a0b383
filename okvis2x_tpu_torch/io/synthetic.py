"""Synthetic stereo-inertial sequences rendered in memory (numpy).

Counterpart of the dot-field part of ``okvis2x_tpu/io/synthetic.py``: the
same analytic trajectories, scenes, splat renderer and IMU noise, so
`render_sequence` yields exactly the IMU samples, ground truth and uint8
stereo images that ``okvis2x_tpu.io.synthetic.generate`` writes to disk for
the same arguments — without files or an image codec.  Writing the EuRoC
layout and the textured world wait for a later change.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from okvis2x_tpu_torch.cameras import pinhole_np
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.imu.preintegration import ImuParams

T0_NS = 1_400_000_000_000_000_000  # first IMU timestamp of a sequence [ns]


def analytic_trajectory(t, g=9.81007):
    """Sinusoidal position + yaw; returns (p_W, q_WS[xyzw], v_W, omega_S,
    f_S) at times t."""
    t = np.asarray(t)
    w1 = 2 * np.pi * 0.12
    amp = np.array([1.2, 0.8, 0.3])
    p = np.stack(
        [amp[0] * np.sin(w1 * t), amp[1] * (1 - np.cos(w1 * t)), amp[2] * np.sin(2 * w1 * t)],
        -1,
    )
    v = np.stack(
        [amp[0] * w1 * np.cos(w1 * t), amp[1] * w1 * np.sin(w1 * t),
         amp[2] * 2 * w1 * np.cos(2 * w1 * t)], -1
    )
    a = np.stack(
        [-amp[0] * w1**2 * np.sin(w1 * t), amp[1] * w1**2 * np.cos(w1 * t),
         -amp[2] * (2 * w1) ** 2 * np.sin(2 * w1 * t)], -1
    )
    yaw_rate = 0.15
    yaw = yaw_rate * t
    n = len(t)
    q = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    C_WS = se3np.quat_to_matrix(q)
    g_W = np.array([0, 0, -g])
    f_S = np.einsum("nji,nj->ni", C_WS, a - g_W)
    omega_S = np.einsum("nji,j->ni", C_WS, np.array([0, 0, yaw_rate]))
    return p, q, v, omega_S, f_S


def circuit_trajectory(t, g=9.81007, radius=8.0, speed=1.1,
                       speed_mod=0.22, z_amp=0.25):
    """Laps of a circle with tangent-following yaw — the reference-scale
    loopy benchmark trajectory (every lap revisits every position and
    heading, forcing loop closures).  Speed modulation + z bob keep
    accelerometer biases observable.  Same contract as
    ``analytic_trajectory``: (p_W, q_WS[xyzw], v_W, omega_S, f_S)."""
    t = np.asarray(t)
    w = speed / radius
    wm = 2 * np.pi * 0.07
    wz = 2 * np.pi * 0.11
    th = w * t + speed_mod * np.sin(wm * t)
    dth = w + speed_mod * wm * np.cos(wm * t)
    ddth = -speed_mod * wm * wm * np.sin(wm * t)
    c, s = np.cos(th), np.sin(th)
    p = np.stack([radius * c, radius * s, z_amp * np.sin(wz * t)], -1)
    v = np.stack(
        [-radius * s * dth, radius * c * dth, z_amp * wz * np.cos(wz * t)], -1
    )
    a = np.stack(
        [-radius * c * dth**2 - radius * s * ddth,
         -radius * s * dth**2 + radius * c * ddth,
         -z_amp * wz**2 * np.sin(wz * t)], -1,
    )
    yaw = th + np.pi / 2
    n = len(t)
    q = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    C_WS = se3np.quat_to_matrix(q)
    g_W = np.array([0, 0, -g])
    f_S = np.einsum("nji,nj->ni", C_WS, a - g_W)
    omega_S = np.stack([np.zeros(n), np.zeros(n), dth], -1)
    return p, q, v, omega_S, f_S


def make_scene(n_points=600, seed=3):
    """Random bright dots in a box around/ahead of the trajectory."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -3, 1.5], [5, 4, 7.0], (n_points, 3))
    # camera optical axis is S-frame +z (identity-rotation extrinsics):
    # keep points in front (z in 1.5..7)
    brightness = rng.uniform(0.35, 1.0, n_points)
    radius = rng.uniform(1.0, 2.2, n_points)
    return pts, brightness, radius


def make_circuit_scene(radius=8.0, density=22.0, seed=3, z_lo=3.5, z_hi=6.5,
                       half_width=4.5, satellites=True, sectors=6):
    """Dot 'ceiling' above the circuit annulus.  Each primary dot carries
    0-2 dimmer satellite dots at fixed 3-D offsets, breaking the rotational
    symmetry of isolated blobs so binary descriptors are distinctive and
    repeat exactly on revisit.

    With `sectors` > 0 the ceiling's appearance STATISTICS vary around the
    circuit (density, brightness and satellite richness modulated by
    angular harmonics) — a statistically uniform dot field is globally
    ambiguous to ANY bag-of-words place recogniser (every view shares the
    same word histogram), which tests nothing; real benchmark scenes have
    sector-distinct appearance."""
    rng = np.random.default_rng(seed)
    area = np.pi * ((radius + half_width) ** 2
                    - max(radius - half_width, 0.0) ** 2)
    n = int(area * density * (1.5 if sectors else 1.0))
    # rejection-free annulus sampling in polar coordinates (area-uniform)
    r_lo2 = max(radius - half_width, 0.0) ** 2
    r_hi2 = (radius + half_width) ** 2
    rr = np.sqrt(rng.uniform(r_lo2, r_hi2, n))
    th = rng.uniform(0, 2 * np.pi, n)
    if sectors:
        # angular appearance modulation: density thinning by harmonics
        w = (0.55 + 0.45 * np.cos(sectors * th / 2.0 + 1.0)
             * np.sin(th + 0.7))
        keep = rng.uniform(0, 1, n) < np.clip(0.35 + 0.65 * w, 0.25, 1.0)
        rr, th = rr[keep], th[keep]
        n = len(rr)
    pts = np.stack(
        [rr * np.cos(th), rr * np.sin(th), rng.uniform(z_lo, z_hi, n)], -1
    )
    brightness = rng.uniform(0.4, 1.0, n)
    rad = rng.uniform(1.0, 2.0, n)
    if sectors:
        # sector-dependent brightness + size profiles
        brightness = np.clip(
            brightness * (0.75 + 0.35 * np.sin(th * 2 + 0.3)), 0.25, 1.0)
        rad = rad * (0.85 + 0.3 * (0.5 + 0.5 * np.cos(th * 3 - 0.5)))
    if satellites:
        if sectors:
            # satellite richness varies around the circuit
            p_sat = np.clip(
                1.0 + 1.8 * (0.5 + 0.5 * np.sin(th * sectors / 3.0)), 0, 3)
            n_sat = rng.poisson(p_sat)
            n_sat = np.minimum(n_sat, 3)
        else:
            n_sat = rng.integers(0, 3, n)
        reps = np.repeat(np.arange(n), n_sat)
        if len(reps):
            off = rng.uniform(-0.16, 0.16, (len(reps), 3))
            off[:, 2] *= 0.3
            spts = pts[reps] + off
            sb = brightness[reps] * rng.uniform(0.35, 0.7, len(reps))
            sr = rng.uniform(0.8, 1.3, len(reps))
            pts = np.concatenate([pts, spts])
            brightness = np.concatenate([brightness, sb])
            rad = np.concatenate([rad, sr])
    return pts, brightness, rad


def render_image(cam, T_WC, pts, brightness, radius, noise=0.01, seed=0):
    """Splat scene dots into an image (vectorised numpy; gaussian blobs +
    noise).  Uses the numpy camera twin — no device round-trips, so long
    reference-scale datasets render in minutes."""
    cam_np = cam if isinstance(cam, pinhole_np.NpCamera) else \
        pinhole_np.to_numpy(cam)
    rng = np.random.default_rng(seed)
    H, W = cam_np.height, cam_np.width
    T_CW = se3np.se3_inverse(np.asarray(T_WC, np.float64))
    p_C = se3np.se3_apply(T_CW, np.asarray(pts, np.float64))
    uv, valid = pinhole_np.project(cam_np, p_C)
    valid = valid & (p_C[:, 2] > 0.3)

    img = rng.normal(0.12, noise, (H, W)).astype(np.float32)
    r = 4  # splat half-window
    cx = np.round(uv[:, 0]).astype(np.int64)
    cy = np.round(uv[:, 1]).astype(np.int64)
    sel = np.nonzero(
        valid & (cx >= r) & (cx < W - r) & (cy >= r) & (cy < H - r)
    )[0]
    if len(sel):
        d = np.arange(-r, r + 1)
        sig = (np.asarray(radius)[sel] * 0.8)[:, None]
        ys = cy[sel, None] + d  # (n, 9)
        xs = cx[sel, None] + d
        gy = np.exp(-0.5 * ((ys - uv[sel, 1:2]) / sig) ** 2)
        gx = np.exp(-0.5 * ((xs - uv[sel, 0:1]) / sig) ** 2)
        patch = (np.asarray(brightness)[sel, None, None]
                 * gy[:, :, None] * gx[:, None, :]).astype(np.float32)
        flat = (ys[:, :, None] * W + xs[:, None, :]).ravel()
        np.add.at(img.reshape(-1), flat, patch.ravel())
    return np.clip(img, 0.0, 1.0)


@dataclasses.dataclass
class Sequence:
    """One rendered sequence.  Times in seconds are relative to T0_NS,
    computed from the integer nanosecond stamps as a EuRoC reader does."""

    camera: dict  # fx, fy, cx, cy, width, height, model, dist_params
    T_SC: np.ndarray  # (2, 7)
    imu_ns: np.ndarray  # (n,) int64
    imu_t: np.ndarray  # (n,)
    gyr: np.ndarray  # (n, 3)
    acc: np.ndarray  # (n, 3)
    frame_ns: np.ndarray  # (F,) int64
    frame_t: np.ndarray  # (F,)
    images: np.ndarray  # (F, 2, H, W) uint8
    gt: np.ndarray  # (F, 8) [t, p(3), q_xyzw(4)], t as frame_t

    def events(self):
        """Yield ('imu', (t, gyr, acc)) and ('frames', (t, [img0, img1]))
        in timestamp order, IMU first at equal stamps; images as float32 in
        [0, 1] like a dataset reader's."""
        i = 0
        n_imu = len(self.imu_t)
        for k, t in enumerate(self.frame_t):
            while i < n_imu and self.imu_t[i] <= t + 1e-9:
                yield "imu", (self.imu_t[i], self.gyr[i], self.acc[i])
                i += 1
            yield "frames", (t, [im.astype(np.float32) / 255.0 for im in self.images[k]])


def render_sequence(
    duration: float = 5.0,
    frame_rate: float = 10.0,
    imu_rate: float = 200.0,
    width: int = 320,
    height: int = 240,
    baseline: float = 0.11,
    imu_noise: bool = True,
    n_points: int = 600,
    seed: int = 3,
    trajectory: str = "sinusoid",
    fx: float = 280.0,
    density: float = 22.0,
    scene_version: int = 2,
    traj_kwargs: dict | None = None,
) -> Sequence:
    """Render the dot-field sequence that ``generate`` writes for the same
    arguments (trajectory "sinusoid" or "circuit")."""
    imu = ImuParams()
    rng = np.random.default_rng(seed + 1)
    camera = dict(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                  height=height, model="radtan", dist_params=[-0.25, 0.06, 1e-4, -1e-4])
    cam_np = pinhole_np.NpCamera(
        fxfycxcy=np.array([fx, fx, width / 2, height / 2], np.float64),
        dist_params=np.array(camera["dist_params"], np.float64),
        width=int(width), height=int(height), model="radtan",
    )
    tk = dict(traj_kwargs or {})
    if trajectory == "circuit":
        traj = lambda t, g=9.81007: circuit_trajectory(t, g, **tk)  # noqa: E731
    else:
        traj = analytic_trajectory
    T_SC = np.array(
        [[-baseline / 2, 0, 0, 0, 0, 0, 1.0], [baseline / 2, 0, 0, 0, 0, 0, 1.0]]
    )

    t_imu = np.arange(0.0, duration, 1.0 / imu_rate)
    _, _, _, omega_S, f_S = traj(t_imu, imu.g)
    if imu_noise:
        f_S = f_S + rng.normal(0, imu.sigma_a * np.sqrt(imu_rate), f_S.shape)
        omega_S = omega_S + rng.normal(0, imu.sigma_g * np.sqrt(imu_rate), omega_S.shape)
    imu_ns = np.array([T0_NS + int(round(t * 1e9)) for t in t_imu], np.int64)

    if trajectory == "circuit":
        pts, bright, radius = make_circuit_scene(
            radius=tk.get("radius", 8.0), density=density, seed=seed,
            sectors=6 if scene_version >= 2 else 0)
    else:
        pts, bright, radius = make_scene(n_points, seed)
    t_frames = np.arange(0.3, duration, 1.0 / frame_rate)
    p, q, _, _, _ = traj(t_frames, imu.g)
    frame_ns = np.array([T0_NS + int(round(t * 1e9)) for t in t_frames], np.int64)
    images = np.zeros((len(t_frames), 2, height, width), np.uint8)
    for c in range(2):
        for i in range(len(t_frames)):
            T_WC = se3np.se3_multiply(np.concatenate([p[i], q[i]]), T_SC[c])
            img = render_image(cam_np, T_WC, pts, bright, radius, seed=i * 2 + c)
            images[i, c] = (img * 255).astype(np.uint8)
    to_s = lambda ns: (ns - T0_NS) * 1e-9  # noqa: E731
    frame_t = to_s(frame_ns)
    return Sequence(
        camera=camera, T_SC=T_SC, imu_ns=imu_ns, imu_t=to_s(imu_ns),
        gyr=omega_S, acc=f_S, frame_ns=frame_ns, frame_t=frame_t,
        images=images, gt=np.concatenate([frame_t[:, None], p, q], axis=1),
    )
