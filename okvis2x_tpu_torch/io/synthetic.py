"""Synthetic stereo-inertial datasets (numpy).

Counterpart of the dot-field part of ``okvis2x_tpu/io/synthetic.py``: the
same analytic trajectories, scenes, splat renderer and IMU noise.
`render_sequence` yields in memory exactly the IMU samples, ground truth and
uint8 stereo images that `generate` writes in the EuRoC layout (PNGs by the
port's codec), and `generate` writes what ``okvis2x_tpu.io.synthetic.
generate`` writes for the same arguments.  The textured world and its class
maps wait for the segmentation item (A4 in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from okvis2x_tpu_torch.cameras import pinhole, pinhole_np
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.imu.preintegration import ImuParams
from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.io.xdataset import GNSS_LEAP_NS

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


def render_depth(cam, T_WC, pts, r: int = 4):
    """Depth image matching `render_image`'s splats: each dot's splat window
    is filled with its camera-frame z; elsewhere 0 (invalid)."""
    cam_np = cam if isinstance(cam, pinhole_np.NpCamera) else pinhole_np.to_numpy(cam)
    H, W = cam_np.height, cam_np.width
    p_C = se3np.se3_apply(se3np.se3_inverse(np.asarray(T_WC, np.float64)),
                          np.asarray(pts, np.float64))
    uv, valid = pinhole_np.project(cam_np, p_C)
    valid = valid & (p_C[:, 2] > 0.3)
    depth = np.zeros((H, W), np.float32)
    for i in np.argsort(-p_C[:, 2]):  # near dots overwrite far ones
        if not valid[i]:
            continue
        cx, cy = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if not (r <= cx < W - r and r <= cy < H - r):
            continue
        depth[cy - r:cy + r + 1, cx - r:cx + r + 1] = p_C[i, 2]
    return depth


class _Scene:
    """What one set of generator arguments fixes: camera, trajectory,
    extrinsics, IMU stream (noise drawn from `rng`, which the GPS noise
    continues) and the dots."""

    def __init__(self, duration, frame_rate, imu_rate, width, height, baseline, imu_noise,
                 n_points, seed, trajectory, fx, density, scene_version, traj_kwargs):
        self.imu = ImuParams()
        self.rng = np.random.default_rng(seed + 1)
        self.camera = dict(fx=fx, fy=fx, cx=width / 2, cy=height / 2, width=width,
                           height=height, model="radtan",
                           dist_params=[-0.25, 0.06, 1e-4, -1e-4])
        self.cam_np = pinhole_np.NpCamera(
            fxfycxcy=np.array([fx, fx, width / 2, height / 2], np.float64),
            dist_params=np.array(self.camera["dist_params"], np.float64),
            width=int(width), height=int(height), model="radtan",
        )
        tk = dict(traj_kwargs or {})
        if trajectory == "circuit":
            self.traj = lambda t, g=9.81007: circuit_trajectory(t, g, **tk)  # noqa: E731
        else:
            self.traj = analytic_trajectory
        self.T_SC = np.array(
            [[-baseline / 2, 0, 0, 0, 0, 0, 1.0], [baseline / 2, 0, 0, 0, 0, 0, 1.0]])

        t_imu = np.arange(0.0, duration, 1.0 / imu_rate)
        _, _, _, omega_S, f_S = self.traj(t_imu, self.imu.g)
        if imu_noise:
            f_S = f_S + self.rng.normal(0, self.imu.sigma_a * np.sqrt(imu_rate), f_S.shape)
            omega_S = omega_S + self.rng.normal(0, self.imu.sigma_g * np.sqrt(imu_rate),
                                                omega_S.shape)
        self.gyr, self.acc = omega_S, f_S
        self.imu_ns = np.array([T0_NS + int(round(t * 1e9)) for t in t_imu], np.int64)

        if trajectory == "circuit":
            self.pts, self.bright, self.radius = make_circuit_scene(
                radius=tk.get("radius", 8.0), density=density, seed=seed,
                sectors=6 if scene_version >= 2 else 0)
        else:
            self.pts, self.bright, self.radius = make_scene(n_points, seed)
        self.t_frames = np.arange(0.3, duration, 1.0 / frame_rate)
        self.p, self.q, self.v, _, _ = self.traj(self.t_frames, self.imu.g)
        self.frame_ns = np.array([T0_NS + int(round(t * 1e9)) for t in self.t_frames],
                                 np.int64)

    def T_WC(self, i, c):
        return se3np.se3_multiply(np.concatenate([self.p[i], self.q[i]]), self.T_SC[c])

    def image(self, i, c):
        """Frame i of camera c as uint8."""
        img = render_image(self.cam_np, self.T_WC(i, c), self.pts, self.bright, self.radius,
                           seed=i * 2 + c)
        return (img * 255).astype(np.uint8)


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
    """Render the dot-field sequence that `generate` writes for the same
    arguments (trajectory "sinusoid" or "circuit")."""
    sc = _Scene(duration, frame_rate, imu_rate, width, height, baseline, imu_noise, n_points,
                seed, trajectory, fx, density, scene_version, traj_kwargs)
    images = np.zeros((len(sc.t_frames), 2, height, width), np.uint8)
    for c in range(2):
        for i in range(len(sc.t_frames)):
            images[i, c] = sc.image(i, c)
    to_s = lambda ns: (ns - T0_NS) * 1e-9  # noqa: E731
    frame_t = to_s(sc.frame_ns)
    return Sequence(
        camera=sc.camera, T_SC=sc.T_SC, imu_ns=sc.imu_ns, imu_t=to_s(sc.imu_ns),
        gyr=sc.gyr, acc=sc.acc, frame_ns=sc.frame_ns, frame_t=frame_t,
        images=images, gt=np.concatenate([frame_t[:, None], sc.p, sc.q], axis=1),
    )


def generate(
    out_dir: str,
    duration: float = 5.0,
    frame_rate: float = 10.0,
    imu_rate: float = 200.0,
    width: int = 320,
    height: int = 240,
    baseline: float = 0.11,
    imu_noise: bool = True,
    n_points: int = 600,
    seed: int = 3,
    with_gps: bool = False,
    with_lidar: bool = False,
    with_depth: bool = False,
    gps_rate: float = 5.0,
    scene_version: int = 2,
    gps_sigma: float = 0.05,
    trajectory: str = "sinusoid",
    fx: float = 280.0,
    density: float = 22.0,
    progress: bool = False,
    traj_kwargs: dict | None = None,
    world: str = "dots",
    world_kwargs: dict | None = None,
    with_classmap: bool = False,
):
    """Write a synthetic stereo-inertial dataset in the EuRoC layout under
    `out_dir`; returns (camera, T_SC (2, 7), ground truth [t, p, q]).  The
    files are those ``okvis2x_tpu.io.synthetic.generate`` writes for the same
    arguments (PNGs that decode to the same pixels)."""
    if world != "dots" or with_classmap:
        raise NotImplementedError("the textured world and its class maps are not ported yet "
                                  "(the segmentation item, A5 in ROADMAP.md)")
    sc = _Scene(duration, frame_rate, imu_rate, width, height, baseline, imu_noise, n_points,
                seed, trajectory, fx, density, scene_version, traj_kwargs)
    root = os.path.join(out_dir, "mav0")
    os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for ns, g, a in zip(sc.imu_ns, sc.gyr, sc.acc):
            f.write(f"{ns},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")

    for c in range(2):
        os.makedirs(os.path.join(root, f"cam{c}", "data"), exist_ok=True)
        with open(os.path.join(root, f"cam{c}", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, ns in enumerate(sc.frame_ns):
                name = f"{ns}.png"
                png.write(os.path.join(root, f"cam{c}", "data", name), sc.image(i, c), level=1)
                f.write(f"{ns},{name}\n")
                if progress and i % 200 == 0:
                    print(f"  cam{c}: {i}/{len(sc.frame_ns)} frames rendered", flush=True)

    # cam0-registered depth stream (depth0/, 16-bit PNG millimetres)
    if with_depth:
        os.makedirs(os.path.join(root, "depth0", "data"), exist_ok=True)
        with open(os.path.join(root, "depth0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, ns in enumerate(sc.frame_ns):
                dimg = render_depth(sc.cam_np, sc.T_WC(i, 0), sc.pts)
                name = f"{ns}.png"
                png.write(os.path.join(root, "depth0", "data", name),
                          np.clip(dimg * 1000.0, 0, 65535).astype(np.uint16))
                f.write(f"{ns},{name}\n")

    p, q, v = sc.p, sc.q, sc.v
    os.makedirs(os.path.join(root, "state_groundtruth_estimate0"), exist_ok=True)
    with open(os.path.join(root, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz,vx,vy,vz,bgx,bgy,bgz,bax,bay,baz\n")
        for i, ns in enumerate(sc.frame_ns):
            f.write(f"{ns},{p[i,0]},{p[i,1]},{p[i,2]},"
                    f"{q[i,3]},{q[i,0]},{q[i,1]},{q[i,2]},"
                    f"{v[i,0]},{v[i,1]},{v[i,2]},0,0,0,0,0,0\n")

    # GNSS stream (cartesian, in a shifted and yawed G frame)
    if with_gps:
        t_gps = np.arange(0.05, duration, 1.0 / gps_rate)
        pg, _, _, _, _ = sc.traj(t_gps)
        yaw_g = 0.4
        Rg = np.array([[np.cos(yaw_g), -np.sin(yaw_g), 0],
                       [np.sin(yaw_g), np.cos(yaw_g), 0], [0, 0, 1.0]])
        t_G = np.array([30.0, -12.0, 4.0])
        pos_G = pg @ Rg.T + t_G + sc.rng.normal(0, gps_sigma, (len(t_gps), 3))
        os.makedirs(os.path.join(root, "gps0"), exist_ok=True)
        with open(os.path.join(root, "gps0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],x,y,z,err_x,err_y,err_z\n")
            for i, t in enumerate(t_gps):
                ns = T0_NS + int(round(t * 1e9)) + GNSS_LEAP_NS
                f.write(f"{ns},{pos_G[i,0]},{pos_G[i,1]},{pos_G[i,2]},"
                        f"{gps_sigma},{gps_sigma},{gps_sigma}\n")

    # LiDAR stream: rays to the first 120 scene dots (one point a line)
    if with_lidar:
        os.makedirs(os.path.join(root, "lidar0"), exist_ok=True)
        with open(os.path.join(root, "lidar0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],x,y,z,intensity\n")
            for ts in np.arange(0.3, duration, 0.1):
                ps, qs, _, _, _ = sc.traj(np.array([ts]))
                T_SW = se3np.se3_inverse(np.concatenate([ps[0], qs[0]]))
                p_S = se3np.se3_apply(T_SW, sc.pts[:120])
                keep = np.linalg.norm(p_S, axis=-1) < 15.0
                for k, pt_S in enumerate(p_S):
                    if not keep[k]:
                        continue
                    ns = T0_NS + int(round((ts + k * 1e-4) * 1e9))
                    f.write(f"{ns},{pt_S[0]:.4f},{pt_S[1]:.4f},{pt_S[2]:.4f},1.0\n")

    cam = pinhole.make_pinhole(fx, fx, width / 2, height / 2, width, height, model="radtan",
                               dist_params=sc.camera["dist_params"])
    return cam, sc.T_SC, np.concatenate([sc.t_frames[:, None], p, q], axis=1)
