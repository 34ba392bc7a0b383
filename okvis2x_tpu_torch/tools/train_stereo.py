"""Train the StereoNet disparity and sigma model on synthetic renders
(counterpart of ``tools/train_stereo.py``).

Stereo pairs with analytic ground-truth disparity: dot-field scenes (six
circuit ceilings, six dot boxes) rendered from random viewpoints with a
horizontal baseline.  The pool is rendered once without noise; each step
draws a batch with a gain and sensor noise of its own.  The loss is the
Gaussian negative log-likelihood of the disparity, which calibrates the
sigma head jointly.  After training, held-out pairs give the RMSE of the net
and of census stereo and the spread of the sigma-normalised errors, stored
as the artifact's meta.

Usage:
  python -m okvis2x_tpu_torch.tools.train_stereo [--steps 1200] [--pool 320]
      [--out build/okvis2x_tpu_torch/artifacts/stereo_net.npz] [--device cpu]

Runs on cuda:0 unless --device names another device.  The artifact is the
JAX package's flat npz; the initial weights are the port's own draw of
flax's initialiser (C-H16).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from okvis2x_tpu_torch import convert, default_device, optim
from okvis2x_tpu_torch.cameras import pinhole_np
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.io import synthetic
from okvis2x_tpu_torch.models import stereo, stereo_net

FX = 230.0
BASELINE = 0.11
MAX_DISP = 64
N_EVAL = 16


def camera(H: int, W: int) -> pinhole_np.NpCamera:
    return pinhole_np.NpCamera(fxfycxcy=np.array([FX, FX, W / 2, H / 2]),
                               dist_params=np.zeros(4), width=W, height=H, model="radtan")


def make_scenes(rng):
    """Six circuit ceilings and six dot boxes of random densities."""
    scenes = [synthetic.make_circuit_scene(density=float(rng.uniform(16, 30)), seed=300 + s)
              for s in range(6)]
    return scenes + [synthetic.make_scene(n_points=int(rng.uniform(500, 1400)), seed=400 + s)
                     for s in range(6)]


def _views(rng, scenes, baseline):
    """A random scene and left/right poses looking up at it."""
    pts, bright, rad = scenes[rng.integers(0, len(scenes))]
    center = pts.mean(0)
    pos = center + rng.uniform([-5, -5, -center[2] - 0.5], [5, 5, -center[2] + 1.0])
    yaw = rng.uniform(0, 2 * np.pi)
    q = np.array([0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
    dx_W = se3np.quat_to_matrix(q) @ np.array([baseline, 0, 0])  # along camera +x
    return (pts, bright, rad), np.r_[pos, q], np.r_[pos + dx_W, q], int(rng.integers(0, 1 << 31))


def _disparity(cam_np, T_WC0, pts):
    depth = synthetic.render_depth(cam_np, T_WC0, pts)
    return np.where(depth > 0.1, FX * BASELINE / np.maximum(depth, 0.1), 0.0)


def make_pair(cam_np, rng, scenes):
    """(left, right, gt_disp) float32 from a random viewpoint, with sensor
    noise of 0.06."""
    (pts, bright, rad), T0, T1, seed = _views(rng, scenes, BASELINE)
    left = synthetic.render_image(cam_np, T0, pts, bright, rad, seed=seed)
    right = synthetic.render_image(cam_np, T1, pts, bright, rad, seed=seed)
    left = np.clip(left + rng.normal(0, 0.06, left.shape), 0, 1)
    right = np.clip(right + rng.normal(0, 0.06, right.shape), 0, 1)
    return (left.astype(np.float32), right.astype(np.float32),
            _disparity(cam_np, T0, pts).astype(np.float32))


def make_pool(cam_np, rng, scenes, n):
    """n noise-free pairs (left, right, gt_disp), each (n, H, W) float32."""
    ls, rs, gs = [], [], []
    for _ in range(n):
        (pts, bright, rad), T0, T1, seed = _views(rng, scenes, BASELINE)
        ls.append(synthetic.render_image(cam_np, T0, pts, bright, rad, noise=0.0, seed=seed))
        rs.append(synthetic.render_image(cam_np, T1, pts, bright, rad, noise=0.0, seed=seed))
        gs.append(_disparity(cam_np, T0, pts))
    return tuple(np.stack(x).astype(np.float32) for x in (ls, rs, gs))


def draw_batch(rng, pool, batch: int):
    """A batch of the pool with a gain in [0.8, 1.15) and sensor noise of
    0.06 on each image, clipped to [0, 1]."""
    pl, pr, pg = pool
    H, W = pl.shape[1:]
    idx = rng.integers(0, len(pl), batch)
    gain = rng.uniform(0.8, 1.15, (batch, 1, 1)).astype(np.float32)
    nl = rng.normal(0, 0.06, (batch, H, W)).astype(np.float32)
    nr = rng.normal(0, 0.06, (batch, H, W)).astype(np.float32)
    return np.clip(pl[idx] * gain + nl, 0, 1), np.clip(pr[idx] * gain + nr, 0, 1), pg[idx]


def gaussian_nll(pred, sigma, gt, valid) -> torch.Tensor:
    """Mean of e^2 / (2 sigma^2) + log sigma over the valid pixels."""
    e = pred - gt
    nll = (e * e) / (2.0 * sigma * sigma) + torch.log(sigma)
    v = valid.to(nll.dtype)
    return (nll * v).sum() / torch.clamp(v.sum(), min=1.0)


def loss(net, left: torch.Tensor, right: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the disparity NLL on 0.5 < gt < max_disp - 1."""
    per = []
    for l, r, g in zip(left, right, gt):
        disp, sigma = net(l, r)
        per.append(gaussian_nll(disp, sigma, g, (g > 0.5) & (g < net.max_disp - 1)))
    return torch.stack(per).mean()


@torch.no_grad()
def evaluate(net, cam_np, scenes, device) -> dict:
    """16 held-out noisy pairs: disparity RMSE of the net and of census on
    0.5 < gt < 63, and the std of the sigma-normalised errors."""
    eval_rng = np.random.default_rng(999)
    err_net, err_cen, zs = [], [], []
    for _ in range(N_EVAL):
        l, r, g = make_pair(cam_np, eval_rng, scenes)
        lt, rt = torch.from_numpy(l).to(device), torch.from_numpy(r).to(device)
        disp, sigma = (x.cpu().numpy() for x in net(lt, rt))
        dc, _, vc = (x.cpu().numpy() for x in stereo.census_stereo(lt, rt, max_disp=MAX_DISP))
        m = (g > 0.5) & (g < 63)
        if m.sum() == 0:
            continue
        err_net.append(np.sqrt(np.mean((disp[m] - g[m]) ** 2)))
        mc = m & vc
        if mc.sum():
            err_cen.append(np.sqrt(np.mean((dc[mc] - g[mc]) ** 2)))
        zs.append((disp[m] - g[m]) / np.maximum(sigma[m], 1e-3))
    z = np.concatenate(zs)
    return dict(rmse_net=float(np.mean(err_net)),
                rmse_census=float(np.mean(err_cen)) if err_cen else float("nan"),
                sigma_z=float(z.std()))


def new_net() -> stereo_net.StereoNet:
    """A trainable StereoNet with flax's initialisation drawn from seed 0."""
    return optim.flax_init_(stereo_net.StereoNet(MAX_DISP), torch.Generator().manual_seed(0))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(optim.ARTIFACTS / "stereo_net.npz"))
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--pool", type=int, default=320)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args(argv)
    dev = default_device() if args.device is None else torch.device(args.device)

    cam_np = camera(args.height, args.width)
    rng = np.random.default_rng(0)
    scenes = make_scenes(rng)
    net = new_net().to(dev)
    t0 = time.time()
    pool = make_pool(cam_np, rng, scenes, args.pool)
    print(f"rendered pool of {args.pool} pairs in {time.time() - t0:.0f}s", file=sys.stderr,
          flush=True)

    def next_batch():
        return tuple(torch.from_numpy(x).to(dev) for x in draw_batch(rng, pool, args.batch))

    losses, secs = optim.train(net, loss, next_batch, args.steps, args.lr)
    net.eval()
    meta = evaluate(net, cam_np, scenes, dev)
    print(f"held-out disparity RMSE: net {meta['rmse_net']:.3f} px vs census "
          f"{meta['rmse_census']:.3f} px; sigma z-score std {meta['sigma_z']:.2f} "
          "(1.0 = calibrated)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    convert.save_artifact(args.out, net.state_dict(), **meta)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KB)")
    return dict(losses=losses, step_s=secs, out=args.out, meta=meta)


if __name__ == "__main__":
    main()
