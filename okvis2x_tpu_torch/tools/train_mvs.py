"""Train the MvsNet multi-view depth and sigma model on synthetic renders
(counterpart of ``tools/train_mvs.py``).

Multi-view sets with analytic ground-truth depth: a reference view and S
source views at known relative poses (a sideways or vertical baseline of
0.08-0.35 m and a small yaw), rendered from dot-field scenes.  The pool is
rendered once without noise; each step draws a batch with a gain and sensor
noise of its own.  The loss is the Gaussian negative log-likelihood of the
depth; the cost volume and everything after it are float64, as the JAX
package computes them under x64 (C-H10), in the backward pass too.  After
training, held-out sets give the RMSE of the net and of the plane sweep and
the spread of the sigma-normalised errors, stored as the artifact's meta
with the net's hypotheses.

Usage:
  python -m okvis2x_tpu_torch.tools.train_mvs [--steps 900] [--pool 200]
      [--out build/okvis2x_tpu_torch/artifacts/mvs_net.npz] [--device cpu]

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
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.io import synthetic
from okvis2x_tpu_torch.models import mvs, mvs_net
from okvis2x_tpu_torch.tools.train_stereo import FX, camera, gaussian_nll

N_EVAL = 12


def make_scenes(rng):
    """Six circuit ceilings and six dot boxes of random densities."""
    scenes = [synthetic.make_circuit_scene(density=float(rng.uniform(16, 30)), seed=500 + s)
              for s in range(6)]
    return scenes + [synthetic.make_scene(n_points=int(rng.uniform(600, 1600)), seed=600 + s)
                     for s in range(6)]


def render_set(cam_np, rng, scenes, n_src, baseline_range=(0.08, 0.35)):
    """(ref (H, W), sources (S, H, W), T_sr (S, 4, 4) ref-cam -> src-cam,
    gt depth (H, W), T_sr as 7-vectors (S, 7)), float32, noise-free, from a
    random viewpoint."""
    pts, bright, rad = scenes[rng.integers(0, len(scenes))]
    center = pts.mean(0)
    pos = center + rng.uniform([-4, -4, -center[2] - 0.5], [4, 4, -center[2] + 1.0])
    yaw = rng.uniform(0, 2 * np.pi)
    q = np.array([0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
    T_WC0 = np.r_[pos, q]
    seed = int(rng.integers(0, 1 << 31))
    ref = synthetic.render_image(cam_np, T_WC0, pts, bright, rad, noise=0.0, seed=seed)
    depth = synthetic.render_depth(cam_np, T_WC0, pts)
    srcs, T_srs, T_sr7s = [], [], []
    for s in range(n_src):
        # the geometry the pipeline gives: previous keyframes nearby
        dp = rng.uniform(-1, 1, 3)
        dp = dp / np.linalg.norm(dp) * rng.uniform(*baseline_range)
        dyaw = rng.uniform(-0.06, 0.06)
        qy = np.array([0, 0, np.sin(dyaw / 2), np.cos(dyaw / 2)])
        T_WCs = se3np.se3_multiply(np.r_[pos + se3np.quat_to_matrix(q) @ dp, q],
                                   np.r_[np.zeros(3), qy])
        srcs.append(synthetic.render_image(cam_np, T_WCs, pts, bright, rad, noise=0.0,
                                           seed=seed + 7 + s))
        T_sr7 = se3np.se3_multiply(se3np.se3_inverse(T_WCs), T_WC0)
        M = np.eye(4)
        M[:3, :3] = se3np.quat_to_matrix(T_sr7[3:7])
        M[:3, 3] = T_sr7[:3]
        T_srs.append(M)
        T_sr7s.append(T_sr7)
    return (ref.astype(np.float32), np.stack(srcs).astype(np.float32),
            np.stack(T_srs).astype(np.float32), depth.astype(np.float32),
            np.stack(T_sr7s).astype(np.float32))


def make_pool(cam_np, rng, scenes, n, n_src):
    """n sets: (refs, sources, T_sr, gt depths), stacked."""
    sets = [render_set(cam_np, rng, scenes, n_src)[:4] for _ in range(n)]
    return tuple(np.stack(x) for x in zip(*sets))


def draw_batch(rng, pool, batch: int, noise: float):
    """A batch of the pool with a gain in [0.8, 1.15) and sensor noise on
    every view, clipped to [0, 1]."""
    pr, ps, pT, pg = pool
    H, W = pr.shape[1:]
    idx = rng.integers(0, len(pr), batch)
    gain = rng.uniform(0.8, 1.15, (batch, 1, 1)).astype(np.float32)
    nr = rng.normal(0, noise, (batch, H, W)).astype(np.float32)
    ns = rng.normal(0, noise, (batch, ps.shape[1], H, W)).astype(np.float32)
    return (np.clip(pr[idx] * gain + nr, 0, 1), np.clip(ps[idx] * gain[:, None] + ns, 0, 1),
            pT[idx], pg[idx])


def intrinsics(W: int, H: int) -> np.ndarray:
    return np.array([FX, FX, W / 2, H / 2], np.float32)


def loss(net, ref, srcs, T_sr, gt) -> torch.Tensor:
    """Mean over the batch of the depth NLL on d_min + 0.05 < gt <
    d_max - 0.2 (float64, as the depth the net returns)."""
    H, W = ref.shape[1:]
    k = torch.from_numpy(intrinsics(W, H)).to(ref.device)
    d_lo, d_hi = net.d_min + 0.05, net.d_max - 0.2
    per = []
    for r, s, T, g in zip(ref, srcs, T_sr, gt):
        depth, sigma = net(r, s, k, T)
        per.append(gaussian_nll(depth, sigma, g, (g > d_lo) & (g < d_hi)))
    return torch.stack(per).mean()


@torch.no_grad()
def evaluate(net, cam_np, scenes, n_src, noise, device) -> dict:
    """12 held-out noisy sets: depth RMSE of the net and of the plane sweep
    (48 hypotheses over the net's range), and the std of the
    sigma-normalised errors."""
    H, W = cam_np.height, cam_np.width
    k = torch.from_numpy(intrinsics(W, H)).to(device)
    K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], dtype=torch.float32,
                     device=device)
    eval_rng = np.random.default_rng(999)
    d_lo, d_hi = net.d_min + 0.05, net.d_max - 0.2
    err_net, err_ps, zs = [], [], []
    for _ in range(N_EVAL):
        ref, srcs, T_sr, g, T_sr7 = render_set(cam_np, eval_rng, scenes, n_src)
        ref = np.clip(ref + eval_rng.normal(0, noise, ref.shape), 0, 1).astype(np.float32)
        srcs = np.clip(srcs + eval_rng.normal(0, noise, srcs.shape), 0, 1).astype(np.float32)
        rt, st = torch.from_numpy(ref).to(device), torch.from_numpy(srcs).to(device)
        depth, sigma = (x.cpu().numpy() for x in net(rt, st, k, torch.from_numpy(T_sr).to(device)))
        # the plane sweep takes the pose of each source in the reference camera
        T7 = torch.from_numpy(np.stack([se3np.se3_inverse(t) for t in T_sr7])).to(device)
        sw = mvs.plane_sweep(rt, st, K, T7, min_depth=net.d_min, max_depth=net.d_max,
                             num_depths=48)
        swd, swv = sw.depth.cpu().numpy(), sw.valid.cpu().numpy()
        m = (g > d_lo) & (g < d_hi)
        if m.sum() == 0:
            continue
        err_net.append(np.sqrt(np.mean((depth[m] - g[m]) ** 2)))
        mp = m & swv
        if mp.sum():
            err_ps.append(np.sqrt(np.mean((swd[mp] - g[mp]) ** 2)))
        zs.append((depth[m] - g[m]) / np.maximum(sigma[m], 1e-3))
    z = np.concatenate(zs)
    return dict(rmse_net=float(np.mean(err_net)),
                rmse_plane_sweep=float(np.mean(err_ps)) if err_ps else float("nan"),
                sigma_z=float(z.std()))


def new_net() -> mvs_net.MvsNet:
    """A trainable MvsNet (32 hypotheses from 0.25 m to 8 m) with flax's
    initialisation drawn from seed 0."""
    return optim.flax_init_(mvs_net.MvsNet(), torch.Generator().manual_seed(0))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(optim.ARTIFACTS / "mvs_net.npz"))
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--pool", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--n-src", type=int, default=2)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--noise", type=float, default=0.06)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args(argv)
    dev = default_device() if args.device is None else torch.device(args.device)

    cam_np = camera(args.height, args.width)
    rng = np.random.default_rng(0)
    scenes = make_scenes(rng)
    net = new_net().to(dev)
    t0 = time.time()
    pool = make_pool(cam_np, rng, scenes, args.pool, args.n_src)
    print(f"rendered pool of {args.pool} sets in {time.time() - t0:.0f}s", file=sys.stderr,
          flush=True)

    def next_batch():
        return tuple(torch.from_numpy(x).to(dev)
                     for x in draw_batch(rng, pool, args.batch, args.noise))

    losses, secs = optim.train(net, loss, next_batch, args.steps, args.lr)
    net.eval()
    meta = evaluate(net, cam_np, scenes, args.n_src, args.noise, dev)
    print(f"held-out depth RMSE: net {meta['rmse_net']:.3f} m vs plane-sweep "
          f"{meta['rmse_plane_sweep']:.3f} m; sigma z-score std {meta['sigma_z']:.2f} "
          "(1.0 = calibrated)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    convert.save_artifact(args.out, net.state_dict(), **meta, n_src=args.n_src,
                          n_depths=net.n_depths, d_min=net.d_min, d_max=net.d_max)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KB)")
    return dict(losses=losses, step_s=secs, out=args.out, meta=meta)


if __name__ == "__main__":
    main()
