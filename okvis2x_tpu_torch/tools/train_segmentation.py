"""Train the FastSCNN keypoint classifier on the textured world
(counterpart of ``tools/train_segmentation.py``).

The renderer (``io/synthetic.py::render_textured``) emits exact per-pixel
class maps: static structure, drifting-cloud sky and moving distractor
clusters, mapped onto the Cityscapes ids the classifier uses (static -> 0,
sky -> 10 SKY, distractor -> 11 PERSON).  The pool comes from four textured
worlds at random circuit viewpoints and times; each step draws a batch with
a gain and sensor noise of its own.  The loss is the class-weighted negative
log-likelihood (distractor pixels are about 0.1% of an image and weigh 40).
After training, a held-out world gives the per-class IoU and the keypoint
downweighting's recall and false alarms against the sky heuristic, stored
as the artifact's meta.

Usage:
  python -m okvis2x_tpu_torch.tools.train_segmentation [--steps 600] [--pool 160]
      [--out build/okvis2x_tpu_torch/artifacts/fast_scnn.npz] [--device cpu]

Runs on cuda:0 unless --device names another device.  The artifact is the
JAX package's flat npz, which both packages' `load_params` read; the
initial weights are the port's own draw of flax's initialiser (C-H16).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from okvis2x_tpu_torch import convert, default_device, optim
from okvis2x_tpu_torch.cameras import pinhole_np
from okvis2x_tpu_torch.io import synthetic
from okvis2x_tpu_torch.models import segmentation as seg

CLS_MAP = {0: 0, 1: 10, 2: 11}  # renderer class -> Cityscapes id
N_WORLDS = 4
N_EVAL = 16
EVAL_KEYPOINTS = 300


def camera(H: int, W: int) -> pinhole_np.NpCamera:
    return pinhole_np.NpCamera(
        fxfycxcy=np.array([230.0, 230.0, W / 2, H / 2]),
        dist_params=np.array([-0.25, 0.06, 1e-4, -1e-4]), width=W, height=H, model="radtan")


def render_pool(cam_np, world, rng, n, traj_span=180.0):
    """n rendered (img, cls) pairs from random circuit viewpoints and
    times, the position jittered off the trajectory."""
    ims, cls = [], []
    for k in range(n):
        t = float(rng.uniform(0, traj_span))
        p, q, _, _, _ = synthetic.circuit_trajectory(np.array([t]))
        pos = p[0] + rng.uniform(-0.5, 0.5, 3)
        img, c = synthetic.render_textured(cam_np, np.r_[pos, q[0]], world, t, seed=k,
                                           with_classes=True)
        ims.append(img)
        cls.append(c)
    return np.stack(ims), np.stack(cls)


def make_pool(cam_np, rng, pool: int):
    """`pool` frames (pool // 4 from each of four worlds) and their labels
    as Cityscapes ids."""
    worlds = [synthetic.make_textured_world(seed=700 + s, n_distractors=7)
              for s in range(N_WORLDS)]
    per = pool // len(worlds)
    ims, cls = zip(*[render_pool(cam_np, w, rng, per) for w in worlds])
    ims, cls = np.concatenate(ims), np.concatenate(cls)
    cs = np.zeros_like(cls)
    for k, v in CLS_MAP.items():
        cs[cls == k] = v
    return ims, cs


def class_weights() -> np.ndarray:
    """Per-class NLL weights: distractors (PERSON) 40, every other class 1."""
    w = np.ones(seg.NUM_CLASSES, np.float32)
    w[seg.PERSON] = 40.0
    return w


def draw_batch(rng, ims, cs, batch: int):
    """A batch of the pool with a gain in [0.85, 1.1) and sensor noise of
    0.03, clipped to [0, 1]: (img (B, H, W) float32, labels (B, H, W)
    int64)."""
    idx = rng.integers(0, len(ims), batch)
    gain = rng.uniform(0.85, 1.1, (batch, 1, 1)).astype(np.float32)
    noise = rng.normal(0, 0.03, (batch,) + ims.shape[1:]).astype(np.float32)
    return np.clip(ims[idx] * gain + noise, 0, 1), cs[idx].astype(np.int64)


def loss(net, img: torch.Tensor, lab: torch.Tensor, wtab: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of each image's class-weighted NLL, normalised by
    its summed weights."""
    ll = F.log_softmax(net(img), dim=-1)
    nll = -torch.gather(ll, -1, lab[..., None])[..., 0]
    w = wtab[lab]
    return ((nll * w).sum((1, 2)) / w.sum((1, 2))).mean()


@torch.no_grad()
def evaluate(net, cam_np, device) -> dict:
    """Held-out world (seed 901): IoU of static, sky and distractor, and the
    keypoint downweighting of 300 random keypoints a frame (recall of the
    bad ones, false alarms on the good ones) by the net and the heuristic."""
    eval_rng = np.random.default_rng(999)
    ew = synthetic.make_textured_world(seed=901, n_distractors=7)
    ei, ec = render_pool(cam_np, ew, eval_rng, N_EVAL)
    inter, union = np.zeros(3), np.zeros(3)
    hits = dict(net_hit=0, net_fa=0, heu_hit=0, heu_fa=0, bad=0, good=0)
    for im, c in zip(ei, ec):
        img = torch.from_numpy(im).to(device)
        logits = net(img)
        pred = torch.argmax(logits, dim=-1).cpu().numpy()
        pm = np.zeros_like(pred)
        pm[pred == seg.SKY] = 1
        pm[pred == seg.PERSON] = 2
        for k in range(3):
            inter[k] += np.sum((pm == k) & (c == k))
            union[k] += np.sum((pm == k) | (c == k))
        ys = eval_rng.integers(8, im.shape[0] - 8, EVAL_KEYPOINTS)
        xs = eval_rng.integers(8, im.shape[1] - 8, EVAL_KEYPOINTS)
        uv = torch.from_numpy(np.stack([xs, ys], -1).astype(np.float64)).to(device)
        bad = c[ys, xs] != 0
        w_net = seg.keypoint_weights_from_classes(seg.sample_classes(logits, uv)).cpu().numpy()
        w_heu = seg.sky_heuristic_weights(img, uv).cpu().numpy()
        hits["net_hit"] += int(np.sum((w_net > 1.5) & bad))
        hits["net_fa"] += int(np.sum((w_net > 1.5) & ~bad))
        hits["heu_hit"] += int(np.sum((w_heu > 1.5) & bad))
        hits["heu_fa"] += int(np.sum((w_heu > 1.5) & ~bad))
        hits["bad"] += int(bad.sum())
        hits["good"] += int((~bad).sum())
    iou = inter / np.maximum(union, 1)
    bad, good = max(hits["bad"], 1), max(hits["good"], 1)
    return dict(iou_static=iou[0], iou_sky=iou[1], iou_distractor=iou[2],
                kp_recall_net=hits["net_hit"] / bad, kp_recall_heuristic=hits["heu_hit"] / bad,
                kp_falsealarm_net=hits["net_fa"] / good,
                kp_falsealarm_heuristic=hits["heu_fa"] / good)


def new_net() -> seg.FastSCNN:
    """A trainable FastSCNN with flax's initialisation drawn from seed 0."""
    return optim.flax_init_(seg.FastSCNN(), torch.Generator().manual_seed(0))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(optim.ARTIFACTS / "fast_scnn.npz"))
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--pool", type=int, default=160)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=376)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args(argv)
    dev = default_device() if args.device is None else torch.device(args.device)

    cam_np = camera(args.height, args.width)
    rng = np.random.default_rng(0)
    t0 = time.time()
    ims, cs = make_pool(cam_np, rng, args.pool)
    print(f"rendered pool of {len(ims)} frames in {time.time() - t0:.0f}s; class px: static "
          f"{np.mean(cs == 0):.2f} sky {np.mean(cs == seg.SKY):.2f} distractor "
          f"{np.mean(cs == seg.PERSON) * 100:.2f}%", file=sys.stderr, flush=True)

    net = new_net().to(dev)
    wtab = torch.from_numpy(class_weights()).to(dev)

    def next_batch():
        img, lab = draw_batch(rng, ims, cs, args.batch)
        return torch.from_numpy(img).to(dev), torch.from_numpy(lab).to(dev), wtab

    losses, secs = optim.train(net, loss, next_batch, args.steps, args.lr)
    net.eval()
    meta = evaluate(net, cam_np, dev)
    print(f"held-out IoU: static {meta['iou_static']:.3f} sky {meta['iou_sky']:.3f} "
          f"distractor {meta['iou_distractor']:.3f}")
    print(f"keypoint downweight recall/false-alarm: net {meta['kp_recall_net']:.3f}/"
          f"{meta['kp_falsealarm_net']:.3f} vs heuristic {meta['kp_recall_heuristic']:.3f}/"
          f"{meta['kp_falsealarm_heuristic']:.3f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    convert.save_artifact(args.out, net.state_dict(), **meta)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KB)")
    return dict(losses=losses, step_s=secs, out=args.out, meta=meta)


if __name__ == "__main__":
    main()
