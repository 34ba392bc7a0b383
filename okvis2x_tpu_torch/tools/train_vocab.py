"""Train the hierarchical bag-of-words vocabulary offline (counterpart of
``tools/train_vocab.py``).

Corpus: descriptors that the port's detector and descriptor (704 keypoints,
2 octaves, 752x480, radtan) extract from renders of both scene families
(six circuit ceilings, four dot boxes) at random seeds, densities and
viewpoints below the scene, each with a random extraction direction.  The
tree is `bow.train_vocabulary_hier` (binary k-means on the fused match
kernel, `branch` words, then `leaf` words inside each).  Its initial centres
are the port's own seeded draw (C-H5): the same corpus gives another tree
than the JAX package's unless its permutation is injected.

Usage:
  python -m okvis2x_tpu_torch.tools.train_vocab [--n 120000] [--branch 64] [--leaf 64]
      [--out build/okvis2x_tpu_torch/artifacts/vocab_b64l64.npz] [--device cpu]

Runs on cuda:0 unless --device names another device.  The file is the one
the JAX package's `HierVocabulary.load` reads.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from okvis2x_tpu_torch import default_device, optim
from okvis2x_tpu_torch.cameras import pinhole_np
from okvis2x_tpu_torch.frontend import bow, descriptor, detector
from okvis2x_tpu_torch.io import synthetic

MAX_KEYPOINTS = 704


def collect_descriptors(n_target=120_000, width=752, height=480, seed=0, device="cpu",
                        verbose=True) -> torch.Tensor:
    """The first `n_target` valid packed descriptors ((n, 12) int32 on
    `device`) of views rendered until there are that many."""
    cam_np = pinhole_np.NpCamera(
        fxfycxcy=np.array([460.0, 460.0, width / 2, height / 2]),
        dist_params=np.array([-0.25, 0.06, 1e-4, -1e-4]), width=width, height=height,
        model="radtan")
    rng = np.random.default_rng(seed)
    scenes = [synthetic.make_circuit_scene(density=float(rng.uniform(14, 30)), seed=100 + s,
                                           z_lo=float(rng.uniform(2.5, 4.0)),
                                           z_hi=float(rng.uniform(5, 8))) for s in range(6)]
    scenes += [synthetic.make_scene(n_points=int(rng.uniform(400, 1200)), seed=200 + s)
               for s in range(4)]
    out, n, i = [], 0, 0
    t0 = time.time()
    while n < n_target:
        pts, b, r = scenes[i % len(scenes)]
        # a random viewpoint below the scene looking up (+z optical axis)
        center = pts.mean(0)
        pos = center + rng.uniform([-6, -6, -center[2] - 1], [6, 6, -center[2] + 0.5])
        yaw = rng.uniform(0, 2 * np.pi)
        q = np.array([0, 0, np.sin(yaw / 2), np.cos(yaw / 2)])
        img = torch.from_numpy(synthetic.render_image(cam_np, np.r_[pos, q], pts, b, r,
                                                      seed=1000 + i)).to(device)
        kp = detector.detect(img, max_keypoints=MAX_KEYPOINTS, octaves=2, cell=32, per_cell=8,
                             threshold=1e-7)
        ang = torch.full((MAX_KEYPOINTS,), float(rng.uniform(-3.14, 3.14)), dtype=torch.float32,
                         device=device)
        packed = descriptor.extract(img, kp.uv, ang, kp.level, kp.valid)
        out.append(packed[kp.valid])
        n += int(kp.valid.sum())
        i += 1
        if verbose and i % 25 == 0:
            print(f"  {i} views, {n} descriptors, {time.time() - t0:.0f}s", file=sys.stderr,
                  flush=True)
    return torch.cat(out)[:n_target]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(optim.ARTIFACTS / "vocab_b64l64.npz"))
    ap.add_argument("--n", type=int, default=120_000)
    ap.add_argument("--branch", type=int, default=64)
    ap.add_argument("--leaf", type=int, default=64)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args(argv)
    dev = default_device() if args.device is None else torch.device(args.device)

    t0 = time.perf_counter()
    desc = collect_descriptors(args.n, device=dev)
    t_collect = time.perf_counter() - t0
    print(f"corpus: {tuple(desc.shape)}", file=sys.stderr)
    t0 = time.perf_counter()
    vocab = bow.train_vocabulary_hier(desc, branch=args.branch, leaf=args.leaf, iters=8)
    words = bow.assign_packed(desc, None, vocab)  # waits for the training
    t_train = time.perf_counter() - t0
    print(f"trained in {t_train:.0f}s", file=sys.stderr)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    vocab.save(args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KB)")
    return dict(desc=desc, vocab=vocab, words=words, collect_s=t_collect, train_s=t_train,
                out=args.out)


if __name__ == "__main__":
    main()
