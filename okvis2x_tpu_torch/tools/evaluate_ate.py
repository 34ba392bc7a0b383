"""ATE/RPE regression harness (evo-style) over TUM trajectories
(counterpart of ``tools/evaluate_ate.py``).

The reference repo evaluates accuracy externally (tools/convert_to_tum.py →
evo); this harness closes that gap.

Usage:
  python -m okvis2x_tpu_torch.tools.evaluate_ate EST.tum GT.tum [--scale]
      [--max-dt 0.02] [--rpe-delta 1] [--bound 0.15]

Prints one JSON dict with ate/rpe statistics; exits 2 when too few poses
associate, 1 when --bound is given and the ATE RMSE exceeds it (CI
regression gate), else 0.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("est", help="estimated trajectory (TUM: t x y z qx qy qz qw)")
    ap.add_argument("gt", help="ground-truth trajectory (TUM)")
    ap.add_argument("--scale", action="store_true", help="Sim(3) alignment")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--rpe-delta", type=int, default=1)
    ap.add_argument("--bound", type=float, default=None,
                    help="fail (exit 1) if ATE RMSE exceeds this bound [m]")
    args = ap.parse_args(argv)

    from okvis2x_tpu_torch.io import trajectory_io as tio

    t_e, T_e = tio.read_tum(args.est)
    t_g, T_g = tio.read_tum(args.gt)
    ate = tio.ate_stats(t_e, T_e[:, :3], t_g, T_g[:, :3],
                        with_scale=args.scale, max_dt=args.max_dt)
    rpe = tio.rpe_stats(t_e, T_e, t_g, T_g, delta=args.rpe_delta, max_dt=args.max_dt)
    out = {"ate": ate, "rpe": rpe, "est": args.est, "gt": args.gt}
    print(json.dumps(out))
    if ate is None:
        print("error: too few associated poses", file=sys.stderr)
        return 2
    if args.bound is not None and ate["rmse"] > args.bound:
        print(f"ATE RMSE {ate['rmse']:.4f} m exceeds bound {args.bound} m", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
