#!/usr/bin/env python3
"""Continuous-time spline fitting experiment in the PyTorch port (the
counterpart of scripts/fit_spline.py).

Fit a cumulative cubic B-spline trajectory to a sequence's ground-truth
poses (TUM groundtruth.txt or a synthetic trajectory), optionally tightening
against accelerometer residuals, and report and plot the interpolation
error.

    python scripts/fit_spline_torch.py                       # synthetic demo, CUDA
    python scripts/fit_spline_torch.py --device cpu --tum /data/fr1_desk
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tum", type=str, default=None)
    ap.add_argument("--interval", type=float, default=0.4)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", type=str, default="/tmp/spline_fit.png")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises where there is none)")
    args = ap.parse_args(argv)

    import torch

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.core.transforms import so3_exp
    from gslam_tpu_torch.eval.spline import (
        fit_spline, init_spline, rot_cps_from_quats, seed_from_poses, spline_pose,
    )

    dev = resolve_device(args.device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    accel_times = accel = None
    if args.tum:
        gt = np.loadtxt(f"{args.tum}/groundtruth.txt", comments="#")
        times = f32(gt[:, 0] - gt[0, 0])
        pos = f32(gt[:, 1:4])
        q_xyzw = gt[:, 4:8]
        rot = rot_cps_from_quats(f32(np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], 1)))
        try:
            acc = np.loadtxt(f"{args.tum}/accelerometer.txt", comments="#")
            accel_times = f32(acc[:, 0] - gt[0, 0])
            accel = f32(acc[:, 1:4])
        except OSError:
            pass
    else:
        times = f32(np.linspace(0, 10, 120, dtype=np.float32))
        pos = torch.stack([torch.sin(times), torch.cos(0.7 * times), 0.1 * times], -1)
        w = torch.stack([0.2 * times, 0.1 * torch.sin(times), torch.zeros_like(times)], -1)
        rot = so3_exp(w)

    n_cps = int(float(times[-1]) / args.interval) + 4
    sp = init_spline(n_cps, args.interval, float(times[0]), device=dev)
    sp = seed_from_poses(sp, times, rot, pos)
    sp, losses = fit_spline(sp, times, rot, pos, accel_times=accel_times,
                            accel_meas=accel, n_steps=args.steps)
    print(f"fit loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f} "
          f"({n_cps} control points, dt={args.interval}s)")

    _, p = spline_pose(sp, times)
    pn, gn = p.cpu().numpy(), pos.cpu().numpy()
    err = np.linalg.norm(pn - gn, axis=-1)
    print(f"interpolation error: mean {err.mean() * 100:.2f} cm, "
          f"max {err.max() * 100:.2f} cm")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gn[:, 0], gn[:, 1], label="gt")
    ax.plot(pn[:, 0], pn[:, 1], "--", label="spline")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(args.out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    print(f"plot: {args.out}")
    return dict(losses=losses.cpu().numpy(), err=err, n_cps=n_cps)


if __name__ == "__main__":
    main()
