#!/usr/bin/env python3
"""Isolating study of tracking at realistic motion, in the PyTorch port
(the counterpart of scripts/study_tracking.py; docs/TRACKING_STUDY.md has
the questions and the JAX package's answers).

  oracle      — track every frame against the dataset's ground-truth splat
                scene (synthetic only): any error is pure tracker error.
                `--prior gt` uses the gt constant-motion prior (single-
                frame convergence, no compounding); `--prior est` chains
                the tracker's own estimates (compounding included).
  mono / rgbd — the full fused SLAM loop (map built online), monocular or
                RGB-D; isolates map-quality effects by comparison with
                oracle at the same motion.

Usage (CUDA unless --device names another device):
  python scripts/study_tracking_torch.py oracle \
      --motion 0.045 --frames 16 --evals 75 --margin 1.5 --prior est
  python scripts/study_tracking_torch.py mono --motion 0.045
  python scripts/study_tracking_torch.py oracle --device cpu --frames 4 \
      --width 48 --height 36 --n-splats 400 --evals 30

Prints one JSON line with per-frame translation errors (meters), under
study_tracking.py's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["oracle", "mono", "rgbd"])
    ap.add_argument("--motion", type=float, default=0.045)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--n-splats", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--evals", type=int, default=200)
    ap.add_argument("--iters", type=int, default=160)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--margin", type=float, default=1.5)
    ap.add_argument("--prior", choices=["gt", "est", "identity"], default="est")
    ap.add_argument("--scene", choices=["synthetic", "raytrace"], default="synthetic")
    ap.add_argument("--kf-m", type=float, default=0.04)
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--pyramid", type=int, default=1,
                    help="coarse-to-fine levels (1 = flat tracker)")
    ap.add_argument("--pyramid-evals", type=str, default="100,70,50",
                    help="per-level eval budgets, coarse->fine")
    ap.add_argument("--tracker", choices=["lbfgs", "gn"], default="lbfgs",
                    help="gn = Levenberg-Marquardt on the residual vector "
                         "(TrackingConfig.method='gn')")
    ap.add_argument("--gn-iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises where there is none)")
    return ap


def make_dataset(args, device):
    if args.scene == "synthetic":
        from gslam_tpu_torch.io.synthetic import SyntheticDataset

        return SyntheticDataset(seq_len=args.frames, width=args.width, height=args.height,
                                n_splats=args.n_splats, seed=args.seed,
                                motion_scale=args.motion, device=device)
    from gslam_tpu_torch.io.raytrace import RaytracedDataset

    return RaytracedDataset(seq_len=args.frames, width=args.width, height=args.height,
                            seed=args.seed, motion_scale=args.motion)


def oracle_prior(i, prior, gt_poses, est, device):
    """The pose frame i starts from: the constant-motion prediction from the
    two previous gt or estimated poses (the previous one alone at frame 1 or
    with --prior identity)."""
    import torch

    from gslam_tpu_torch.tracking.track import constant_motion_prior

    src = gt_poses if prior == "gt" else est
    a = torch.as_tensor(np.asarray(src[max(i - 2, 0)]), device=device)
    b = torch.as_tensor(np.asarray(src[i - 1]), device=device)
    if prior == "identity":
        a = b = torch.as_tensor(np.asarray(est[i - 1]), device=device)
    return constant_motion_prior(a, b) if i >= 2 else b


def run_oracle(ds, args, tcfg, device):
    """Track frames 1.. of `ds` against its ground-truth map. Returns
    (per-frame errors in m, evaluations per frame)."""
    import torch

    from gslam_tpu_torch.eval.trajectory import trajectory_positions
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.tracking.track import track_frame

    gmap = gaussian_map_from_numpy(ds.gt_map_fields, device=device)
    K = ds.camera.K
    gt_centers = trajectory_positions(ds.poses)
    est = [np.asarray(ds.poses[0])]
    exposure = torch.zeros(2, device=device)
    errs, evals = [], []
    for i in range(1, args.frames):
        prior = oracle_prior(i, args.prior, ds.poses, est, device)
        r = track_frame(gmap, prior, exposure, ds.images[i], K, args.width, args.height,
                        tcfg, device=device)
        est.append(r.pose.detach().cpu().numpy())
        exposure = r.exposure
        c_est = trajectory_positions(est[-1][None])[0]
        errs.append(float(np.linalg.norm(c_est - gt_centers[i])))
        evals.append(int(r.n_evals))
    return errs, evals


def main(argv=None):
    args = build_parser().parse_args(argv)

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.eval.trajectory import trajectory_positions
    from gslam_tpu_torch.tracking.track import TrackingConfig

    dev = resolve_device(args.device)
    if args.mode == "oracle" and args.scene != "synthetic":
        raise SystemExit("oracle mode needs the synthetic gt splat map")
    ds = make_dataset(args, dev)

    gt_centers = trajectory_positions(ds.poses)
    steps = np.linalg.norm(np.diff(gt_centers, axis=0), axis=1)
    out = {
        "mode": args.mode, "motion": args.motion, "frames": args.frames,
        "median_step_m": float(np.median(steps)),
        "evals": args.evals, "margin": args.margin, "warmup": args.warmup,
        "prior": args.prior, "scene": args.scene, "tag": args.tag,
    }

    pyr_evals = tuple(int(v) for v in args.pyramid_evals.split(","))
    common = dict(lbfgs_max_eval=args.evals, lbfgs_max_iter=args.iters,
                  warmup_steps=args.warmup, bin_radius_margin=args.margin,
                  pyramid_levels=args.pyramid, pyramid_evals=pyr_evals,
                  method="gn" if args.tracker == "gn" else "igs", gn_iters=args.gn_iters)
    out["tracker"] = args.tracker
    out["pyramid"] = args.pyramid
    if args.pyramid > 1:
        out["pyramid_evals"] = list(pyr_evals)

    if args.mode == "oracle":
        errs, evals = run_oracle(ds, args, TrackingConfig(**common), dev)
        out["per_frame_err_m"] = [round(e, 5) for e in errs]
        out["max_err_m"] = max(errs)
        out["mean_evals"] = float(np.mean(evals))
    else:
        from gslam_tpu_torch.mapping.backend_ops import MapConfig
        from gslam_tpu_torch.runtime.fused import FusedConfig, FusedSlam

        use_gt = args.mode == "rgbd"
        fcfg = FusedConfig(
            tracking=TrackingConfig(use_gt_depths=use_gt, **common),
            mapping=MapConfig(kf_m=args.kf_m, use_gt_depths=use_gt),
            max_frames=args.frames, use_gt_depths=use_gt,
        )
        slam = FusedSlam(fcfg, args.width, args.height, capacity=2 ** 14, kf_capacity=16,
                         seed=0, device=dev)
        m = slam.run(ds, chunk=1, sync_every=0, eval_stride=4)
        est_centers = trajectory_positions(slam.trajectory)
        # per-frame error in the gauge of frame 0 (both trajectories start
        # at identity, so no alignment needed for the error profile)
        errs = np.linalg.norm(est_centers - gt_centers[:len(est_centers)], axis=1)
        out["per_frame_err_m"] = [round(float(e), 5) for e in errs]
        for key in ("ate", "ate_rmse", "psnr", "health", "kf_frames", "mean_track_evals"):
            out[key] = m.get(key)

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
