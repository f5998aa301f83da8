#!/usr/bin/env python3
"""Reproduce and dissect the r5 gate failure at f15-f17 (runs/r5_gate_gn) in
the PyTorch port (the counterpart of scripts/repro_f16.py).

Both chip gates of the JAX package tracked the first 14 frames of the
flagship scene at sub-5 mm aligned ATE and then exploded at f15-17 with a
180-degree view flip whose recorded track loss was nominal. The question:
is the diverged pose a lower-objective point than the true pose (an
objective flaw), or a basin the optimizer jumped into from a too-far prior
(a robustness flaw)?

Method: run the fused RGB-D loop on frames 0..14 (the healthy prefix) at
80x60 to build the same-aged map, then for f15/f16/f17:
  * evaluate the tracking objective (photometric active-nerf + alpha-
    normalized depth lock, tracking/track.py's terms) at the motion prior,
    the ground-truth pose and the chip run's diverged pose;
  * run the GN pyramid tracker from the prior and report where it lands.

    python scripts/repro_f16_torch.py                 # on the CUDA card
    python scripts/repro_f16_torch.py --device cpu

Prints one JSON line for the prefix and one per frame, under repro_f16.py's
keys.
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

W, H = 80, 60
SCENE = ROOT / "runs" / "r4_scene" / "dataset_80.npz"
# the diverged chip trajectory at 160x120 (same scene, same walk)
DIVERGED = ROOT / "runs" / "r5_gate_gn" / "trajectory.npy"
PREFIX = 15  # frames 0..14 build the map
FRAMES = (15, 16, 17)


def configs():
    """repro_f16.py:53-66: (RenderConfig, TrackingConfig, FusedConfig)."""
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.runtime.fused import FusedConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    rcfg = RenderConfig(tile_capacity=128, tile_chunk=8)
    tcfg = TrackingConfig(use_gt_depths=True, render=rcfg, method="gn", gn_iters=8,
                          pyramid_levels=3)
    fcfg = FusedConfig(tracking=tcfg, mapping=MapConfig(render=rcfg, use_gt_depths=True),
                       max_frames=PREFIX, use_gt_depths=True, init_iters_per_dispatch=40)
    return rcfg, tcfg, fcfg


def objective(gmap, pose, img, dep, exposure, K, width, height, rcfg, tcfg):
    """The tracking objective at `pose` (tensors on the map's device):
    (photometric, depth term, total, mean alpha) as floats."""
    import torch

    from gslam_tpu_torch.ops.losses import (
        apply_exposure, masked_depth_l1, tracking_photometric,
    )
    from gslam_tpu_torch.ops.rasterize import render_impl

    with torch.no_grad():
        out = render_impl(**gmap.render_kwargs(), viewmats=pose[None], Ks=K[None],
                          width=width, height=height, cfg=rcfg)
        rgb = apply_exposure(out.rgb[0], exposure)
        photo = tracking_photometric(rgb, img, out.beta[0])
        d_hat = out.depth[0] / torch.clamp(out.alpha[0], min=1e-3)
        dterm = masked_depth_l1(d_hat[None], dep[None], alpha=out.alpha[0][None],
                                alpha_min=tcfg.depth_alpha_min)
    return (float(photo), float(dterm), float(photo + tcfg.depth_loss_weight * dterm),
            float(torch.mean(out.alpha[0])))


def center(p):
    return -p[:3, :3].T @ p[:3, 3]


def row_of(values, pose, gt_pose):
    ph, dt, tot, am = values
    return {"photo": round(ph, 5), "depth": round(dt, 5), "total": round(tot, 5),
            "alpha_mean": round(am, 4),
            "err_m": round(float(np.linalg.norm(center(pose) - center(gt_pose))), 4)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises where there is none)")
    args = ap.parse_args(argv)

    import torch

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.io.npz import NpzDataset
    from gslam_tpu_torch.runtime.fused import FusedSlam
    from gslam_tpu_torch.tracking.track import constant_motion_prior, track_frame

    dev = resolve_device(args.device)
    ds = NpzDataset(SCENE)
    K = ds.camera.K.to(dev)
    rcfg, tcfg, fcfg = configs()

    slam = FusedSlam(fcfg, W, H, capacity=8192, kf_capacity=16, seed=0, device=dev)
    m = slam.run(NpzDataset(SCENE, seq_len=PREFIX), chunk=1, sync_every=0, eval_stride=0)
    rows = [{"prefix_ate": m.get("ate"), "N": m.get("N"), "kf": m.get("kf_frames"),
             "health": m.get("health")}]
    print(json.dumps(rows[0]), flush=True)

    gmap = slam.final_state.gmap
    est = [np.asarray(p) for p in slam.trajectory]
    exposure = torch.zeros(2, device=dev)
    gt_poses = [np.asarray(ds[i].gt_pose) for i in range(max(FRAMES) + 1)]
    div = np.load(DIVERGED)

    def on_dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    for i in FRAMES:
        img, dep = on_dev(ds[i].image), on_dev(ds[i].gt_depth)
        a = est[i - 2] if i - 2 < len(est) else gt_poses[i - 2]
        b = est[i - 1] if i - 1 < len(est) else gt_poses[i - 1]
        prior = constant_motion_prior(on_dev(a), on_dev(b))

        row = {"frame": i}
        for name, pose in (("prior", prior.cpu().numpy()), ("gt", gt_poses[i]),
                           ("diverged", div[i])):
            row[name] = row_of(objective(gmap, on_dev(pose), img, dep, exposure, K, W, H,
                                         rcfg, tcfg), pose, gt_poses[i])

        r = track_frame(gmap, prior, exposure, img, K, W, H, tcfg, gt_depth=dep, device=dev)
        landed = r.pose.detach().cpu().numpy()
        row["tracked"] = row_of(objective(gmap, on_dev(landed), img, dep, exposure, K, W, H,
                                          rcfg, tcfg), landed, gt_poses[i])
        row["tracked"].update(n_evals=int(r.n_evals), rejected=bool(r.rejected))
        print(json.dumps(row), flush=True)
        rows.append(row)

        # chain the est trajectory forward with the tracked pose so f16's
        # prior compounds f15's error exactly as the real run does
        est.append(landed)
    return rows


if __name__ == "__main__":
    main()
