#!/usr/bin/env python3
"""Materialize a synthetic or raytraced SLAM sequence into an .npz cache with
the PyTorch port (the counterpart of scripts/make_npz_dataset.py; both
packages' NpzDataset read the file).

    python scripts/make_npz_dataset_torch.py OUT.npz \
        --scene raytrace --seq-len 160 --width 320 --height 240 \
        --motion 0.026 --seed 1

The synthetic scene is rendered by the port on --device (CUDA unless named);
the raytraced one is numpy on the host.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--scene", choices=["synthetic", "raytrace"], default="synthetic")
    ap.add_argument("--seq-len", type=int, default=160)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--n-splats", type=int, default=20000)
    ap.add_argument("--motion", type=float, default=0.018)
    ap.add_argument("--seed", type=int, default=0)
    # photometric nuisances (raytrace only): the real-sensor robustness
    # proxy, see gslam_tpu_torch/io/raytrace.py
    ap.add_argument("--noise-std", type=float, default=0.0)
    ap.add_argument("--exposure-drift", type=float, default=0.0)
    ap.add_argument("--blur-px", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device that renders the synthetic scene (default: "
                         "CUDA; raises where there is none)")
    args = ap.parse_args(argv)

    import numpy as np

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.io.npz import save_dataset_npz

    dev = resolve_device(args.device)
    kw = dict(seq_len=args.seq_len, width=args.width, height=args.height,
              motion_scale=args.motion, seed=args.seed)
    if args.scene == "synthetic":
        from gslam_tpu_torch.io.synthetic import SyntheticDataset

        ds = SyntheticDataset(n_splats=args.n_splats, device=dev, **kw)
    else:
        from gslam_tpu_torch.io.raytrace import RaytracedDataset

        ds = RaytracedDataset(noise_std=args.noise_std, exposure_drift=args.exposure_drift,
                              blur_px=args.blur_px, **kw)
    save_dataset_npz(ds, args.out)
    t = np.stack([np.asarray(f.gt_pose) for f in iter(ds)])
    ctrs = np.stack([-m[:3, :3].T @ m[:3, 3] for m in t])
    d = np.linalg.norm(np.diff(ctrs, axis=0), axis=1)
    print(f"saved {args.out}: {args.scene} {args.seq_len}f "
          f"{args.width}x{args.height} median step {100 * np.median(d):.2f}cm "
          f"max {100 * d.max():.2f}cm path {d.sum():.2f}m")


if __name__ == "__main__":
    main()
