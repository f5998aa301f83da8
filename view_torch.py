#!/usr/bin/env python3
"""Offline checkpoint viewer for the PyTorch / CUDA port.

The counterpart of view.py: loads a splat map checkpoint (written by either
package's save_map) and renders an orbit of views to PNGs, or with
`--serve` runs the interactive viser viewer (gslam_tpu_torch/viz/viewer.py),
which needs viser.

    python view_torch.py runs/<name>/splats.npz --out orbit

It runs on CUDA unless `--device` names another device (e.g. cpu).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def orbit_poses(center, radius: float, n: int, elevation: float = 0.3):
    """World-to-camera poses circling `center`, looking at it."""
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = center + radius * np.array(
            [np.sin(ang), -elevation, -np.cos(ang)], np.float32
        )
        fwd = center - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, fwd, eye
        poses.append(np.linalg.inv(c2w))
    return np.stack(poses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--out", default="orbit")
    ap.add_argument("--n-views", type=int, default=24)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--serve", action="store_true",
                    help="interactive viser server instead of orbit render")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: CUDA; raises when CUDA is absent)")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.ops.rasterize import RenderConfig, render_impl
    from gslam_tpu_torch.runtime.checkpoint import load_map
    from gslam_tpu_torch.viz.viewer import serve_viewer

    dev = resolve_device(args.device)
    gmap, _extra = load_map(args.checkpoint, dev)
    alive = gmap.alive.cpu().numpy()
    print(f"loaded {alive.sum()} live splats / capacity {alive.size}")

    if args.serve:
        serve_viewer(gmap, width=args.width, height=args.height)
        return

    means = gmap.means.cpu().numpy()[alive]
    center = np.median(means, axis=0)
    radius = float(np.percentile(np.linalg.norm(means - center, axis=1), 60))

    W, H = args.width, args.height
    fx = 0.9 * W
    K = torch.tensor([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    poses = torch.from_numpy(orbit_poses(center.astype(np.float32), radius,
                                         args.n_views)).to(dev)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = RenderConfig(tile_capacity=512)
    with torch.no_grad():
        for i in range(args.n_views):
            out = render_impl(**gmap.render_kwargs(), viewmats=poses[i:i + 1],
                              Ks=K[None], width=W, height=H, cfg=cfg)
            img = np.uint8(np.clip(out.rgb[0].cpu().numpy(), 0, 1) * 255)
            Image.fromarray(img).save(out_dir / f"{i:04}.png")
    print(f"wrote {args.n_views} orbit views to {out_dir}")


if __name__ == "__main__":
    main()
