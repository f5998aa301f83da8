#!/usr/bin/env python3
"""Offline single-image splat fit with the PyTorch / CUDA port.

The counterpart of pipeline.py: initialize a random splat cloud, fit it to
one target image under an L1 loss through the port's render_impl and masked
Adam (one learning rate for every field), and save the result. A check of
the render + backward path with no SLAM involved.

    python pipeline_torch.py --image path.png --iters 2000
    python pipeline_torch.py --synthetic --iters 500   # no input needed

It runs on CUDA unless `--device` names another device (e.g. cpu).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", type=str, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--n-splats", type=int, default=4000)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--out", type=str, default="runs/pipeline_fit")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: CUDA; raises when CUDA is absent)")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.mapping.gaussians import TRAINABLE_FIELDS, empty_map
    from gslam_tpu_torch.mapping.optimizer import adam_step, init_adam
    from gslam_tpu_torch.ops.knn import mean_knn_scale
    from gslam_tpu_torch.ops.rasterize import RenderConfig, render_impl
    from gslam_tpu_torch.runtime.checkpoint import save_map

    dev = resolve_device(args.device)
    W, H = args.width, args.height
    rng = np.random.default_rng(0)
    if args.image:
        img = Image.open(args.image).convert("RGB").resize((W, H))
        target = np.float32(img) / 255.0
    else:
        # smooth random target
        from scipy.ndimage import gaussian_filter

        target = gaussian_filter(
            rng.random((H, W, 3)).astype(np.float32), sigma=(8, 8, 0)
        )
        target = (target - target.min()) / (target.max() - target.min() + 1e-9)

    n = args.n_splats
    fx = 0.9 * W
    K = torch.tensor([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    z = rng.uniform(1.8, 2.2, n).astype(np.float32)
    u = rng.uniform(0, W, n).astype(np.float32)
    v = rng.uniform(0, H, n).astype(np.float32)
    means = torch.from_numpy(
        np.stack([(u - W / 2) * z / fx, (v - H / 2) * z / fx, z], -1)).to(dev)
    scales0 = mean_knn_scale(means, 4)

    gmap = empty_map(n, device=dev)._replace(
        means=means,
        quats=torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)).to(dev),
        log_scales=torch.log(scales0[:, None].repeat(1, 3) + 1e-6),
        logit_opacities=torch.zeros((n,), device=dev),
        logit_colors=torch.zeros((n, 3), device=dev),
        log_uncertainties=torch.zeros((n,), device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    cfg = RenderConfig(tile_capacity=256)
    target_t = torch.from_numpy(target).to(dev)
    eye = torch.eye(4, device=dev)[None]
    lrs = {f: args.lr for f in TRAINABLE_FIELDS}

    def render(g):
        return render_impl(**g.render_kwargs(), viewmats=eye, Ks=K[None],
                           width=W, height=H, cfg=cfg)

    opt = init_adam(gmap)
    losses = []
    t0 = time.time()
    for _ in range(args.iters):
        params = {f: p.detach().requires_grad_(True) for f, p in gmap.trainable().items()}
        loss = torch.mean(torch.abs(render(gmap.with_trainable(params)).rgb[0] - target_t))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        gmap, opt = adam_step(gmap.with_trainable({f: p.detach() for f, p in params.items()}),
                              grads, opt, lrs=lrs)
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(1)
    dt = time.time() - t0

    with torch.no_grad():
        final = np.clip(render(gmap).rgb[0].cpu().numpy(), 0, 1)
    l1 = float(np.mean(np.abs(final - target)))
    print(f"fit {args.iters} iters in {dt:.1f}s "
          f"({1e3 * dt / max(args.iters, 1):.1f} ms/iter); "
          f"L1 {float(losses[0]):.4f} -> {l1:.4f}")

    os.makedirs(args.out, exist_ok=True)
    Image.fromarray(np.uint8(target * 255)).save(f"{args.out}/target.png")
    Image.fromarray(np.uint8(final * 255)).save(f"{args.out}/fit.png")
    save_map(f"{args.out}/splats.npz", gmap)
    print(f"artifacts in {args.out}")
    return l1


if __name__ == "__main__":
    main()
