#!/usr/bin/env python3
"""gslam_tpu_torch CLI: run Gaussian-splatting SLAM over a dataset with the
PyTorch / CUDA port.

The counterpart of main.py, with its flags, defaults and `--set` semantics
(the JAX package's own runs, runs/*/args.txt, go through main.py):

    python main_torch.py --dataset tum --scene /data/rgbd_dataset_freiburg1_desk
    python main_torch.py --dataset raytrace --seq-len 60 --use-gt-depths \\
        --set tracking.method=gn --set tracking.pyramid_levels=3
    python main_torch.py --device cpu --dataset synthetic --seq-len 10 \\
        --width 96 --height 64 --n-splats 400 --capacity 2048 --kf-capacity 8

It runs on CUDA unless `--device` names another device, and raises when no
device is named and CUDA is absent. `--set dotted.path=value` overrides any
field of the port's configs (SlamConfig, TrackingConfig, MapConfig,
RenderConfig); a field the port does not have ends in SystemExit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from datetime import datetime
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", type=str, default=None, help="dataset directory")
    p.add_argument(
        "--dataset",
        choices=["tum", "replica", "synthetic", "raytrace", "npz", "video",
                 "oak"],
        default="tum",
    )
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: CUDA; raises when "
                        "CUDA is absent), e.g. cpu")
    p.add_argument("--seq-len", type=int, default=-1)
    p.add_argument("--run-name", type=str, default="")
    p.add_argument("--downscale", type=int, default=1, help="TUM image downscale")
    p.add_argument("--width", type=int, default=160, help="synthetic image width")
    p.add_argument("--height", type=int, default=120, help="synthetic image height")
    p.add_argument("--n-splats", type=int, default=2000,
                   help="synthetic scene splat count")
    p.add_argument("--motion-scale", type=float, default=0.02,
                   help="synthetic per-frame motion scale")
    p.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    p.add_argument("--capacity", type=int, default=2**17, help="max splats")
    p.add_argument("--kf-capacity", type=int, default=64)
    p.add_argument("--use-gt-depths", action="store_true")
    p.add_argument("--enable-pgo", action="store_true")
    p.add_argument("--threaded", action="store_true",
                   help="free-running backend thread instead of deterministic interleave")
    p.add_argument("--fused", action="store_true",
                   help="the fused per-frame SLAM step (runtime/fused.py) in "
                        "place of the actor runtime")
    p.add_argument("--chunk-backend", choices=["scan", "unroll"],
                   default="scan",
                   help="accepted for main.py parity: both are one loop here")
    p.add_argument("--chunk", type=int, default=16,
                   help="frames folded per step call in --fused mode")
    p.add_argument("--init-ipd", type=int, default=0,
                   help="--fused: max bootstrap mapping iterations run inside "
                        "frame 0's step; the rest run as refine passes of this "
                        "length (0 = all in the step, on every device: main.py's "
                        "TPU default of 50 only kept a TPU worker from killing "
                        "long dispatches)")
    p.add_argument("--max-capacity", type=int, default=0,
                   help="--fused: grow the splat buffer geometrically up to "
                        "this capacity when it fills (0 = fixed capacity)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="--fused trajectory-buffer capacity (defaults to the "
                        "dataset length)")
    p.add_argument("--init-n-new", type=int, default=5000,
                   help="bootstrap insertion size (--fused)")
    p.add_argument("--kf-n-new", type=int, default=100,
                   help="per-keyframe insertion size (--fused)")
    p.add_argument("--init-iters", type=int, default=None)
    p.add_argument("--mapping-iters", type=int, default=None)
    p.add_argument("--tracking-max-evals", type=int, default=None)
    p.add_argument("--tracking-method", choices=["igs", "warp"], default="igs")
    p.add_argument("--telemetry", choices=["null", "disk", "rerun", "auto"],
                   default="null",
                   help="per-frame streaming telemetry sink")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint .npz to resume from (actor or fused)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="fused runtime: write a resumable checkpoint every "
                        "N frames (0 = never)")
    p.add_argument("--eval-stride", type=int, default=4,
                   help="evaluate PSNR/SSIM on every k-th frame at the end")
    p.add_argument("--sync-every", type=int, default=8,
                   help="--fused chunk=1: read the health counter back every N "
                        "frames (0 = never)")
    p.add_argument("--set", action="append", default=[], metavar="PATH=VALUE",
                   help="override any nested config field, e.g. mapping.ssim_weight=0.1")
    return p


def _coerce(old, value):
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    typ = type(old) if old is not None else str
    if typ in (dict, list, tuple):
        v = json.loads(value)
        return typ(v) if typ is tuple else v
    return typ(value)


def apply_overrides(cfg, overrides):
    """Apply `--set dotted.path=value` overrides. Frozen nested dataclasses
    (TrackingConfig/MapConfig/RenderConfig) are rebuilt immutably with
    dataclasses.replace along the path; mutable objects get setattr."""
    for item in overrides:
        path, value = item.split("=", 1)
        parts = path.split(".")
        chain = [cfg]
        for part in parts[:-1]:
            try:
                chain.append(getattr(chain[-1], part))
            except AttributeError:
                raise SystemExit(f"--set: no such config field {path}")
        field = parts[-1]
        try:
            old = getattr(chain[-1], field)
        except AttributeError:
            raise SystemExit(f"--set: no such config field {path}")
        new = _coerce(old, value)
        # Rebuild from the leaf outward: replace() for frozen dataclasses,
        # setattr once we reach a mutable ancestor.
        for i in range(len(chain) - 1, -1, -1):
            obj = chain[i]
            frozen = (
                dataclasses.is_dataclass(obj)
                and obj.__dataclass_params__.frozen
            )
            if frozen:
                new = dataclasses.replace(obj, **{field: new})
                if i == 0:
                    raise SystemExit(f"--set: root config is frozen ({path})")
                field = parts[i - 1]
            else:
                setattr(obj, field, new)
                break
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(name)s: %(message)s")

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.eval.metrics import sanitize_metrics
    from gslam_tpu_torch.io import build_dataset
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.runtime.system import SlamConfig, SlamSystem
    from gslam_tpu_torch.tracking.track import TrackingConfig

    device = resolve_device(args.device)

    ds_kwargs = {}
    if args.dataset == "tum":
        ds_kwargs["downscale"] = args.downscale
    if args.dataset in ("synthetic", "raytrace"):
        ds_kwargs.update(
            width=args.width, height=args.height, n_splats=args.n_splats,
            motion_scale=args.motion_scale, seed=args.seed,
        )
    if args.dataset == "synthetic":
        ds_kwargs["device"] = device  # its frames are rendered by the port
    dataset = build_dataset(args.dataset, args.scene, args.seq_len, **ds_kwargs)
    cam = dataset.camera if dataset.camera is not None else dataset[0].camera

    run_name = args.run_name or datetime.now().strftime("%Y-%m-%d--%H-%M-%S")
    run_dir = Path("runs") / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "args.txt").write_text(
        " ".join(sys.argv if argv is None else ["main_torch.py", *argv]))

    m_kwargs = dict(use_gt_depths=args.use_gt_depths, enable_pgo=args.enable_pgo)
    if args.init_iters is not None:
        m_kwargs["num_iters_init"] = args.init_iters
    if args.mapping_iters is not None:
        m_kwargs["num_iters_mapping"] = args.mapping_iters
    t_kwargs = dict(use_gt_depths=args.use_gt_depths,
                    method=args.tracking_method)
    if args.tracking_max_evals is not None:
        t_kwargs["lbfgs_max_eval"] = args.tracking_max_evals

    cfg = SlamConfig(
        tracking=TrackingConfig(**t_kwargs),
        mapping=MapConfig(**m_kwargs),
        capacity=args.capacity,
        kf_capacity=args.kf_capacity,
        synchronous=not args.threaded,
        eval_stride=args.eval_stride,
        telemetry=args.telemetry,
        run_dir=str(run_dir),
    )
    cfg = apply_overrides(cfg, args.set)

    if args.fused:
        import numpy as np

        from gslam_tpu_torch.runtime.fused import FusedConfig, FusedSlam

        fcfg = FusedConfig(
            tracking=cfg.tracking, mapping=cfg.mapping,
            abort_unhealthy=cfg.abort_unhealthy,
            max_frames=args.max_frames or max(len(dataset), 1),
            init_n_new=args.init_n_new, kf_n_new=args.kf_n_new,
            idle_iters=cfg.mapping.num_iters_mapping,
            init_iters_per_dispatch=args.init_ipd,
            max_capacity=args.max_capacity,
            use_gt_depths=args.use_gt_depths,
        )
        slam = FusedSlam(fcfg, cam.width, cam.height, capacity=cfg.capacity,
                         kf_capacity=cfg.kf_capacity, device=device)
        metrics = slam.run(dataset, chunk=args.chunk,
                           eval_stride=args.eval_stride,
                           sync_every=args.sync_every,
                           resume_from=args.resume,
                           checkpoint_every=args.checkpoint_every,
                           checkpoint_path=run_dir / "fused_ckpt.npz",
                           chunk_backend=args.chunk_backend)
        (run_dir / "metrics.json").write_text(
            json.dumps(sanitize_metrics(metrics), indent=2))
        np.save(run_dir / "trajectory.npy", slam.trajectory)
        np.savez_compressed(run_dir / "telemetry.npz", **slam.telemetry)
        print(json.dumps(sanitize_metrics(metrics), indent=2))
        return metrics

    system = SlamSystem(cfg, cam.width, cam.height, device=device)
    if args.resume:
        from gslam_tpu_torch.runtime.checkpoint import restore_system

        restore_system(args.resume, system)
    metrics = system.run(dataset)
    print(json.dumps(sanitize_metrics(metrics), indent=2))
    return metrics


if __name__ == "__main__":
    main()
