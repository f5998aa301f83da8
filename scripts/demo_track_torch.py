#!/usr/bin/env python3
"""End-to-end library drive of the PyTorch port (the counterpart of
scripts/demo_track.py): build a splat map, render it, perturb the camera,
and recover the pose with the tracking frontend. Saves gt.png,
perturbed.png and tracked.png.

    python scripts/demo_track_torch.py [out_dir]              # on the CUDA card
    python scripts/demo_track_torch.py /tmp/gslam_demo --device cpu

Exits 0 when tracking recovered the pose (under 0.5 cm, and the photometric
L1 at most a tenth of the perturbed one's), 1 otherwise.
"""

from __future__ import annotations

import argparse
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N_LIVE, CAP = 400, 512
W, H = 96, 64
FX = 80.0
# the perturbation: ~2 cm translation + ~1 degree rotation (se3_exp tangent)
XI = (0.02, -0.015, 0.01, 0.012, -0.008, 0.01)


def save_png(path, rgb):
    """An [H, W, 3] float image in [0, 1] as an 8-bit RGB PNG (zlib only)."""
    img = np.uint8(np.clip(np.asarray(rgb), 0, 1) * 255)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def demo_map(device):
    """demo_track.py's map: 400 live splats on a wavy surface ~3 m away with
    distinct colors, in a 512-slot buffer."""
    import torch

    from gslam_tpu_torch.mapping.gaussians import empty_map

    rng = np.random.default_rng(42)
    z = rng.uniform(1.5, 4.5, N_LIVE).astype(np.float32)
    u = rng.uniform(2, W - 2, N_LIVE).astype(np.float32)
    v = rng.uniform(2, H - 2, N_LIVE).astype(np.float32)
    x = (u - W / 2) * z / FX
    y = (v - H / 2) * z / FX
    live = dict(
        means=np.stack([x, y, z], -1),
        quats=rng.normal(size=(N_LIVE, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.04, 0.1, (N_LIVE, 3)).astype(np.float32)),
        logit_opacities=2.0,
        logit_colors=rng.normal(size=(N_LIVE, 3)).astype(np.float32) * 2,
        log_uncertainties=0.0,
        alive=True,
    )
    gmap = empty_map(CAP, device=device)

    def put(field, value):
        x = getattr(gmap, field).clone()
        x[:N_LIVE] = torch.as_tensor(value, dtype=x.dtype, device=device)
        return x

    return gmap._replace(**{f: put(f, val) for f, val in live.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="/tmp/gslam_demo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises where there is none)")
    args = ap.parse_args(argv)

    import torch

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.core.transforms import se3_exp
    from gslam_tpu_torch.ops import RenderConfig, render
    from gslam_tpu_torch.tracking import TrackingConfig, track_frame

    dev = resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gmap = demo_map(dev)
    K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], device=dev)
    cfg = RenderConfig(tile_capacity=256, tile_chunk=8)

    def render_at(pose):
        with torch.no_grad():
            return render(**gmap.render_kwargs(), viewmats=pose[None], Ks=K[None], width=W,
                          height=H, cfg=cfg, device=dev)

    gt_pose = torch.eye(4, device=dev)
    out = render_at(gt_pose)
    gt_img = out.rgb[0]
    save_png(out_dir / "gt.png", gt_img.cpu())
    print("gt render: alpha mean %.3f, rgb range [%.3f, %.3f], n_pairs=%d"
          % (float(out.alpha.mean()), float(gt_img.min()), float(gt_img.max()),
             int(out.n_pairs[0])))

    bad_pose = se3_exp(torch.tensor(XI, device=dev)) @ gt_pose
    out_bad = render_at(bad_pose)
    save_png(out_dir / "perturbed.png", out_bad.rgb[0].cpu())
    err_before = float(torch.mean(torch.abs(out_bad.rgb[0] - gt_img)))

    tcfg = TrackingConfig(render=cfg)
    zeros = torch.zeros(2, device=dev)
    t0 = time.perf_counter()
    res = track_frame(gmap, bad_pose, zeros, gt_img, K, W, H, tcfg, device=dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = track_frame(gmap, bad_pose, zeros, gt_img, K, W, H, tcfg, device=dev)
    t_run = time.perf_counter() - t0
    # second refinement round from the first result (rebased)
    res = track_frame(gmap, res.pose, res.exposure, gt_img, K, W, H, tcfg, device=dev)

    out_tracked = render_at(res.pose)
    save_png(out_dir / "tracked.png", out_tracked.rgb[0].cpu())
    err_after = float(torch.mean(torch.abs(out_tracked.rgb[0] - gt_img)))

    pose_err_before = float(torch.linalg.norm(bad_pose[:3, 3] - gt_pose[:3, 3]))
    pose_err_after = float(torch.linalg.norm(res.pose[:3, 3] - gt_pose[:3, 3]))
    rot_err_after = float(torch.linalg.norm(res.pose[:3, :3] - gt_pose[:3, :3]))

    print(f"photo L1: before={err_before:.5f} after={err_after:.5f}")
    print(f"translation err: before={pose_err_before * 100:.2f}cm "
          f"after={pose_err_after * 100:.3f}cm; rot fro err={rot_err_after:.5f}")
    # the first call builds the kernels where they are not built yet
    print(f"tracking loss={float(res.loss):.6f} evals={int(res.n_evals)} "
          f"first={t_first:.1f}s run={t_run * 1000:.0f}ms")

    ok = pose_err_after < 0.005 and err_after < 0.1 * err_before
    print("TRACKING", "RECOVERED" if ok else "DID NOT RECOVER", flush=True)
    return dict(ok=ok, pose_err_before_m=pose_err_before, pose_err_after_m=pose_err_after,
                rot_fro_err_after=rot_err_after, photo_l1_before=err_before,
                photo_l1_after=err_after, n_evals=int(res.n_evals))


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
