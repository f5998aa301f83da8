#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch port, on one CUDA card.

    python3 profile_torch_track.py [--frames 3] [--trace out.json]

Builds chip_smoke.py's BASELINE config 1 scene (50,000 splats, 320x240,
fx=280, tile_capacity=512, default igs tracker), renders ground-truth
frames, then:
  1. times `track_frame` on each frame with CUDA events (no profiler);
  2. traces one more frame with torch.profiler and reports the device busy
     time (sum of kernel durations on the card; one stream, so they do not
     overlap), the idle share of the frame's wall time, kernel launches per
     evaluation, device time by kernel, and host time in named ranges:
     binning + gather, the forward render, the backward (autograd.grad),
     and the rest (loss, optimizer, readbacks).
Prints one JSON line per part, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_track.py needs a CUDA device", file=sys.stderr)
        return 2
    from gslam_tpu_torch.core.transforms import se3_exp
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins
    from gslam_tpu_torch.ops.track_fused import (
        gather_tracking_tiles, render_tracking_fused,
    )
    from gslam_tpu_torch.tracking import track
    from gslam_tpu_torch.tracking.track import TrackingConfig, track_frame

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    W, H = cs.W, cs.H
    rng = np.random.default_rng(0)
    gmap = gaussian_map_from_numpy(cs.make_map_fields(cs.N_SPLATS, cs.N_SPLATS, rng),
                                   device="cuda")
    xis = rng.normal(scale=0.004, size=(cs.N_FRAMES, 6)).astype(np.float32)
    K = torch.tensor([[cs.FX, 0, W / 2], [0, cs.FX, H / 2], [0, 0, 1]], device="cuda")
    tcfg = TrackingConfig(render=RenderConfig(tile_capacity=512, pairs_per_gaussian=8))
    n = args.frames + 1
    poses, cur = [], torch.eye(4)
    for i in range(n):
        cur = se3_exp(torch.from_numpy(xis[i])) @ cur
        poses.append(cur.cuda())
    gts = []
    with torch.no_grad():
        for p in poses:
            bins = compute_bins(gmap.means, gmap.quats, gmap.log_scales, gmap.alive,
                                p[None], K[None], W, H, tcfg.render)
            rgb = render_tracking_fused(gather_tracking_tiles(gmap, bins), p, K, W, H,
                                        tcfg.render)[0]
            gts.append(torch.clamp(rgb, 0.0, 1.0))

    # 1. plain timing, prior = previous ground-truth pose
    frames = []
    for i in range(1, n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = track_frame(gmap, poses[i - 1], torch.zeros(2), gts[i], K, W, H, tcfg)
        b.record()
        b.synchronize()
        frames.append(dict(frame=i, ms=a.elapsed_time(b), n_evals=r.n_evals))
    print(json.dumps({"part": "frame_time", "nvidia_smi": smi, "frames": frames,
                      "ms_per_eval": [f["ms"] / f["n_evals"] for f in frames]}),
          flush=True)

    # 2. one traced frame with named host ranges
    def ranged(name, fn):
        def wrapper(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapper

    track.compute_bins = ranged("bins", track.compute_bins)
    track.gather_tracking_tiles = ranged("gather", track.gather_tracking_tiles)
    track.render_tracking_fused = ranged("render_fwd", track.render_tracking_fused)
    grad = torch.autograd.grad
    torch.autograd.grad = ranged("backward", grad)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = track_frame(gmap, poses[0], torch.zeros(2), gts[1], K, W, H, tcfg)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.autograd.grad = grad
    if args.trace:
        prof.export_chrome_trace(args.trace)

    ranges = ("bins", "gather", "render_fwd", "backward")
    dev_by_kernel = defaultdict(float)
    n_kernels = 0
    host_ranges = defaultdict(float)
    for ev in prof.events():
        if ev.name in ranges:
            # a named range shows on the host and, as an annotation spanning
            # its kernels, on the device: only its host side is counted
            if ev.device_type == torch.autograd.DeviceType.CPU:
                host_ranges[ev.name] += ev.cpu_time_total / 1e3
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_by_kernel[ev.name] += ev.device_time_total / 1e3
            n_kernels += 1
    busy = sum(dev_by_kernel.values())
    top = sorted(dev_by_kernel.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "part": "frame_trace", "nvidia_smi": smi, "n_evals": r.n_evals,
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms,
        "kernel_launches": n_kernels, "launches_per_eval": n_kernels / r.n_evals,
        "host_ms": dict(host_ranges),
        "host_other_ms": wall_ms - sum(host_ranges.values()),
        "device_ms_by_kernel": {k[:90]: v for k, v in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
