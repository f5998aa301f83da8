#!/usr/bin/env python3
"""Where the time of a tracked frame and of a mapping step goes in the
PyTorch port, on one CUDA card.

    python3 profile_torch_track.py [--section tracking|mapping|gn|onemillion|all]
                                   [--frames 3] [--trace out.json]

tracking: chip_smoke.py's BASELINE config 1 scene (50,000 splats, 320x240,
fx=280, tile_capacity=512, default igs tracker) and its ground-truth frames;
  1. times `track_frame` on each frame with CUDA events (no profiler);
  2. traces one more frame with torch.profiler and reports the device busy
     time (sum of kernel durations on the card; one stream, so they do not
     overlap), the idle share of the frame's wall time, kernel launches per
     evaluation, device time by kernel, and the host time of the program's
     own spans (gslam_tpu_torch/runtime/trace.py), total and self, with the
     host syncs each held: track.bins, track.eval with its track.render,
     track.loss, track.backward and track.readback, track.optimizer.
mapping: chip_smoke.py's mapping point (131,072 slots, 100,000 live, a
10-keyframe window at 320x240, tile_capacity=512);
  1. times N_PROFILE_STEPS `mapping_step`s with CUDA events after 2
     warm-up steps;
  2. traces one more step and reports the same device figures per step,
     the blend kernels' share of the busy time, and the program's spans:
     map.render (projection, binning, gather, blend), the binning inside
     it, map.loss, map.backward and map.adam.
onemillion: the same at scripts/bench_1m_torch.py's point (2^20 slots,
1,000,000 live, a 10-keyframe window at 640x480, tile_capacity=256, 4
pairs per splat).
gn: the tracking scene's frame 1 tracked with method="gn" (flat x 10 LM
iterations, then pyr3 x 8) after one warm-up frame; traces one frame of each
and reports the same device figures per render pass and the program's
spans: track.bins (once per level), track.linearize (normal_equations: the
primal and tangent passes through the forward-mode route, JtJ, Jtr),
track.eval (the candidate renders), track.solve and track.readback.
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

N_PROFILE_STEPS = 5  # timed mapping steps


def program_spans():
    """The host side of the program's spans in the last profiled run (the
    recorder's session): by name, calls, total and self ms, and the host
    syncs they held."""
    from gslam_tpu_torch.runtime import trace

    session = trace.snapshot()["session"]
    out = defaultdict(lambda: {"calls": 0, "ms": 0.0, "self_ms": 0.0, "syncs": 0})
    for sp in session["spans"] if session else ():
        if sp["end_ns"] is not None:
            agg = out[sp["name"]]
            agg["calls"] += 1
            agg["ms"] += (sp["end_ns"] - sp["start_ns"]) / 1e6
            agg["self_ms"] += sp["self_ns"] / 1e6
            agg["syncs"] += sp["syncs"]
    return dict(out)


def trace_summary(prof, wall_ms, per, per_name):
    """Device busy and idle share, launches and device ms by kernel, and the
    program's spans, from one profiled run of `per` units. Reads the
    profiler's raw events: `prof.events()` builds an event tree, which took
    about a minute for one tracked frame (~173,000 kernels)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_by_kernel = defaultdict(float)
    n_kernels = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and not ev.is_user_annotation():
            dev_by_kernel[ev.name()] += ev.duration_ns() / 1e6
            n_kernels += 1
    busy = sum(dev_by_kernel.values())
    blend_ms = sum(v for k, v in dev_by_kernel.items() if "blend_" in k)
    top = sorted(dev_by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms,
        "blend_kernels_ms": blend_ms, "blend_share_of_busy": blend_ms / busy if busy else 0.0,
        "kernel_launches": n_kernels, f"launches_per_{per_name}": n_kernels / per,
        "host_spans": program_spans(),
        # ranked, so that kernels whose names share 90 characters stay apart
        "device_ms_by_kernel": {f"{i}. {k[:90]}": v for i, (k, v) in enumerate(top, 1)},
    }


def onemillion_point():
    """scripts/bench_1m_torch.py's point on the card, and its width and height."""
    sys.path.insert(0, str(cs.ROOT / "scripts"))
    import bench_1m_torch as bench

    return bench.build_point(*bench.point_arrays(), device="cuda"), bench.W, bench.H


def profile_mapping(smi, trace, point, W, H, name="mapping"):
    """The mapping section on `point` (chip_smoke.mapping_point's tuple) at
    W x H; its JSON parts and trace file are prefixed with `name`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gslam_tpu_torch.mapping import backend_ops
    from gslam_tpu_torch.ops import rasterize

    gmap, opt, kf, pose_opt, widx, wmask, K, cfg = point
    state = [gmap, opt, kf, pose_opt]

    def step():
        out = backend_ops.mapping_step(*state, widx, wmask, K, W, H, cfg)
        state[:] = out[:4]
        return out[4]

    for _ in range(2):
        step()
    steps = []
    for _ in range(N_PROFILE_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        steps.append(a.elapsed_time(b))
    print(json.dumps({"part": f"{name}_step_time", "nvidia_smi": smi, "ms": steps,
                      "median_ms": float(np.median(steps))}), flush=True)

    # each part alone between CUDA events: what it costs the step end to end
    gmap, _opt, kf, _pose_opt = state
    with torch.no_grad():
        proj = rasterize.project_cameras(
            gmap.means, gmap.quats, torch.exp(gmap.log_scales), gmap.alive,
            kf.poses()[widx], K[None].expand(len(widx), 3, 3), W, H, cfg.render)
    parts = {
        "binning_10_cameras": lambda: rasterize._bin_cameras(
            proj.means2d, proj.radii, proj.depths, proj.valid, W, H, cfg.render),
        "window_grads": lambda: backend_ops.window_grads(gmap, kf, widx, wmask, K, W, H, cfg),
        "mapping_step": step,
    }
    print(json.dumps({"part": f"{name}_parts", "nvidia_smi": smi,
                      "ms": {k: cs.cuda_ms(fn, reps=5, warmup=1) for k, fn in parts.items()}}),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if trace:
        prof.export_chrome_trace(trace.replace(".json", f"_{name}.json"))
    summary = trace_summary(prof, wall_ms, 1, "step")
    print(json.dumps({"part": f"{name}_trace", "nvidia_smi": smi, **summary}), flush=True)


def profile_gn(smi, gmap, K, tcfg, poses, gts, trace):
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gslam_tpu_torch.tracking import track

    for name, over in (("flat10", dict(gn_iters=10)),
                       ("pyr3x8", dict(pyramid_levels=3, gn_iters=8))):
        cfg = dataclasses.replace(tcfg, method="gn", **over)
        track.track_frame(gmap, poses[0], torch.zeros(2), gts[1], K, cs.W, cs.H, cfg)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = track.track_frame(gmap, poses[0], torch.zeros(2), gts[1], K, cs.W, cs.H, cfg)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        if trace:
            prof.export_chrome_trace(trace.replace(".json", f"_gn_{name}.json"))
        summary = trace_summary(prof, wall_ms, r.n_evals, "pass")
        print(json.dumps({"part": f"gn_trace_{name}", "nvidia_smi": smi,
                          "n_evals": r.n_evals, **summary}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--section", choices=("tracking", "mapping", "gn", "onemillion", "all"),
                    default="all")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write Chrome traces here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_track.py needs a CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    if args.section in ("mapping", "all"):
        profile_mapping(smi, args.trace, cs.mapping_point(), cs.W, cs.H)
    if args.section in ("onemillion", "all"):
        profile_mapping(smi, args.trace, *onemillion_point(), name="onemillion")
    if args.section in ("mapping", "onemillion"):
        return 0
    from gslam_tpu_torch.core.transforms import se3_exp
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins
    from gslam_tpu_torch.ops.track_fused import (
        gather_tracking_tiles, render_tracking_fused,
    )
    from gslam_tpu_torch.tracking.track import TrackingConfig, track_frame

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

    if args.section in ("gn", "all"):
        profile_gn(smi, gmap, K, tcfg, poses, gts, args.trace)
    if args.section == "gn":
        return 0

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

    # 2. one traced frame with the program's spans
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = track_frame(gmap, poses[0], torch.zeros(2), gts[1], K, W, H, tcfg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    summary = trace_summary(prof, wall_ms, r.n_evals, "eval")
    print(json.dumps({"part": "frame_trace", "nvidia_smi": smi, "n_evals": r.n_evals,
                      **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
