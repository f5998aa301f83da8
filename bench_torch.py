#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port, the counterpart of bench.py.
Prints one JSON line per part as it lands and ONE summary line last.

    python3 bench_torch.py                   # on the CUDA card (~6-7 min)
    python3 bench_torch.py --section tracking|mapping|onemillion [--device cpu]

Three sections, each in a fresh subprocess, so that a fault that poisons a
CUDA context (an illegal address) or the 1M section's ~12 GB of allocator
state cannot touch another section's numbers:

  tracking   -- camera tracking against a frozen 50k-splat map at 320x240
                (BASELINE config 1, bench.py:98-234): the chained loop with
                one wait at the end and with a wait after every frame, then
                marginal rates at the full tracking budget, the converged
                budget (36 evaluations) and GN pyr3 x 8.
  mapping    -- bench.py's mapping point (bench.py:240-344: 131,072 slots,
                100,000 live, a 10-camera window): 30 steps, then the
                marginal rate of 5 against 20 steps.
  onemillion -- 2^20 slots at 640x480 (bench.py:350-491) through
                scripts/bench_1m_torch.py's measure, then the marginal
                rates of a render and of a mapping step.

A marginal rate is bench.py's formula: run n1 and then n2 steps, each run
ending in one wait, and take (t2 - t1) / (n2 - n1). bench.py's scans ran
whole on the device; the port's tracker reads back once per L-BFGS
evaluation and its mapping step syncs the host 3 times a step (2 in the
render, 1 in the loss; binning holds none), so on the card a marginal
rate is WALL time with the host included, not device time. The device's
own share comes from one torch.profiler run of one extra frame, render or
step outside the timed windows: the kernels' summed durations
(`device_busy_ms`), the idle share of that run's wall time and the top
kernels, beside each part's `device_*` keys.

The run fits BENCH_BUDGET_S (default 1140 s): per-section budgets of 480,
330 and 330 s clipped to the time left, the running summary written to
runs/bench/latest_torch.json after every section, and a SIGTERM/SIGALRM
handler that prints the summary line before it exits. A section that fails,
times out or leaves out a part is recorded under `errors`, and the script
then exits 1 after the summary line. Without CUDA and without --device it
raises; it never re-emits an earlier result.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
for _path in (ROOT, ROOT / "scripts"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

import bench_1m_torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from profile_torch_track import trace_summary  # noqa: E402

TOTAL_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1140"))
SECTION_BUDGETS_S = {"tracking": 480, "mapping": 330, "onemillion": 330}
LATEST = ROOT / "runs" / "bench" / "latest_torch.json"
# the parts each section must emit (bench.py's names)
SECTION_PARTS = {
    "tracking": ("tracking", "tracking_device", "tracking_device_converged",
                 "tracking_device_gn"),
    "mapping": ("mapping", "mapping_device"),
    "onemillion": ("onemillion", "onemillion_device"),
}
# the keys bench.py's `_emit` gives each part; every part here has them too
_TRACK_DEVICE_KEYS = ("device_track_ms", "device_fps_lower_bound", "max_evals", "method",
                      "scan_s")
BENCH_PY_KEYS = {
    "tracking": ("fps_enqueue", "mean_track_ms", "sync_track_ms", "sync_fps",
                 "n_evals_last_frame", "final_pose_err_m", "platform", "device"),
    "tracking_device": _TRACK_DEVICE_KEYS,
    "tracking_device_converged": _TRACK_DEVICE_KEYS,
    "tracking_device_gn": _TRACK_DEVICE_KEYS,
    "mapping": ("mapping_iter_ms", "mapping_passes_per_s", "op_point", "method"),
    "mapping_device": ("device_mapping_iter_ms", "device_mapping_passes_per_s", "method",
                       "scan_s"),
    "onemillion": ("capacity", "n_live", "render_ms_640x480", "compact_ms", "mapping_iter_ms",
                   "mapping_passes_per_s"),
    "onemillion_device": ("device_render_ms", "device_mapping_iter_ms",
                          "device_mapping_passes_per_s", "method"),
}
# marginal-rate lengths (n1, n2), bench.py's
TRACK_MARGINAL = {"tracking_device": (8, 32), "tracking_device_converged": (8, 32),
                  "tracking_device_gn": (4, 12)}
MAP_ITERS, MAP_MARGINAL = 30, (5, 20)
ONEM_RENDER_MARGINAL, ONEM_STEP_MARGINAL = (4, 12), (3, 9)
MAP_MAX_WARMUP, MAP_WARM_S = 6, 0.05  # bench.py's adaptive warm-up
ITERS_PER_PASS = 15  # mapping steps a pass (bench.py's passes/s)
TOP_KERNELS = 5


def render_config():
    """bench.py's RenderConfig of the tracking and mapping points."""
    from gslam_tpu_torch.ops.rasterize import RenderConfig

    return RenderConfig(tile_capacity=512, tile_chunk=50, pairs_per_gaussian=8)


def _emit(part, payload):
    print(json.dumps({"part": part, **payload}), flush=True)
    return payload


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launched(fn):
    """fn() and the blend launches it made."""
    from gslam_tpu_torch.ops import blend

    before = dict(blend.launches)
    out = fn()
    return out, {k: blend.launches[k] - before[k] for k in before}


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def _per(launches, n):
    return {k: v / n for k, v in launches.items()}


def _card(dev):
    """The part's device fields: platform, device name, timer, peak memory."""
    import torch

    on_card = dev.type == "cuda"
    return {"platform": dev.type,
            "device": torch.cuda.get_device_name(dev) if on_card else str(dev),
            "timer": "cuda_events" if on_card else "host_clock",
            "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated(dev))
            if on_card else None}


def marginal_rate(run, n1, n2, dev):
    """bench.py's marginal rate: run(n1, 0.0) once to warm up, then run(n1,
    1e-7) and run(n2, 2e-7), each timed (CUDA events on a card) up to one wait
    at its end. Returns ms per step, {"1": s, "2": s} and the two runs'
    results."""
    run(n1, 0.0)
    clock = bench_1m_torch.Clock(dev)
    times, outs = {}, {}
    for k, n in ((1, n1), (2, n2)):
        clock.start()
        outs[str(k)] = run(n, k * 1e-7)
        times[str(k)] = clock.stop() / 1e3
    return 1e3 * (times["2"] - times["1"]) / (n2 - n1), times, outs


def device_profile(fn, dev, per_name):
    """The counterpart of bench.py's device execution: fn() once under
    torch.profiler on the card. fn returns how many `per_name` units it ran.
    Off the card every figure is None (not measured)."""
    keys = ("device_busy_ms", "device_idle_share", "device_profiled_wall_ms",
            f"device_kernel_launches_per_{per_name}", "device_top_kernels_ms")
    if dev.type != "cuda":
        return dict.fromkeys(keys)
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per = fn()
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    s = trace_summary(prof, wall_ms, per, per_name)
    top = dict(list(s["device_ms_by_kernel"].items())[:TOP_KERNELS])
    return dict(zip(keys, (s["device_busy_ms"], s["device_idle_share"], wall_ms,
                           s[f"launches_per_{per_name}"], top)))


PROFILE_NOTE = ("device_busy_ms: the summed kernel durations of one more run under "
                "torch.profiler, outside the timed windows; device_idle_share: 1 - busy / "
                "that run's wall time (the profiler's host overhead included)")


# ---------------------------------------------------------------- tracking


def tracking_point(n_splats=cs.N_SPLATS, width=cs.W, height=cs.H, fx=cs.FX,
                   n_frames=cs.N_FRAMES, tcfg=None, device=None):
    """bench.py's tracking point (:106-128) on `device`: the map (seed 0), K,
    the tracking config (by default bench.py's: the default TrackingConfig
    with bench.py's RenderConfig), n_frames ground-truth poses chained by
    se3_exp(xi) @ cur with xi ~ N(0, 0.004) drawn after the map, and the
    generic render of all of them, clipped to [0, 1]."""
    import torch

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.core.transforms import se3_exp
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import render
    from gslam_tpu_torch.tracking.track import TrackingConfig

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    gmap = gaussian_map_from_numpy(
        cs.make_map_fields(n_splats, n_splats, rng, width=width, height=height, fx=fx),
        device=dev)
    K = torch.from_numpy(bench_1m_torch.intrinsics(width, height, fx)).to(dev)
    tcfg = tcfg or TrackingConfig(render=render_config())
    xis = rng.normal(scale=0.004, size=(n_frames, 6)).astype(np.float32)
    poses, cur = [], torch.eye(4)
    for xi in xis:
        cur = se3_exp(torch.from_numpy(xi)) @ cur
        poses.append(cur)
    poses = torch.stack(poses).to(dev)
    with torch.no_grad():
        out = render(**gmap.render_kwargs(), viewmats=poses,
                     Ks=K[None].expand(n_frames, 3, 3), width=width, height=height,
                     cfg=tcfg.render, device=dev)
    return gmap, K, tcfg, poses, torch.clamp(out.rgb, 0.0, 1.0)


def section_tracking(device=None, n_splats=cs.N_SPLATS, width=cs.W, height=cs.H, fx=cs.FX,
                     n_frames=cs.N_FRAMES, marginal=None, tcfg=None):
    """bench.py's section_tracking on the port; returns its parts. The
    converged and GN parts replace their fields in `tcfg` (tracking_point's
    default: bench.py's)."""
    import torch

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.tracking.track import (
        track_frame, track_frame_impl, track_frame_pyramid_impl,
    )

    marginal = marginal or TRACK_MARGINAL
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gmap, K, tcfg, poses, gt_imgs = tracking_point(n_splats, width, height, fx, n_frames, tcfg,
                                                   dev)
    eye, zeros = torch.eye(4, device=dev), torch.zeros(2, device=dev)
    parts = {}

    def track(prior, exposure, i):
        return track_frame(gmap, prior, exposure, gt_imgs[i], K, width, height, tcfg,
                           device=dev)

    track(eye, zeros, 0)  # warm-up, as bench.py's compile call
    _sync(dev)
    clock = bench_1m_torch.Clock(dev)

    def loop(wait_each_frame):
        prior, exposure, evals = eye, zeros, []
        for i in range(n_frames):
            r = track(prior, exposure, i)
            prior, exposure = r.pose, r.exposure
            evals.append(r.n_evals)
            if wait_each_frame:
                _sync(dev)
        return r, evals

    # (a) the chained loop, one wait at the end
    clock.start()
    (res, evals_a), launches_a = _launched(lambda: loop(False))
    dt = clock.stop() / 1e3
    # (b) a wait after every frame
    clock.start()
    loop(True)
    dt_sync = clock.stop() / 1e3

    pose_err = float(torch.linalg.norm(res.pose[:3, 3] - poses[-1][:3, 3]))
    parts["tracking"] = _emit("tracking", {
        "fps_enqueue": n_frames / dt,
        "mean_track_ms": 1e3 * dt / n_frames,
        "sync_track_ms": 1e3 * dt_sync / n_frames,
        "sync_fps": n_frames / dt_sync,
        "n_evals_last_frame": int(res.n_evals),
        "final_pose_err_m": pose_err,
        **_card(dev),
        "n_frames": n_frames, "n_evals_per_frame": evals_a,
        "blend_launches_per_frame": _per(launches_a, n_frames),
        "method": "(a) fps_enqueue / mean_track_ms: the chained loop with one wait at the "
                  "end; (b) sync_*: a wait after every frame. The tracker reads back once "
                  "per L-BFGS evaluation, so (a) is wall time with the host included, not an "
                  "enqueue rate",
    })

    # (c) marginal rates: chain n frames from the identity over imgs[i % n] + eps
    def chain(impl, cfg):
        def run(n, eps):
            def body():
                pose, exposure, evals = eye, zeros, []
                for i in range(n):
                    r = impl(gmap, pose, exposure, gt_imgs[i % n_frames] + eps, K, width,
                             height, cfg)
                    pose, exposure = r.pose, r.exposure
                    evals.append(r.n_evals)
                return evals
            evals, launches = _launched(body)
            return {"n_evals": evals, "blend_launches": launches}
        return run

    def one_frame(impl, cfg):
        return lambda: impl(gmap, eye, zeros, gt_imgs[0], K, width, height, cfg).n_evals

    gn_cfg = dataclasses.replace(tcfg, method="gn", gn_iters=8, pyramid_levels=3)
    converged = dataclasses.replace(tcfg, lbfgs_max_eval=36, lbfgs_max_iter=30)
    for name, cfg, impl in (("tracking_device", tcfg, track_frame_impl),
                            ("tracking_device_converged", converged, track_frame_impl),
                            ("tracking_device_gn", gn_cfg, track_frame_pyramid_impl)):
        n1, n2 = marginal[name]
        step_ms, times, runs = marginal_rate(chain(impl, cfg), n1, n2, dev)
        frames = n1 + n2
        launches = _add(dict(runs["1"]["blend_launches"]), runs["2"]["blend_launches"])
        parts[name] = _emit(name, {
            "device_track_ms": step_ms,
            "device_fps_lower_bound": 1e3 / max(step_ms, 1e-6),
            "max_evals": cfg.lbfgs_max_eval,
            "tracker": {"method": cfg.method, "pyramid_levels": cfg.pyramid_levels,
                        "gn_iters": cfg.gn_iters, "lbfgs_max_iter": cfg.lbfgs_max_iter},
            "method": f"marginal rate of chained runs of {n1} and {n2} frames from the "
                      "identity over imgs[i % n_frames] + eps, one wait at the end of each: "
                      "wall time with the host included (one readback per evaluation), not "
                      "device time. " + PROFILE_NOTE + " (one frame, frame 0 from the "
                      "identity)",
            "scan_s": times,
            "n_evals": {k: r["n_evals"] for k, r in runs.items()},
            "blend_launches_per_frame": _per(launches, frames),
            **device_profile(one_frame(impl, cfg), dev, "eval"),
            **_card(dev),
        })
    return parts


# ---------------------------------------------------------------- mapping


def mapping_point(cap=cs.MAP_CAP, n_live=cs.MAP_LIVE, width=cs.W, height=cs.H, fx=cs.FX,
                  render=None, device=None):
    """bench.py's `_mapping_op_point` on `device`: the map (seed 0), then 12
    uniform random keyframe images 1 cm apart in x in a 32-slot store, the
    window of slots 2-11 and `render` (by default bench.py's RenderConfig).
    The tuple of bench_1m_torch.build_point."""
    rng = np.random.default_rng(0)
    fields = cs.make_map_fields(cap, n_live, rng, width=width, height=height, fx=fx)
    images = [rng.random((height, width, 3)).astype(np.float32) for _ in range(cs.N_KF)]
    return bench_1m_torch.build_point(fields, images, width, height, fx, kf_cap=cs.KF_CAP,
                                      window=cs.WINDOW, kf_spacing=0.01,
                                      render=render or render_config(), device=device)


def _mapping_run(state, widx, wmask, K, width, height, cfg):
    """A marginal-rate run of mapping steps from `state`, each on keyframe
    images moved by eps (bench.py's scan body); returns the last total loss
    and the blend launches."""
    from gslam_tpu_torch.mapping.backend_ops import mapping_step

    def run(n, eps):
        def body():
            g, o, kf, p = state
            for _ in range(n):
                kf = kf._replace(images=kf.images + eps)
                g, o, kf, p, aux = mapping_step(g, o, kf, p, widx, wmask, K, width, height, cfg)
            return aux.total_loss
        loss, launches = _launched(body)
        return {"total_loss": loss, "blend_launches": launches}
    return run


def _step_profile(state, widx, wmask, K, width, height, cfg):
    from gslam_tpu_torch.mapping.backend_ops import mapping_step

    def fn():
        mapping_step(*state, widx, wmask, K, width, height, cfg)
        return 1
    return fn


def section_mapping(device=None, cap=cs.MAP_CAP, n_live=cs.MAP_LIVE, width=cs.W,
                    height=cs.H, fx=cs.FX, iters=MAP_ITERS, marginal=MAP_MARGINAL, render=None):
    """bench.py's section_mapping on the port; returns its parts."""
    import torch

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.mapping.backend_ops import mapping_step

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gmap, opt, kf, pose_opt, widx, wmask, K, cfg = mapping_point(cap, n_live, width, height,
                                                                 fx, render, dev)
    st = [gmap, opt, kf, pose_opt]

    def step():
        g, o, k2, p, aux = mapping_step(*st, widx, wmask, K, width, height, cfg)
        st[:] = [g, o, k2, p]
        return aux

    # adaptive warm-up, as bench.py: until a step takes under 0.05 s
    n_warm = 0
    for _ in range(MAP_MAX_WARMUP):
        tw = time.perf_counter()
        step()
        _sync(dev)
        n_warm += 1
        if time.perf_counter() - tw < MAP_WARM_S:
            break
    clock = bench_1m_torch.Clock(dev)
    clock.start()
    t0 = time.perf_counter()

    def timed():
        return [step() for _ in range(iters)]
    auxes, launches = _launched(timed)
    device_ms = clock.stop() / iters
    map_ms = 1e3 * (time.perf_counter() - t0) / iters
    losses = [float(a.total_loss) for a in auxes]
    parts = {"mapping": _emit("mapping", {
        "mapping_iter_ms": map_ms,
        "mapping_passes_per_s": 1.0 / (ITERS_PER_PASS * map_ms / 1e3),
        "op_point": f"{cs.WINDOW}-cam window, {cap} cap ({n_live} live), {width}x{height}, "
                    f"{ITERS_PER_PASS} iters/pass, vs >=10 Hz target",
        "method": f"{n_warm} warm-up steps, then {iters} steps with one wait at the end: "
                  "host clock (mapping_iter_ms) and CUDA events from the first step's start "
                  "to the last step's end (cuda_events_iter_ms); the step syncs the host "
                  "3 times, so both are wall time with the host included",
        "cuda_events_iter_ms": device_ms if dev.type == "cuda" else None,
        "n_warmup": n_warm, "total_loss_first_last": [losses[0], losses[-1]],
        "blend_launches_per_step": _per(launches, iters),
        **_card(dev),
    })}

    n1, n2 = marginal
    step_ms, times, runs = marginal_rate(
        _mapping_run(list(st), widx, wmask, K, width, height, cfg), n1, n2, dev)
    launches = _add(dict(runs["1"]["blend_launches"]), runs["2"]["blend_launches"])
    parts["mapping_device"] = _emit("mapping_device", {
        "device_mapping_iter_ms": step_ms,
        "device_mapping_passes_per_s": 1.0 / (ITERS_PER_PASS * step_ms / 1e3),
        "method": f"marginal rate of runs of {n1} and {n2} mapping steps, one wait at the "
                  "end of each: wall time with the host included, not device time. "
                  + PROFILE_NOTE + " (one step)",
        "scan_s": times,
        "total_loss_last": {k: float(r["total_loss"]) for k, r in runs.items()},
        "blend_launches_per_step": _per(launches, n1 + n2),
        **device_profile(_step_profile(st, widx, wmask, K, width, height, cfg), dev, "step"),
        **_card(dev),
    })
    return parts


# -------------------------------------------------------------- onemillion


def onemillion_arrays(cap=bench_1m_torch.CAP, n_live=bench_1m_torch.N_LIVE,
                      width=bench_1m_torch.W, height=bench_1m_torch.H, fx=bench_1m_torch.FX):
    """bench.py's 1M point as numpy: bench_1m_torch.point_arrays draws in
    bench.py's order, and bench.py scales the colors by 1.5 (bench_1m.py
    does not); the images are drawn after the colors, so this is exact."""
    fields, images = bench_1m_torch.point_arrays(cap, n_live, width, height, fx)
    fields["logit_colors"] = fields["logit_colors"] * np.float32(1.5)
    return fields, images


def section_onemillion(device=None, cap=bench_1m_torch.CAP, n_live=bench_1m_torch.N_LIVE,
                       width=bench_1m_torch.W, height=bench_1m_torch.H, fx=bench_1m_torch.FX,
                       iters=bench_1m_torch.ITERS, render_marginal=ONEM_RENDER_MARGINAL,
                       step_marginal=ONEM_STEP_MARGINAL):
    """bench.py's section_onemillion on the port; returns its parts."""
    import torch

    from gslam_tpu_torch import resolve_device

    dev = resolve_device(device)
    fields, images = onemillion_arrays(cap, n_live, width, height, fx)
    point = bench_1m_torch.build_point(fields, images, width, height, fx, device=dev)
    del fields, images
    gmap, _opt, _kf, _pose_opt, widx, wmask, K, cfg = point
    detail, steps, st = bench_1m_torch.measure(point, width, height, iters=iters)
    losses = [s["total_loss"] for s in steps]
    parts = {"onemillion": _emit("onemillion", {
        "capacity": detail["capacity"],
        "n_live": detail["n_live"],
        "render_ms_640x480": detail["render_ms"],
        "compact_ms": detail["compact_ms"],
        "mapping_iter_ms": detail["mapping_iter_ms"],
        "mapping_passes_per_s": 1.0 / (ITERS_PER_PASS * detail["mapping_iter_ms"] / 1e3),
        "width": width, "height": height,
        "cuda_events_iter_ms": detail["device_mapping_iter_ms"],
        "render_finite": detail["render_finite"],
        "total_loss_first_last": [losses[0], losses[-1]],
        "n_steps": len(steps),
        "blend_launches_per_render": detail["blend_launches_per_render"],
        "blend_launches_per_step": detail["blend_launches_per_step"],
        "method": "scripts/bench_1m_torch.py's measure: 10 renders and 5 compact_maps "
                  f"between CUDA events, an adaptive warm-up, then {iters} steps with one "
                  "wait at the end (host clock; cuda_events_iter_ms by CUDA events); "
                  "wall time with the host included",
        **_card(dev),
    })}

    def render_run(n, eps):
        def body():
            for i in range(n):
                # bench_1m_torch moves the view by i * 1e-6 m in x: eps rides on it
                out = bench_1m_torch.render_view(gmap, K, width, height, cfg, i + eps * 1e6)
            return out.rgb[0, 0, 0, 0]
        px, launches = _launched(body)
        return {"pixel": px, "blend_launches": launches}

    def render_profile():
        bench_1m_torch.render_view(gmap, K, width, height, cfg)
        return 1

    (r1, r2), (s1, s2) = render_marginal, step_marginal
    r_ms, r_times, r_runs = marginal_rate(render_run, r1, r2, dev)
    m_ms, m_times, m_runs = marginal_rate(
        _mapping_run(list(st), widx, wmask, K, width, height, cfg), s1, s2, dev)
    r_prof = device_profile(render_profile, dev, "render")
    m_prof = device_profile(_step_profile(st, widx, wmask, K, width, height, cfg), dev,
                            "step")
    parts["onemillion_device"] = _emit("onemillion_device", {
        "device_render_ms": r_ms,
        "device_mapping_iter_ms": m_ms,
        "device_mapping_passes_per_s": 1.0 / (ITERS_PER_PASS * m_ms / 1e3),
        "method": f"marginal rates of runs of {r1} and {r2} renders and of {s1} and {s2} "
                  "mapping steps, one wait at the end of each: wall time with the host "
                  "included, not device time. " + PROFILE_NOTE + " (one render; one step)",
        "scan_s": {"render": r_times, "step": m_times},
        "render_pixel": {k: float(r["pixel"]) for k, r in r_runs.items()},
        "total_loss_last": {k: float(r["total_loss"]) for k, r in m_runs.items()},
        "blend_launches_per_render": _per(_add(dict(r_runs["1"]["blend_launches"]),
                                               r_runs["2"]["blend_launches"]), r1 + r2),
        "blend_launches_per_step": _per(_add(dict(m_runs["1"]["blend_launches"]),
                                             m_runs["2"]["blend_launches"]), s1 + s2),
        "render": r_prof,
        **m_prof,
        **_card(dev),
    })
    return parts


SECTIONS = {"tracking": section_tracking, "mapping": section_mapping,
            "onemillion": section_onemillion}


# ------------------------------------------------------------ orchestrator


def finite(value) -> bool:
    """Every number in a part (nested) is finite; None is 'not measured'."""
    if isinstance(value, dict):
        return all(finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(finite(v) for v in value)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return math.isfinite(value)
    return True


def _summarize(parts: dict) -> dict:
    """The headline line from whatever parts have arrived, with bench.py's
    selection: GN pyr3 x 8 if that part landed, else the full budget."""
    gn = parts.get("tracking_device_gn", {})
    td = parts.get("tracking_device", {})
    fps_gn = gn.get("device_fps_lower_bound", 0.0) or 0.0
    fps_lb = td.get("device_fps_lower_bound", 0.0) or 0.0
    what = ("tracking FPS on one CUDA card: marginal rate of two chained runs of "
            "track_frame, wall time with the host included (one readback per "
            "evaluation), frozen 50k-splat map @320x240, ")
    if fps_gn:
        metric, fps = what + "GN pyr3x8 operating point (1 card)", fps_gn
    else:
        metric, fps = what + "full eval budget (1 card)", fps_lb
    return {
        "metric": metric,
        "value": fps,
        "unit": "fps",
        "vs_baseline": round(fps / 30.0, 4) if fps else 0.0,
        "detail": parts,
    }


def _flush_latest(parts: dict):
    LATEST.parent.mkdir(parents=True, exist_ok=True)
    LATEST.write_text(json.dumps(_summarize(parts)))


def _error(parts, text):
    parts.setdefault("errors", []).append(text)


def run_section(section, budget, device, parts, live):
    """`section` in a fresh process within `budget` s: its part lines are
    printed as they land and merged into `parts`; a failure, a timeout or a
    missing part is recorded under parts["errors"]."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--section", section]
    if device is not None:
        cmd += ["--device", device]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT)
    live["proc"] = proc
    err_tail = collections.deque(maxlen=8)

    def read_parts():
        for line in proc.stdout:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            name = d.pop("part", None)
            if name:
                parts[name] = d
                print(line, flush=True)

    def read_errors():
        for line in proc.stderr:
            err_tail.append(line.rstrip())
            print(line, end="", file=sys.stderr, flush=True)

    readers = [threading.Thread(target=f, daemon=True) for f in (read_parts, read_errors)]
    for t in readers:
        t.start()
    faults = []
    try:
        rc = proc.wait(timeout=budget)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
        faults.append(f"timeout after {budget:.0f}s")
    for t in readers:
        t.join()
    live["proc"] = None
    if rc:
        faults.append(f"exit code {rc}: " + " | ".join(err_tail)[-600:])
    missing = [p for p in SECTION_PARTS[section] if p not in parts]
    if missing:
        faults.append(f"no part {', '.join(missing)}")
    if faults:
        _error(parts, f"{section}: " + "; ".join(faults))


def run_sections(parts, device, t_start, live):
    for section, budget in SECTION_BUDGETS_S.items():
        left = TOTAL_BUDGET_S - (time.time() - t_start)
        budget = min(budget, left - 20)
        if budget < 60:
            _error(parts, f"{section}: skipped, {left:.0f}s left of the "
                          f"{TOTAL_BUDGET_S:.0f}s total budget")
            continue
        t0 = time.time()
        run_section(section, budget, device, parts, live)
        parts.setdefault("section_s", {})[section] = time.time() - t0
        _flush_latest(parts)
    return parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--section", choices=tuple(SECTIONS), default=None,
                    help="run one section in this process")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises where there is none)")
    args = ap.parse_args(argv)

    from gslam_tpu_torch import resolve_device

    dev = resolve_device(args.device)  # raises here without CUDA and --device
    if args.section:
        SECTIONS[args.section](device=dev)
        return 0

    t_start = time.time()
    parts = {"nvidia_smi": bench_1m_torch.nvidia_smi() if dev.type == "cuda" else None}
    live = {"proc": None}

    def bail(signum, frame):
        # an external timeout: print what has landed, stop the section, exit 1
        if live["proc"] is not None:
            live["proc"].kill()
        _error(parts, f"interrupted by signal {signum}")
        print(json.dumps(_summarize(parts)), flush=True)
        os._exit(1)

    saved = {sig: signal.signal(sig, bail) for sig in (signal.SIGTERM, signal.SIGALRM)}
    signal.alarm(int(TOTAL_BUDGET_S + 120))
    try:
        run_sections(parts, args.device, t_start, live)
    finally:
        signal.alarm(0)
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    result = _summarize(parts)
    print(json.dumps(result), flush=True)
    return 1 if parts.get("errors") else 0


if __name__ == "__main__":
    sys.exit(main())
