#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gslam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. env: the card (nvidia-smi name and power limit), CUDA and nvcc
     versions; builds the blend and binning kernels from
     gslam_tpu_torch/csrc/ (`build_s`, `binning_build_s`).
  2. kernels: each CUDA kernel against its plain PyTorch version on real
     gathered rows of a 50k-splat map (T=300 tiles, M=512, and the 160x120
     pyramid level, T=80), with times from CUDA events (`ms`, one launch
     between two events; `ms_back_to_back`); for each kernel
     also the share of (warp, splat) pairs its cull keeps with its warp
     footprint, by the cull's plain version (which must keep every pair
     with a pixel that passes the alpha test), and its registers, shared
     memory and resident blocks per SM; for blend_fwd the depth segments
     per tile that the card's rule gives. Also on one camera's rows of the
     mapping point's 100k-live map (T=300, M=512), the lists that mapping
     feeds the kernels (phase 14 holds the 1M shape the same way).
  2a. binning: ops/binning.py's bin_cameras (csrc/binning.cu) against the
     plain bin_gaussians camera by camera on the card, and against
     bench_binning.py's sync-free torch ops, bit for bit in every field, on
     the real inputs of a tracking level (1 camera of the 50k map, M=512)
     and of the mapping point's window (10 cameras, 131,072 slots); phase
     14 adds the 1M window (10 cameras, 2^20 slots at 640x480, M=256).
     Times: the call and the plain path by CUDA events, each kernel's
     device time by the profiler beside the torch-ops stage that does its
     work, and the bound from the bytes the call needs (binning_bytes).
     Every path below reads binning's launches as it reads the blend's
     (each entry point once a call; a mapping step one call).
  3. reference: track_frame on a small scene on the card and on the CPU
     (plain blend); the two poses must agree.
  4. tracking: the first main path. BASELINE config 1 (N=50,000 splats,
     320x240, fx=280, tile_capacity=512): 10 ground-truth frames rendered by
     the port, tracked chained with the default igs configuration; then one
     frame with a 3-level pyramid. The kernels' launch counters must show
     one forward + one backward per evaluation.
  4a. gn_reference: flat Gauss-Newton (gn_iters=10) on
     tests/test_gauss_newton.py's scene (96x72), mono and RGB-D, on the card
     and on the CPU: f0 and the first JtJ, Jtr within rtol 1e-4, the accept
     sequence and render passes equal with each loss within 1e-4 of f0
     (where they part is printed; the losses just before it must be below
     1e-4 of f0), the final pose within 1e-4 m / 1e-4 rad.
  4b. gn: the same 10 chained frames tracked with method="gn", pyr3 x 8 LM
     iterations (bench.py's accuracy-proven point) and flat x 10: ms per
     frame, host syncs, LM iterations and render passes per level, peak
     memory; final error < 1 cm, no rejection, no blend launch (GN blends
     through the forward-mode route).
  5. mapping_reference: 3 mapping_steps of a small scene (a window of 3
     keyframes and a padded slot) on the card and on the CPU: losses, the
     first step's gradient norms, radii and n_touched must agree.
  6. mapping: the second main path, at bench.py's mapping point (capacity
     131,072, 100,000 live, a 10-keyframe window at 320x240, fx=280,
     tile_capacity=512): 2 warm-up steps, then one pass of 15 mapping_steps
     between CUDA events, from a map whose colors were perturbed away from
     the one that rendered the keyframes. Each step must launch each kernel
     once per window camera, and the photometric loss must fall.
  7. slam_reference: 4 frames of a small synthetic room (64x48,
     tests/test_fused.py's small configuration), monocular and RGB-D,
     stepped on the card, each frame stepped again on the CPU from a copy
     of the card's state before it, both drawing from the CPU generator:
     per frame the keyframe flag, keyframe count, inserted splats, mapping
     iterations and live count must be equal (live counts may differ only
     by opacity-prune ties: each splat kept on one side only lies on the
     two sides of the threshold, within the largest opacity gap between the
     sides over the splats both kept); the tracker's evaluations
     must agree until its host-side line search branches apart (never
     before its first trial), and where none parts the pose must be within
     2 mm and 2 mrad. A whole monocular CPU run beside the card's must take
     the same keyframes, inserts and mapping iterations; its pose and
     live-count gaps are printed. bootstrap_stepped: each of the RGB-D frame
     0's 40 mapping iterations is also run on the CPU from a copy of the
     card's state before it (mapping_step_agreement, STEP_TOL): losses,
     gradients, tile lists, n_pairs, radii > 0, n_touched, the decay mask,
     Adam's step signs and the updated fields must agree but for recorded
     ties (a value within float32 rounding of its threshold on both sides);
     the first iteration and output that part beyond that is printed, and
     must not exist.
  8. slam: the third main path. FusedSlam.run over 12 frames of the port's
     synthetic room (10,000 splats, 320x240, fx=288, ~1.5 cm per frame,
     monocular) with every FusedConfig, TrackingConfig and MapConfig default
     but RenderConfig(tile_capacity=512, pairs_per_gaussian=8), on 131,072
     slots and a 32-slot keyframe store; chunk=1, sync_every=4,
     eval_stride=4. Per frame: CUDA-event ms and host syncs of tracking,
     keyframe decision + insertion and the mapping pass; launches, peak
     memory, C, N, ATE, PSNR. Checks: finite poses, no abort, C >= 2, >= 5,000
     inserted and none dropped, N > 500, ATE < 0.06 m, and launch counters
     equal to what the evaluations, mapping iterations, decision renders and
     eval renders predict.
  9. actor_reference: the actor runtime (SlamSystem) over 4 frames of a
     small synthetic room (64x48) in four modes (igs, method="warp",
     enable_pgo, RGB-D), each frame also run on the CPU from a copy of the
     card's system before it (the same draws; the CPU's backend takes the
     card's tracked pose): per frame the keyframe flag and the keyframe,
     live and health counts must be equal; the tracker's
     evaluations must agree until its host-side line search branches apart,
     and where none parts the pose must be within 2 mm / 2 mrad.
     pose_refinement_lbfgs over each run's final window on the card and
     the CPU: its first evaluation (loss, gradient) within rtol 1e-4, the
     frozen and padded slots bit for bit. A threaded run (synchronous=False)
     must finish with finite poses.
 10. actor: the fourth main path, main.py's default. SlamSystem over the slam
     phase's 12 frames with every SlamConfig, TrackingConfig and MapConfig
     default but the render config, 131,072 slots, a 32-slot keyframe
     store, telemetry off, eval_stride=4. Per frame: CUDA-event ms and host
     syncs of track, insert_decision, map, prune, pose_refine and sync;
     pose-refinement evaluations, launches, peak memory, C, N, ATE, PSNR.
     Checks: finite poses, not diverged, C >= 2, ATE < 0.06 m, and launch
     counters equal to what the tracking and refinement evaluations, the
     mapping iterations and the view, decision and eval renders predict.
 11. sharded_reference: the multi-device package (parallel/) on
     tests/test_sharded_slam.py's 64x48 scene, two depth bands on the card
     (one per card where the host has two, else both on cuda:0) against two
     on ["cpu"] * 2: gauss_render (rgb, alpha 2e-5; depth, beta 1e-4), one
     make_gauss_mapping_step and one dp_mapping_train_step (losses rtol
     1e-5, first moments, parameters where |g| > 1e-4), the banded tracking
     loss and gradient at x0 (rtol 1e-4); two bands against one on the card
     (unsaturated lists, 2e-5 / 1e-4); then 4 ShardedSlam frames (pose
     graph and densification on), each also stepped on the CPU from a copy
     of the card's state before it: keyframe flag, C, live, health, loop
     closures equal, the tracker as in slam_reference.
 12. sharded: the sixth main path. ShardedSlam.run over the slam phase's
     frames with every config default but the render config, 131,072 slots
     in two bands of 65,536, a 32-slot ring, eval_stride 4. Per frame:
     CUDA-event ms and host syncs of repartition, track, kd_stats, insert,
     map and densify/prune, evaluations and mapping iterations; launches,
     peak memory, C, N, ATE, PSNR, loop closures. Checks: finite poses,
     health 0, C >= 2, ATE < 0.06 m, launches equal to 2 x (evaluations +
     window x mapping iterations + decision and eval renders) forwards and 2
     x (evaluations + window x mapping iterations) backwards. Then one
     dp_mapping_train_step (two camera chunks) and one hybrid 2x2 step at
     the mapping point, each against the same step on one device (the
     hybrid one against the same two bands unsplit on cuda:0): losses rtol
     1e-5, parameters where |g| > 1e-4; their ms, and the one-band loss.
 13. cli: the fifth main path, main_torch.main in this process as the
     repo's runs use main.py: the raytraced room at 320x240, 8 frames,
     --use-gt-depths and GN pyr3 x 8, every other flag main.py's default; the
     actor runtime, then the same frames through an npz (save_dataset_npz,
     under chiprun_out/cli/) with --fused --chunk 1 --sync-every 4. Wall
     time, frame ms, C, N, ATE (printed, not bounded), PSNR/SSIM, launches;
     checks artifacts, a finite [8, 4, 4] trajectory and both kernels
     launched in each run. Then both kernels against their plain version
     (as in phase 2) on the actor run's keyframe rows at this path's own
     shape, main.py's default tile_capacity (T=300, M=256, where blend_fwd
     takes its own depth segments).
 14. onemillion: the seventh main path, BASELINE config 3's scale point
     (scripts/bench_1m_torch.py in this process: 2^20 slots, 1,000,000
     live, 640x480, fx 560, tile_capacity 256, 4 pairs per splat, a window
     of 10 of 12 keyframes): binning held as in phase 2a on the window's
     inputs of the fresh map, then the script's line (render, compact and
     step ms, passes/s, peak memory) plus blend launches per render (1 + 0)
     and per mapping step (10 + 10), both checked, one binning call a
     render and a step, finite losses and parameters,
     the photometric loss of the first and last 3 steps, the largest pair
     count against the 4,194,304-pair budget and the tiles over capacity in
     each window camera. The point is built once; the kernels are held
     as in phase 2 on the first window camera's rows (640x480: T=1200,
     M=256) of the fresh map before the path runs and of the map its
     mapping steps leave.
 15. scripts: the port's tools on the card, in this process:
     study_tracking_torch oracle at its defaults over 14 frames (160x120,
     4,000 splats, motion_scale 0.045, 200 evaluations: every per-frame error
     finite, median < 1 cm, largest < 5 cm), demo_track_torch (the pose
     recovered, its PNGs in a temporary directory) and repro_f16_torch (its
     four lines, every objective finite).
 16. bench: the eighth main path, bench_torch.py's tracking, mapping and
     onemillion sections in this process at full width (BENCH_DEPTH: loops
     of 3 frames, marginal lengths 2 against 4 igs frames, 1 against 3 GN
     frames and 5 against 10 mapping steps, 3 timed steps at 1M): every
     part of bench.py with its keys, finite, timed by CUDA events, with a
     profiled device busy time; launches of each igs frame equal to its
     evaluations, none in GN, 10 + 10 a mapping step, 1 + 0 a 1M render; the
     headline is the GN part's rate.
Then one `kernels` line: blend_fwd, blend_bwd, bin_count, bin_emit and
bin_tile_lists with their launches by path, ms, plain_ms and bound_ms (the
binning kernels' at the 1M window, each path's shape under by_shape).
The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero before it. Imports torch and the port only (no JAX).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): float32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# Operations per (pixel, splat) pair, counted from csrc/blend.cu (one per
# add, multiply, compare, select or transcendental): every pair evaluates the
# Gaussian falloff; a pair that passes the alpha test ("ok") also does the
# transmittance and accumulation work.
FWD_OPS_PAIR, FWD_OPS_OK = 16, 16
BWD_OPS_PAIR, BWD_OPS_OK = 32, 50

W, H, FX, N_SPLATS, N_FRAMES = 320, 240, 280.0, 50_000, 10
# bench.py's mapping operating point (section_mapping)
MAP_CAP, MAP_LIVE, KF_CAP, WINDOW, N_KF = 131_072, 100_000, 32, 10, 12
SLAM_FRAMES = 12  # the fused SLAM path's sequence (same capacity and store)
SHARDED_FRAMES = SLAM_FRAMES  # the sharded path walks the same sequence


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(phase, **payload):
    print(json.dumps({"phase": phase, **payload}), flush=True)


def make_map_fields(cap, n_live, rng, scale_lo=0.004, scale_hi=0.016,
                    z_hi=4.5, opacity=1.5, width=W, height=H, fx=FX):
    """The benchmark's synthetic map (bench.py `_make_map`), as numpy fields:
    splats spread over the frustum of a width x height view with focal
    length fx, at depths 1.2-z_hi."""
    z = rng.uniform(1.2, z_hi, cap).astype(np.float32)
    u = rng.uniform(0, width, cap).astype(np.float32)
    v = rng.uniform(0, height, cap).astype(np.float32)
    means = np.stack([(u - width / 2) * z / fx, (v - height / 2) * z / fx, z], -1)
    alive = np.zeros(cap, bool)
    alive[:n_live] = True
    return dict(
        means=means.astype(np.float32),
        quats=rng.normal(size=(cap, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(scale_lo, scale_hi, (cap, 3)) * z[:, None])
        .astype(np.float32),
        logit_opacities=np.full((cap,), opacity, np.float32),
        logit_colors=(rng.normal(size=(cap, 3)).astype(np.float32) * 1.5),
        log_uncertainties=np.zeros((cap,), np.float32),
        alive=alive,
    )


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median of `reps` CUDA-event timings of fn() (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_back_to_back(fn, reps=20, warmup=3, rounds=5):
    """Time per call of fn() (ms): in each of `rounds` rounds, `reps` calls
    back to back between two CUDA events; the median over the rounds. The
    host enqueues ahead of the card, so this leaves out the host's work
    before each launch that cuda_ms's events also count."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def phase_env():
    import torch

    from gslam_tpu_torch.ops import cuda_build

    smi = nvidia_smi_line()
    print(smi, flush=True)
    nvcc = cuda_build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    cuda_build.load("blend")
    t1 = time.perf_counter()
    cuda_build.load("binning")
    emit("env", nvidia_smi=smi, torch=torch.__version__, torch_cuda=torch.version.cuda,
         nvcc=ver[-1] if ver else None, device=torch.cuda.get_device_name(0),
         build_s=t1 - t0, binning_build_s=time.perf_counter() - t1)
    return smi


def gathered_rows(gmap, pose, K, width, height, cfg):
    """Real blend inputs: the map's tile rows projected at `pose`."""
    import torch

    from gslam_tpu_torch.ops.rasterize import compute_bins
    from gslam_tpu_torch.ops.track_fused import gather_tracking_tiles, tracking_rows

    bins = compute_bins(gmap.means, gmap.quats, gmap.log_scales, gmap.alive,
                        pose[None], K[None], width, height, cfg, radius_scale=1.5)
    with torch.no_grad():
        tg = gather_tracking_tiles(gmap, bins)
        return [x.contiguous() for x in tracking_rows(tg, pose, K, width, height, cfg)]


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


def compare_and_time(rows, ts, tiles_x, cfg, gen, fwd=None, bwd=None):
    """Kernel vs plain (float32, and float64 as the yardstick) for the blend
    pair at one shape; times both. `fwd` and `bwd` launch another build of a
    kernel with blend_fwd_cuda's or blend_bwd_cuda's arguments
    (bench_blend.py)."""
    import torch

    from gslam_tpu_torch.ops import blend

    fwd = fwd or blend.blend_fwd_cuda
    bwd = bwd or blend.blend_bwd_cuda
    T, _, M = rows[0].shape
    P = ts * ts
    args = (cfg.alpha_cut, cfg.alpha_clamp, cfg.visibility_min_T)
    # cotangents of a mean loss over the image's pixels
    g = [torch.randn(T, P, 5, device="cuda", generator=gen) / (W * H),
         torch.randn(T, P, device="cuda", generator=gen) / (W * H)]
    rows64 = [x.double() for x in rows]
    g64 = [x.double() for x in g]
    res = {"T": T, "M": M}
    pairs = [
        ("blend_fwd",
         lambda: fwd(*rows, ts, tiles_x, *args),
         lambda: blend.blend_fwd_plain(*rows, ts, tiles_x, *args),
         lambda: blend.blend_fwd_plain(*rows64, ts, tiles_x, *args)),
        ("blend_bwd",
         lambda: bwd(*rows, *g, ts, tiles_x, *args[:2]),
         lambda: blend.blend_bwd_plain(*rows, *g, ts, tiles_x, *args[:2]),
         lambda: blend.blend_bwd_plain(*rows64, *g64, ts, tiles_x, *args[:2])),
    ]
    for name, kern, plain, ref in pairs:
        k_out, p_out, r_out = kern(), plain(), ref()
        torch.cuda.synchronize()
        max_abs, worst = 0.0, []
        for k, p, r in zip(k_out, p_out, r_out):
            check(bool(torch.isfinite(k.float()).all()), f"{name}: non-finite output")
            if k.dtype == torch.int32:  # n_touched: T on visibility_min_T to rounding
                diff = (k - p).abs()
                check(diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3,
                      f"{name}: n_touched differs beyond 1 pixel on 0.1% of slots")
                continue
            max_abs = max(max_abs, _err(k, p))
            # beyond a relative 1e-4 (the kernel sums up to M log1p terms
            # one by one in float32, 512 * 6e-8 = 3e-5; torch sums pairwise)
            # the kernel may be at most twice as far from float64 as the
            # float32 plain version, plus 1e-6 of the output's range
            limit = 2 * _err(p, r) + 1e-6 * r.abs().max().item()
            excess = ((k.double() - r).abs() - 1e-4 * r.abs()).max().item()
            worst.append(excess / limit if limit > 0 else 0.0)
            check(excess <= limit, f"{name}: error {excess} vs float64 above {limit}")
        del k_out, p_out, r_out
        res[name] = {
            "max_abs_err": max_abs, "err_over_limit": max(worst),
            "ms": cuda_ms(kern), "ms_back_to_back": cuda_ms_back_to_back(kern),
            "plain_ms": cuda_ms(plain, reps=20, warmup=1),
        }
    # the bound: this run's data decides how many pairs pass the alpha test
    ok = blend._alpha(*rows[:3], ts, tiles_x, cfg.alpha_cut, cfg.alpha_clamp)[4]
    n_pairs, n_ok = T * P * M, int(ok.sum().item())
    in_bytes = 4 * 11 * T * M
    costs = {
        "blend_fwd": (in_bytes + 4 * (T * P * 6 + T * M),
                      FWD_OPS_PAIR * n_pairs + FWD_OPS_OK * n_ok),
        "blend_bwd": (in_bytes + 4 * T * P * 6 + 4 * 11 * T * M,
                      BWD_OPS_PAIR * n_pairs + BWD_OPS_OK * n_ok),
    }
    for name, (nbytes, ops) in costs.items():
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_F32_OPS
        res[name].update(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes > t_ops else "operations")
    res["pairs"], res["ok_pairs"] = n_pairs, n_ok
    # each kernel's per-warp cull, by its plain version, with the kernel's
    # warp footprint: the (warp, splat) pairs it keeps must hold every pair
    # with a pixel that passes the alpha test (the kernels' own outputs are
    # held to float64 above)
    S = blend.fwd_segments(T, M, ts)
    for name, fp, launch in (("blend_fwd", blend.FWD_FOOTPRINT, S), ("blend_bwd", None, 1)):
        keep = blend.warp_cull_plain(*rows[:3], ts, tiles_x, cfg.alpha_cut, footprint=fp)
        live = ok[:, blend.warp_pixels(ts, fp, ok.device)].any(2)
        check(not bool((live & ~keep).any()), f"{name}: the plain cull drops a live pair")
        res[name].update(cull_survival=keep.float().mean().item(),
                         live_share=live.float().mean().item(),
                         resources=resources(name, M, ts, launch))
    res["blend_fwd"]["segments"] = S
    return res


def resources(name, M, ts, S=1, lib=None):
    """What kernel `name` takes on this card at its launch shape (M, ts and,
    for blend_fwd, S depth segments): registers per thread, dynamic shared
    memory per block, local (spill) bytes per thread and resident blocks
    per SM (csrc/blend.cu blend_resources; `lib` another build of it)."""
    import ctypes

    from gslam_tpu_torch.ops import cuda_build

    fn = (lib or cuda_build.load("blend")).blend_resources
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(("blend_fwd", "blend_bwd").index(name), M, ts, S, out)
    check(err == 0, f"blend_resources({name}): CUDA error {err}")
    return dict(regs_per_thread=out[0], smem_bytes_per_block=out[1],
                local_bytes_per_thread=out[2], blocks_per_sm=out[3], threads_per_block=ts * ts * S)


def kernel_shapes(gmap, K, tcfg):
    """The blend's real inputs at the two shapes the main path gives it:
    (rows, ts, tiles_x, cfg) at full resolution (T=300, M=512) and at
    pyramid level 1 (160x120, 10x8 tiles, the coarse-level capacity)."""
    import torch

    from gslam_tpu_torch.tracking.track import _halve_K

    cfg = tcfg.render
    ts = cfg.tile_size
    eye = torch.eye(4, device="cuda")
    cfg1 = dataclasses.replace(cfg, tile_capacity=min(cfg.tile_capacity * 4, 512))
    return [(gathered_rows(gmap, eye, K, W, H, cfg), ts, -(-W // ts), cfg),
            (gathered_rows(gmap, eye, _halve_K(K), W // 2, H // 2, cfg1), ts,
             -(-(W // 2) // ts), cfg1)]


def mapping_rows(point):
    """The blend's rows of the mapping window's first camera, as the
    generic render gathers them (the 100k-live map, T=300, M=512)."""
    import torch

    from gslam_tpu_torch.ops.rasterize import render_rows

    gmap, _opt, kf, _pose_opt, widx, _wmask, K, cfg = point
    ts = cfg.render.tile_size
    with torch.no_grad():
        r = render_rows(**gmap.render_kwargs(), viewmats=kf.poses()[widx[:1]],
                        Ks=K[None], width=W, height=H, cfg=cfg.render)
    return [r.xy, r.con, r.op, r.feat], ts, -(-W // ts), cfg.render


def onemillion_rows(gmap, kf, widx, K, cfg, width, height):
    """The blend's rows of the 1M map's first window camera
    (scripts/bench_1m_torch.py's point, 640x480: T=1200, M=256), as the
    generic render gathers them."""
    import torch

    from gslam_tpu_torch.ops.rasterize import render_rows

    ts = cfg.render.tile_size
    with torch.no_grad():
        r = render_rows(**gmap.render_kwargs(), viewmats=kf.poses()[widx[:1]], Ks=K[None],
                        width=width, height=height, cfg=cfg.render)
    return [r.xy, r.con, r.op, r.feat], ts, -(-width // ts), cfg.render


TOLERANCE = ("float outputs: max(|kernel - fp64| - 1e-4 |fp64|) <= 2 max|plain32 - fp64| "
             "+ 1e-6 max|fp64|; n_touched within 1 on <= 0.1% of slots")


def phase_kernels(gmap, K, tcfg, point, smi):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    full, half = (compare_and_time(*shape, gen) for shape in kernel_shapes(gmap, K, tcfg))
    check(full["T"] == 300 and full["M"] == 512 and half["T"] == 80,
          f"unexpected shapes {full['T']}x{full['M']}, {half['T']}")
    mapping = compare_and_time(*mapping_rows(point), gen)
    check(mapping["T"] == 300 and mapping["M"] == 512,
          f"unexpected mapping shape {mapping['T']}x{mapping['M']}")
    emit("kernels_vs_plain", nvidia_smi=smi, full_res=full, pyramid_l1=half,
         mapping_full_res=mapping, tolerance=TOLERANCE)
    return {"tracking_full_res": full, "pyramid_l1": half, "mapping_full_res": mapping}


# ------------------------------------------------------------------ binning

# binning's hand-written entry points and their CUDA kernels (bin_scan and
# bin_sort call cub); an entry point launches once per bin_cameras call
BIN_KERNELS = {"bin_count": "bin_count_kernel", "bin_emit": "bin_emit_kernel",
               "bin_tile_lists": "bin_tile_lists_kernel"}
BIN_LAUNCHES = {}  # path: binning's launches, read just after the path ran


def reset_launches():
    """Set the blend and binning launch counters to 0."""
    from gslam_tpu_torch.ops import binning, blend

    blend.reset_launches()
    binning.reset_launches()


def binning_launches(path, add=False):
    """Binning's launches since reset_launches, kept as `path`'s (added to
    what it holds with add): every entry point the same count, one a call."""
    from gslam_tpu_torch.ops import binning

    got = dict(binning.launches)
    check(len(set(got.values())) == 1, f"{path}: binning's entry points launched {got}")
    if add and path in BIN_LAUNCHES:
        got = {k: BIN_LAUNCHES[path][k] + n for k, n in got.items()}
    BIN_LAUNCHES[path] = got
    return got


def binning_inputs(fn):
    """The arguments (means2d, radii, depths, valid, width, height, cfg) of
    the first ops.rasterize._bin_cameras call that fn() makes."""
    from gslam_tpu_torch.ops import rasterize

    seen, orig = [], rasterize._bin_cameras

    def capture(*args):
        if not seen:
            seen.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
        return orig(*args)

    rasterize._bin_cameras = capture
    try:
        fn()
    finally:
        rasterize._bin_cameras = orig
    check(len(seen) == 1, "no binning call was seen")
    return seen[0]


def binning_bytes(C, N, live_pairs, T, capacity, end_bit):
    """The bytes a binning call needs at the least, by the stage that moves
    them: the splats read once (means2d, radii and valid by bin_count, the
    depths by bin_emit), each kept pair written once (an 8-byte key and a
    4-byte id), one stable radix sort of them in 8-bit digits over the key's
    end_bit bits (each pass reads and writes every pair) and the lists
    gathered (an id read, an id and a mask written per list entry, a count
    per tile). Nothing for the scan, the per-splat rectangles or the slots
    past a camera's pairs: those are the design's, not the function's."""
    pairs = 12 * live_pairs
    return {"bin_count": 13 * C * N, "bin_emit": 4 * C * N + pairs,
            "sort": 2 * pairs * -(-end_bit // 8), "bin_tile_lists": C * T * (9 * capacity + 4)}


def device_ms_by_kernel(fn, calls=5):
    """Device ms per call of each kernel fn() launches, over `calls` calls
    under torch.profiler (by the kernel's name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and not ev.is_user_annotation():
            out[ev.name()] = out.get(ev.name(), 0.0) + ev.duration_ns() / 1e6 / calls
    return out


def binning_vs_plain(inputs):
    """bin_cameras (the kernels) against the plain bin_gaussians camera by
    camera on the card, and against bench_binning.py's sync-free torch ops,
    on one path's real inputs: every field equal bit for bit. Times: the call
    (`ms`, CUDA events), the plain path (`plain_ms`), the torch ops
    (`torch_ops_ms`); each kernel's device ms by the profiler beside the
    torch-ops stage that does its work (`plain_ms`) and its part of the
    bytes bound (binning_bytes at PEAK_BYTES)."""
    import torch

    import bench_binning as bb
    from gslam_tpu_torch.ops import binning

    means2d, radii, depths, valid, width, height, cfg = inputs
    C, N = valid.shape
    ts = cfg.tile_size
    args = (ts, -(-width // ts), -(-height // ts), int(cfg.pairs_per_gaussian * N),
            cfg.tile_capacity, cfg.max_span)
    _, tiles_x, tiles_y, P, cap, span = args
    T = tiles_x * tiles_y
    xs = (means2d, radii, depths, valid)

    def kernels():
        return binning.bin_cameras(*xs, *args)

    def plain():
        bins = [binning.bin_gaussians(*(x[c] for x in xs), *args) for c in range(C)]
        return binning.TileBins(*(torch.stack(f) for f in zip(*bins)))

    def torch_ops():
        return bb.bin_cameras_torch(*xs, *args)

    got, want, ops = kernels(), plain(), torch_ops()
    unequal = {name: [k for k, a, b in zip(got._fields, got, other) if not torch.equal(a, b)]
               for name, other in (("plain", want), ("torch_ops", ops))}
    live = int(torch.clamp(got.n_pairs.to(torch.int64), max=P).sum())
    end_bit = 32 + (C * (T + 1) - 1).bit_length()
    need = binning_bytes(C, N, live, T, cap, end_bit)
    del want, ops

    # the torch-ops stages, each from the stage before it
    tx0, ty0, sx, sy, counts = bb.count_torch(means2d, radii, valid, ts, tiles_x, tiles_y,
                                              span)
    incl = torch.cumsum(counts, 1)
    key, vals = bb.emit_torch(incl, counts, tx0, ty0, sx, sy, depths, P, T, tiles_x)
    sk, sv = bb.sort_torch(key, vals)
    stage_ms = {
        "bin_count": cuda_ms(lambda: bb.count_torch(means2d, radii, valid, ts, tiles_x,
                                                    tiles_y, span), reps=10),
        "scan": cuda_ms(lambda: torch.cumsum(counts, 1), reps=10),
        "bin_emit": cuda_ms(lambda: bb.emit_torch(incl, counts, tx0, ty0, sx, sy, depths, P,
                                                  T, tiles_x), reps=10),
        "sort": cuda_ms(lambda: bb.sort_torch(key, vals), reps=10),
        "bin_tile_lists": cuda_ms(lambda: bb.lists_torch(sk, sv, incl[:, -1], C, P, T, cap),
                                  reps=10),
    }
    del tx0, ty0, sx, sy, counts, incl, key, vals, sk, sv
    device = device_ms_by_kernel(kernels)
    per_kernel = {name: next((v for k, v in device.items() if kname in k), None)
                  for name, kname in BIN_KERNELS.items()}
    cub_ms = sum(v for k, v in device.items() if not any(kn in k for kn in BIN_KERNELS.values()))
    row = dict(
        C=C, N=N, T=T, M=cap, width=width, height=height, max_pairs=P, live_pairs=live,
        end_bit=end_bit, unequal=unequal, ms=cuda_ms(kernels),
        plain_ms=cuda_ms(plain, reps=3, warmup=1), torch_ops_ms=cuda_ms(torch_ops, reps=10),
        bound_ms=1e3 * sum(need.values()) / PEAK_BYTES, bound_by="bytes",
        bytes_needed=need,
        cub_device_ms=cub_ms, cub_plain_ms={"scan": stage_ms["scan"], "sort": stage_ms["sort"]},
        cub_bound_ms=1e3 * need["sort"] / PEAK_BYTES,
        kernels={name: dict(ms=per_kernel[name], plain_ms=stage_ms[name],
                            bound_ms=1e3 * need[name] / PEAK_BYTES, bound_by="bytes")
                 for name in BIN_KERNELS})
    check(not unequal["plain"] and not unequal["torch_ops"],
          f"binning {C}x{N} at {width}x{height}: fields differ {unequal}")
    check(all(v is not None for v in per_kernel.values()),
          f"binning: a kernel was not seen on the device: {sorted(device)}")
    return row


def phase_binning(gmap, K, tcfg, point, smi):
    """Binning's kernels against the plain path (binning_vs_plain) on the
    real inputs of two main paths: a tracking level's compute_bins (one
    camera of the 50k map at 320x240, the inflated radii, M=512, 8 pairs a
    splat) and the mapping point's window render (10 cameras, 131,072 slots,
    M=512). Phase 14 holds the 1M window (10 cameras, 2^20 slots at
    640x480, M=256, 4 pairs) the same way."""
    import torch

    from gslam_tpu_torch.ops.rasterize import compute_bins, render_rows

    cfg = tcfg.render
    eye = torch.eye(4, device="cuda")
    rows = {"tracking": binning_vs_plain(binning_inputs(lambda: compute_bins(
        gmap.means, gmap.quats, gmap.log_scales, gmap.alive, eye[None], K[None], W, H, cfg,
        radius_scale=tcfg.bin_radius_margin)))}
    mgmap, _opt, kf, _pose_opt, widx, _wmask, mK, mcfg = point
    with torch.no_grad():
        rows["mapping"] = binning_vs_plain(binning_inputs(lambda: render_rows(
            **mgmap.render_kwargs(), viewmats=kf.poses()[widx],
            Ks=mK[None].expand(len(widx), 3, 3), width=W, height=H, cfg=mcfg.render)))
    emit("binning_vs_plain", nvidia_smi=smi, **rows)
    check(rows["tracking"]["C"] == 1 and rows["mapping"]["C"] == WINDOW,
          f"binning shapes {rows['tracking']['C']}, {rows['mapping']['C']} cameras")
    return rows


def phase_reference():
    """The whole slice on the card against the CPU path on a small scene."""
    import torch

    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig, track_frame

    rng = np.random.default_rng(7)
    w, h, n, fx = 96, 64, 400, 86.4
    z = rng.uniform(2.0, 4.0, n).astype(np.float32)
    u, v = rng.uniform(4, w - 4, n), rng.uniform(4, h - 4, n)
    fields = dict(
        means=np.stack([(u - w / 2) * z / fx, (v - h / 2) * z / fx, z], -1),
        quats=rng.normal(size=(n, 4)), log_scales=np.log(rng.uniform(0.04, 0.12, (n, 3))),
        logit_opacities=rng.uniform(-1.0, 3.0, n), logit_colors=rng.normal(size=(n, 3)),
        log_uncertainties=rng.uniform(-0.5, 0.5, n), alive=np.ones(n, bool))
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    gt = rng.random((h, w, 3)).astype(np.float32) * 0.2
    cfg = TrackingConfig(render=RenderConfig(tile_capacity=64), warmup_steps=3,
                         lbfgs_max_iter=12, lbfgs_max_eval=12)
    out = {}
    for dev in ("cpu", "cuda"):
        gmap = gaussian_map_from_numpy(fields, device=dev)
        r = track_frame(gmap, np.eye(4, dtype=np.float32), np.zeros(2, np.float32),
                        gt, K, w, h, cfg, device=dev)
        out[dev] = (r.pose.cpu().numpy(), r.n_evals, r.rejected)
    diff = float(np.abs(out["cpu"][0] - out["cuda"][0]).max())
    emit("reference", pose_max_abs_diff=diff, n_evals=out["cuda"][1],
         n_evals_cpu=out["cpu"][1], tolerance=2e-3)
    check(out["cpu"][1:] == out["cuda"][1:], f"evals/rejection differ: {out}")
    # the line search amplifies float32 rounding: the JAX tracker moves its
    # pose up to 7.3e-4 under 1e-6 image noise (tests/test_torch_track.py)
    check(diff <= 2e-3, f"card and CPU poses differ by {diff}")


def tracking_frames(gmap, K, cfg, xis):
    """The tracking point's 10 chained ground-truth poses (each xi applied to
    the last) and the port's fused render at each, on the card."""
    import torch

    from gslam_tpu_torch.core.transforms import se3_exp
    from gslam_tpu_torch.ops.rasterize import compute_bins
    from gslam_tpu_torch.ops.track_fused import gather_tracking_tiles, render_tracking_fused

    poses, cur = [], torch.eye(4)
    for i in range(N_FRAMES):
        cur = se3_exp(torch.from_numpy(xis[i])) @ cur
        poses.append(cur.cuda())
    gts = []
    with torch.no_grad():
        for p in poses:
            bins = compute_bins(gmap.means, gmap.quats, gmap.log_scales, gmap.alive,
                                p[None], K[None], W, H, cfg)
            rgb = render_tracking_fused(gather_tracking_tiles(gmap, bins), p, K, W, H,
                                        cfg)[0]
            gts.append(torch.clamp(rgb, 0.0, 1.0))
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) and g.shape == (H, W, 3) for g in gts),
          "ground-truth renders not finite or misshaped")
    return poses, gts


def chained_prior(est):
    """Identity, then the last pose, then the constant-motion prior."""
    import torch

    from gslam_tpu_torch.tracking.track import constant_motion_prior

    if not est:
        return torch.eye(4, device="cuda")
    if len(est) == 1:
        return est[-1]
    return constant_motion_prior(est[-2], est[-1])


def phase_tracking(gmap, K, tcfg, poses, gts, smi):
    import torch

    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.tracking.track import track_frame

    reset_launches()
    est, exposure, frames = [], torch.zeros(2, device="cuda"), []
    for i in range(N_FRAMES):
        prior = chained_prior(est)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        r = track_frame(gmap, prior, exposure, gts[i], K, W, H, tcfg)
        b.record()
        b.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        check(bool(torch.isfinite(r.pose).all()) and bool(torch.isfinite(r.loss)),
              f"frame {i}: non-finite result")
        err = float(torch.linalg.norm(r.pose[:3, 3] - poses[i][:3, 3]))
        frames.append(dict(frame=i, ms=a.elapsed_time(b), host_ms=host_ms,
                           n_evals=r.n_evals, rejected=r.rejected, t_err_m=err,
                           loss=float(r.loss)))
        est.append(r.pose)
        exposure = r.exposure
    launches = dict(blend.launches)
    binning_launches("tracking")
    n_evals = sum(f["n_evals"] for f in frames)
    final_err = frames[-1]["t_err_m"]
    emit("tracking", nvidia_smi=smi, frames=frames, sum_n_evals=n_evals,
         launches=launches, final_t_err_m=final_err,
         mean_ms=float(np.mean([f["ms"] for f in frames])))
    check(not any(f["rejected"] for f in frames), "a frame was rejected")
    check(final_err < 0.01, f"final translation error {final_err} m >= 1 cm")
    check(launches["blend_fwd"] == n_evals,
          f"forward launches {launches['blend_fwd']} != {n_evals} evals")
    check(launches["blend_bwd"] == n_evals,
          f"backward launches {launches['blend_bwd']} != {n_evals} evals")

    # frame 1 again through the coarse-to-fine path (160x120 and 80x60
    # levels above the full image), from the same prior as in the chain
    pcfg = dataclasses.replace(tcfg, pyramid_levels=3)
    blend.reset_launches()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    r = track_frame(gmap, est[0], torch.zeros(2), gts[1], K, W, H, pcfg)
    b.record()
    b.synchronize()
    pyr = dict(ms=a.elapsed_time(b), n_evals=r.n_evals, rejected=r.rejected,
               t_err_m=float(torch.linalg.norm(r.pose[:3, 3] - poses[1][:3, 3])),
               launches=dict(blend.launches))
    emit("tracking_pyramid3", **pyr)
    check(bool(torch.isfinite(r.pose).all()) and not r.rejected, "pyramid frame failed")
    check(pyr["launches"]["blend_fwd"] == r.n_evals == pyr["launches"]["blend_bwd"],
          f"pyramid launches {pyr['launches']} != {r.n_evals} evals")
    return launches


def gn_start_and_run(ds, depth, cfg, dev):
    """Flat Gauss-Newton on frame 1 of `ds` from frame 0's pose on `dev`:
    the start loss f0, the first normal system at x0, the LM loop's render
    passes and per-iteration (accepted, loss) steps, and the final pose."""
    import torch

    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.tracking.track import GaussNewtonProblem, levenberg_marquardt

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    gmap = gaussian_map_from_numpy(ds.gt_map_fields, device=dev)
    prob = GaussNewtonProblem(gmap, t(ds.poses[0]), t(np.zeros(2)), t(ds.images[1]),
                              t(ds.camera.K), ds.camera.width, ds.camera.height, cfg,
                              None if depth is None else t(depth))
    x0 = prob.x0()
    f0 = prob.loss(*prob.residuals(x0))
    JtJ, Jtr = prob.normal_equations(x0)
    x, _f, n_evals, steps = levenberg_marquardt(prob, cfg)
    with torch.no_grad():
        pose = prob.unpack(x)[0]
    return dict(f0=float(f0), JtJ=JtJ.cpu().double().numpy(), Jtr=Jtr.cpu().double().numpy(),
                n_evals=n_evals, steps=steps, pose=pose.cpu().numpy())


def phase_gn_reference():
    """Flat Gauss-Newton (gn_iters=10) on tests/test_gauss_newton.py's scene
    (the port's synthetic room, 96x72, 1,500 splats, seed 0, frame 1 from
    frame 0's pose), mono and RGB-D, on the card and on the CPU: f0 and the
    first JtJ, Jtr within rtol 1e-4 (norm-relative), the accept sequence and
    the render-pass count equal, each iteration's loss within 1e-4 of f0, the
    final pose within 1e-4 m / 1e-4 rad. If the accept sequences part, the
    phase prints where and holds the iterations before it (equal flags, each
    loss within 1e-4 of f0) and that both losses just before it are below
    1e-4 of f0, the float32 floor of the objective (tests/test_torch_gn.py's
    rule); it still holds the final pose."""
    import torch

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.ops.rasterize import RenderConfig, render
    from gslam_tpu_torch.tracking.track import TrackingConfig

    w, h = 96, 72
    ds = SyntheticDataset(seq_len=4, width=w, height=h, n_splats=1500, seed=0,
                          motion_scale=0.03, device="cpu")
    r = RenderConfig(tile_capacity=128, tile_chunk=16)
    with torch.no_grad():
        out = render(**ds.gt_map_fields, viewmats=ds.poses[1][None], Ks=ds.camera.K[None],
                     width=w, height=h, cfg=r, device="cpu")
    depth = (out.depth[0] / torch.clamp(out.alpha[0], min=1e-3)).numpy()

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                     / max(np.linalg.norm(np.asarray(b)), 1e-30))

    report = {}
    for mode in ("mono", "rgbd"):
        cfg = TrackingConfig(method="gn", gn_iters=10, use_gt_depths=mode == "rgbd", render=r)
        card, cpu = (gn_start_and_run(ds, depth if mode == "rgbd" else None, cfg, dev)
                     for dev in ("cuda", "cpu"))
        seq, cseq = [a for a, _ in card["steps"]], [a for a, _ in cpu["steps"]]
        part = next((k for k, (a, b) in enumerate(zip(seq, cseq)) if a != b), None)
        if part is None and len(seq) != len(cseq):
            part = min(len(seq), len(cseq))
        agree = list(zip(card["steps"], cpu["steps"]))[:part]
        floor = (max(card["steps"][part - 1][1], cpu["steps"][part - 1][1]) / cpu["f0"]
                 if part else None)
        dt, drot = pose_gap(card["pose"][None], cpu["pose"][None])
        report[mode] = dict(
            f0=[card["f0"], cpu["f0"]], f0_rel=rel(card["f0"], cpu["f0"]),
            JtJ_rel=rel(card["JtJ"], cpu["JtJ"]), Jtr_rel=rel(card["Jtr"], cpu["Jtr"]),
            n_evals=[card["n_evals"], cpu["n_evals"]], steps_card=card["steps"],
            steps_cpu=cpu["steps"], parted_at=part,
            loss_gap_over_f0=max((abs(a[1] - b[1]) for a, b in agree), default=0.0) / cpu["f0"],
            loss_before_part_over_f0=floor, pose_gap_m=dt, rot_gap_rad=drot)
    emit("gn_reference", **report,
         tolerance="f0, JtJ, Jtr rtol 1e-4 (norm-relative); accept sequence and n_evals "
                   "equal, each iteration's loss within 1e-4 f0, unless they part (printed: "
                   "then the iterations before it within 1e-4 f0 and both losses just "
                   "before it below 1e-4 f0); final pose within 1e-4 m / 1e-4 rad")
    for mode, g in report.items():
        where = f"gn_reference {mode}"
        check(max(g["f0_rel"], g["JtJ_rel"], g["Jtr_rel"]) <= 1e-4,
              f"{where}: start differs: f0 {g['f0_rel']}, JtJ {g['JtJ_rel']}, "
              f"Jtr {g['Jtr_rel']}")
        check(g["loss_gap_over_f0"] <= 1e-4,
              f"{where}: losses differ by {g['loss_gap_over_f0']} of f0 before parting")
        if g["parted_at"] is None:
            check(g["n_evals"][0] == g["n_evals"][1], f"{where}: n_evals {g['n_evals']}")
        else:
            check(g["parted_at"] > 0 and g["loss_before_part_over_f0"] < 1e-4,
                  f"{where}: the sequences part at {g['parted_at']} above the float32 "
                  f"floor (loss {g['loss_before_part_over_f0']} of f0)")
        check(g["pose_gap_m"] <= 1e-4 and g["rot_gap_rad"] <= 1e-4,
              f"{where}: poses differ by {g['pose_gap_m']} m, {g['rot_gap_rad']} rad")


def phase_gn(gmap, K, tcfg, poses, gts, smi):
    """The Gauss-Newton point of bench.py:221-232 at full width: the tracking
    point's map and 10 chained frames, tracked with method="gn", pyr3 x 8
    LM iterations and then flat with 10. Per frame: CUDA-event ms, host ms,
    host syncs, render passes, each level's LM iterations, render passes and
    rejected steps; peak memory; the final translation error (< 1 cm, no
    guard rejection) and the blend kernels' launches (none: GN's route
    blends in plain torch ops, as the JAX tracker pins its jnp blend)."""
    import warnings

    import torch

    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.tracking import track

    runs = {}
    for name, over in (("pyr3x8", dict(pyramid_levels=3, gn_iters=8)),
                       ("flat10", dict(pyramid_levels=1, gn_iters=10))):
        cfg = dataclasses.replace(tcfg, method="gn", **over)
        levels, orig = [], track.levenberg_marquardt

        def lm(prob, c):
            out = orig(prob, c)
            levels.append(dict(width=prob.width, iterations=len(out[3]), passes=out[2],
                               rejected_steps=sum(not a for a, _ in out[3])))
            return out

        track.levenberg_marquardt = lm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        est, exposure, frames = [], torch.zeros(2, device="cuda"), []
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                for i in range(N_FRAMES):
                    prior = chained_prior(est)
                    n_lv, n_sync = len(levels), len(seen)
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    a.record()
                    r = track.track_frame(gmap, prior, exposure, gts[i], K, W, H, cfg)
                    b.record()
                    syncs = len(seen) - n_sync
                    b.synchronize()
                    frames.append(dict(
                        frame=i, ms=a.elapsed_time(b), host_ms=1e3 * (time.perf_counter() - t0),
                        host_syncs=syncs, n_evals=r.n_evals, rejected=r.rejected,
                        levels=levels[n_lv:], finite=bool(torch.isfinite(r.pose).all()),
                        t_err_m=float(torch.linalg.norm(r.pose[:3, 3] - poses[i][:3, 3]))))
                    est.append(r.pose)
                    exposure = r.exposure
        finally:
            torch.cuda.set_sync_debug_mode("default")
            track.levenberg_marquardt = orig
        binning_launches("gn", add=True)
        runs[name] = dict(
            frames=frames, launches=dict(blend.launches),
            max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
            mean_ms=float(np.mean([f["ms"] for f in frames])),
            median_ms=float(np.median([f["ms"] for f in frames])),
            mean_ms_after_first=float(np.mean([f["ms"] for f in frames[1:]])),
            sum_n_evals=sum(f["n_evals"] for f in frames),
            rejections=sum(f["rejected"] for f in frames),
            final_t_err_m=frames[-1]["t_err_m"])
    emit("gn", nvidia_smi=smi, **runs)
    for name, g in runs.items():
        check(all(f["finite"] for f in g["frames"]), f"gn {name}: a pose is not finite")
        check(g["rejections"] == 0, f"gn {name}: {g['rejections']} frames rejected")
        check(g["final_t_err_m"] < 0.01,
              f"gn {name}: final translation error {g['final_t_err_m']} m >= 1 cm")
        check(not any(g["launches"].values()),
              f"gn {name}: the forward-mode route launched {g['launches']}")


def small_mapping_scene(device):
    """The mapping parity test's scene (tests/test_torch_mapping.py): 256
    slots (20 dead) around z=2 before a 32x32 camera, keyframes 0-2 with
    random images, a window [0, 1, 2, pad]."""
    import torch

    from gslam_tpu_torch.mapping.backend_ops import MapConfig, init_pose_adam
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.mapping.keyframes import add_keyframe, empty_keyframes
    from gslam_tpu_torch.mapping.optimizer import init_adam
    from gslam_tpu_torch.ops.rasterize import RenderConfig

    rng = np.random.default_rng(5)
    cap, side = 256, 32
    alive = np.ones(cap, bool)
    alive[rng.choice(cap, 20, replace=False)] = False
    gmap = gaussian_map_from_numpy(dict(
        means=(rng.normal(0, 0.5, (cap, 3)) + [0, 0, 2.0]),
        quats=rng.normal(size=(cap, 4)),
        log_scales=np.log(rng.uniform(0.06, 0.14, (cap, 3))),
        logit_opacities=rng.normal(1.0, 0.5, cap), logit_colors=rng.normal(size=(cap, 3)),
        log_uncertainties=rng.uniform(-0.3, 0.3, cap), alive=alive), device=device)
    kf = empty_keyframes(4, side, side, device=device)
    for slot in range(3):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.03 * slot, -0.01 * slot, 0.0]
        kf = add_keyframe(kf, slot, rng.random((side, side, 3)), pose, [0.05 * slot, -0.01],
                          slot)
    K = torch.tensor([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], device=device)
    cfg = MapConfig(window_size=4, render=RenderConfig(tile_capacity=64))
    widx = torch.tensor([0, 1, 2, 0], device=device)
    wmask = torch.tensor([True, True, True, False], device=device)
    return gmap, init_adam(gmap), kf, init_pose_adam(4, device=device), widx, wmask, K, cfg


def phase_mapping_reference():
    """Three mapping steps of the small scene on the card and on the CPU."""
    from gslam_tpu_torch.mapping.backend_ops import mapping_step, window_grads

    res = {}
    for dev in ("cpu", "cuda"):
        gmap, opt, kf, pose_opt, widx, wmask, K, cfg = small_mapping_scene(dev)
        wg = window_grads(gmap, kf, widx, wmask, K, 32, 32, cfg)
        norms = {f: float(g.double().norm()) for f, g in wg.g_map.items()}
        norms["pose"] = float(wg.g_pose.double().norm())
        norms["means2d"] = float(wg.g_probe.double().norm())
        steps = []
        for _ in range(3):
            gmap, opt, kf, pose_opt, aux = mapping_step(gmap, opt, kf, pose_opt, widx,
                                                        wmask, K, 32, 32, cfg)
            steps.append((float(aux.total_loss), float(aux.photometric_loss),
                          aux.radii.cpu(), aux.n_touched.cpu()))
        res[dev] = (norms, steps)
    (cn, cs), (gn, gs) = res["cpu"], res["cuda"]
    loss_rel = max(abs(g[i] / c[i] - 1) for c, g in zip(cs, gs) for i in (0, 1))
    norm_rel = {k: abs(gn[k] / cn[k] - 1) for k in cn}
    radii_diff = [int((c[2] != g[2]).sum()) for c, g in zip(cs, gs)]
    touched_diff = [int((c[3] != g[3]).sum()) for c, g in zip(cs, gs)]
    emit("mapping_reference", total_loss_cuda=[g[0] for g in gs],
         total_loss_cpu=[c[0] for c in cs], loss_max_rel_diff=loss_rel,
         grad_norm_rel_diff=norm_rel, radii_differ=radii_diff,
         n_touched_differ=touched_diff,
         tolerance="losses of each step rtol 1e-4; first-step gradient norms per "
                   "field rtol 1e-4; radii and n_touched equal in every step")
    check(loss_rel <= 1e-4, f"card and CPU losses differ by {loss_rel} (relative)")
    check(max(norm_rel.values()) <= 1e-4, f"gradient norms differ: {norm_rel}")
    check(not any(radii_diff) and not any(touched_diff),
          f"radii / n_touched differ: {radii_diff} {touched_diff}")


def mapping_point(seed=1):
    """bench.py's mapping operating point (`_mapping_op_point`) on the card:
    a 131,072-slot map with 100,000 live splats, 12 keyframes 1 cm apart in
    x whose images are the port's own render of the map at each pose, and
    the window of slots 2-11. The map that the steps start from has its
    colors perturbed by a seeded N(0, 0.3) in logit space."""
    import torch

    from gslam_tpu_torch.mapping.backend_ops import MapConfig, init_pose_adam
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.mapping.keyframes import add_keyframe, empty_keyframes
    from gslam_tpu_torch.mapping.optimizer import init_adam
    from gslam_tpu_torch.ops.rasterize import RenderConfig, render

    rng = np.random.default_rng(seed)
    gmap = gaussian_map_from_numpy(make_map_fields(MAP_CAP, MAP_LIVE, rng), device="cuda")
    K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], device="cuda")
    cfg = MapConfig(window_size=WINDOW,
                    render=RenderConfig(tile_capacity=512, pairs_per_gaussian=8))
    poses = torch.eye(4, device="cuda").repeat(N_KF, 1, 1)
    poses[:, 0, 3] = 0.01 * torch.arange(N_KF, device="cuda")
    with torch.no_grad():
        gts = render(**gmap.render_kwargs(), viewmats=poses, Ks=K[None].expand(N_KF, 3, 3),
                     width=W, height=H, cfg=cfg.render, device="cuda").rgb
    check(bool(torch.isfinite(gts).all()), "ground-truth keyframe renders not finite")
    kf = empty_keyframes(KF_CAP, H, W, device="cuda")
    for slot in range(N_KF):
        kf = add_keyframe(kf, slot, gts[slot], poses[slot], torch.zeros(2), slot)
    noise = rng.normal(scale=0.3, size=(MAP_CAP, 3)).astype(np.float32)
    gmap = gmap._replace(logit_colors=gmap.logit_colors + torch.from_numpy(noise).cuda())
    widx = torch.arange(WINDOW, device="cuda") + 2
    wmask = torch.ones(WINDOW, dtype=torch.bool, device="cuda")
    return gmap, init_adam(gmap), kf, init_pose_adam(KF_CAP, device="cuda"), widx, wmask, K, cfg


def phase_mapping(point, smi):
    """The mapping main path: 2 warm-up steps and one pass of
    cfg.num_iters_mapping steps, each between CUDA events, with the launch
    counters reset before each step."""
    import torch

    from gslam_tpu_torch.mapping import pruning
    from gslam_tpu_torch.mapping.backend_ops import mapping_step, window_grads
    from gslam_tpu_torch.ops import binning, blend

    gmap, opt, kf, pose_opt, widx, wmask, K, cfg = point
    n_warm, n_pass = 2, cfg.num_iters_mapping
    budget = int(cfg.render.pairs_per_gaussian * MAP_CAP)
    totals = {k: 0 for k in blend.launches}
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_warm + n_pass):
        reset_launches()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        gmap, opt, kf, pose_opt, aux = mapping_step(gmap, opt, kf, pose_opt, widx, wmask,
                                                    K, W, H, cfg)
        host_ms = 1e3 * (time.perf_counter() - t0)  # until the host has enqueued it
        b.record()
        b.synchronize()
        launched = dict(blend.launches)
        check(set(binning.launches.values()) == {1},
              f"step {i} binned {dict(binning.launches)}, expected one call")
        binning_launches("mapping", add=True)
        for k in totals:
            totals[k] += launched[k]
        check(launched == {"blend_fwd": WINDOW, "blend_bwd": WINDOW},
              f"step {i} launched {launched}, expected {WINDOW} of each kernel")
        check(all(x.is_cuda for x in (*gmap, *aux)), f"step {i}: a result left the card")
        steps.append(dict(step=i, warmup=i < n_warm, ms=a.elapsed_time(b), host_ms=host_ms,
                          total_loss=float(aux.total_loss),
                          photometric_loss=float(aux.photometric_loss),
                          max_n_pairs=int(aux.n_pairs.max())))
    peak = torch.cuda.max_memory_allocated()
    timed = [st for st in steps if not st["warmup"]]
    ms = np.array([st["ms"] for st in timed])
    finite = (all(np.isfinite([st["total_loss"] for st in steps]))
              and all(bool(torch.isfinite(x).all()) for x in gmap.trainable().values())
              and bool(torch.isfinite(kf.d_t).all()) and bool(torch.isfinite(kf.d_rot6).all()))
    remove = (pruning.low_opacity_mask(gmap, cfg.opacity_prune_threshold)
              | pruning.large_radius_mask(aux.radii.max(0).values, cfg.size_prune_threshold))
    # is the scatter of the splat gradients deterministic on the card?
    g1, g2 = (window_grads(gmap, kf, widx, wmask, K, W, H, cfg).g_map for _ in range(2))
    grad_diff = max(float((g1[f] - g2[f]).abs().max()) for f in g1)
    result = dict(
        nvidia_smi=smi, steps=steps, median_ms=float(np.median(ms)),
        min_ms=float(ms.min()), max_ms=float(ms.max()),
        median_host_ms=float(np.median([st["host_ms"] for st in timed])),
        pass_ms=float(ms.sum()), passes_per_s=float(1e3 / ms.sum()),
        max_memory_allocated_bytes=int(peak),
        photometric_loss_before=timed[0]["photometric_loss"],
        photometric_loss_after=timed[-1]["photometric_loss"],
        # the loss moves by up to ~4x from step to step (Adam at lr 0.025 on
        # the opacities), so its fall is judged on the first and last 3 steps
        photometric_loss_first3=float(np.mean([st["photometric_loss"] for st in timed[:3]])),
        photometric_loss_last3=float(np.mean([st["photometric_loss"] for st in timed[-3:]])),
        max_n_pairs=max(st["max_n_pairs"] for st in steps), pair_budget=budget,
        prune_would_remove=int((remove & gmap.alive).sum()), n_live=int(gmap.n_live()),
        launches=totals, grads_bitwise_repeatable=grad_diff == 0.0,
        grads_repeat_max_abs_diff=grad_diff,
    )
    emit("mapping", **result)
    check(finite, "mapping produced non-finite values")
    check(result["photometric_loss_last3"] < result["photometric_loss_first3"],
          "the photometric loss did not fall over the pass")
    return totals


def slam_small_cfg():
    """tests/test_fused.py's small configuration (its RenderConfig without
    the JAX-only tile_chunk)."""
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.runtime.fused import FusedConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    r = RenderConfig(tile_capacity=64, pairs_per_gaussian=8)
    return FusedConfig(
        tracking=TrackingConfig(warmup_steps=5, lbfgs_max_iter=10, lbfgs_max_eval=12, render=r),
        mapping=MapConfig(window_size=4, recent_window=4, num_iters_init=40,
                          num_iters_mapping=5, render=r),
        max_frames=16, init_n_new=400, kf_n_new=50, idle_iters=5)


def with_gt_depths(cfg):
    """A fused configuration (either package's) in RGB-D mode."""
    return dataclasses.replace(
        cfg, use_gt_depths=True,
        tracking=dataclasses.replace(cfg.tracking, use_gt_depths=True),
        mapping=dataclasses.replace(cfg.mapping, use_gt_depths=True))


def pose_gap(a, b):
    """Largest translation gap (m) and rotation angle (rad) between two
    [n, 4, 4] pose stacks."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): exact near 0, where arccos of
    # the trace reads float32 rounding as ~1e-3 rad
    d = np.linalg.norm(a[:, :3, :3] - b[:, :3, :3], axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    return dt, float((2.0 * np.arcsin(np.clip(d, 0.0, 1.0))).max())


SLAM_COUNTS = ("kf_count", "inserted_total", "total_map_iters", "live_count")


class EvalRecorder:
    """Records each evaluation's loss and gradient while in a `with` block:
    wraps the host-side optimizer that a module hands its loss function to
    (by default the tracker's, track.warmup_lbfgs_impl)."""

    def __init__(self, module_name="gslam_tpu_torch.tracking.track",
                 attr="warmup_lbfgs_impl"):
        self.evals = []
        self._where = module_name, attr

    def __enter__(self):
        import importlib

        module_name, attr = self._where
        self._module = importlib.import_module(module_name)
        self._orig = getattr(self._module, attr)

        def run(loss_fn, x0, **kw):
            def fn(p):
                f = loss_fn(p)
                entry = {"f": float(f.detach())}
                p.register_hook(lambda g: entry.__setitem__("g", g.detach().cpu().numpy()))
                self.evals.append(entry)
                return f

            return self._orig(fn, x0, **kw)

        setattr(self._module, attr, run)
        return self

    def __exit__(self, *exc):
        setattr(self._module, self._where[1], self._orig)


def tracker_agreement(card, cpu, warmup):
    """Where two trackers' evaluations part: the first index whose loss
    differs by more than 1e-5 relative (None if none does), and the first
    evaluation's loss and gradient gaps (relative)."""
    part = next((k for k, (a, b) in enumerate(zip(card, cpu))
                 if abs(a["f"] - b["f"]) > 1e-5 * abs(b["f"])), None)
    if part is None and len(card) != len(cpu):
        part = min(len(card), len(cpu))
    if not card:
        return dict(n_evals=[0, 0], parted_at=part)
    a, b = card[0], cpu[0]
    # a loss of 0 (the warp tracker with no pixel in view) has gradient 0
    return dict(n_evals=[len(card), len(cpu)], parted_at=part,
                first_f_rel=abs(a["f"] - b["f"]) / max(abs(b["f"]), 1e-30),
                first_g_rel=float(np.linalg.norm(a["g"] - b["g"])
                                  / max(np.linalg.norm(b["g"]), 1e-30)),
                min_part=warmup + 2)


def prune_ties(card, cpu, threshold):
    """The slots live on one side only after a step, and whether the
    opacity prune at `threshold` explains each as a tie: the side that
    dropped the slot holds it below the threshold, the side that kept it at
    or above, and both opacities lie within the largest opacity gap between
    the two sides over the slots both kept (the step's own drift)."""
    import torch

    a, b = card.gmap.alive.cpu(), cpu.gmap.alive.cpu()
    oa = torch.sigmoid(card.gmap.logit_opacities.cpu())
    ob = torch.sigmoid(cpu.gmap.logit_opacities)
    split = torch.nonzero(a ^ b).flatten()
    if not len(split):
        return dict(slots=[], explained=True)
    both = a & b
    gap = float((oa - ob)[both].abs().max()) if bool(both.any()) else 0.0
    kept_a = a[split]
    dropped = torch.where(kept_a, ob[split], oa[split])
    kept = torch.where(kept_a, oa[split], ob[split])
    near = ((oa[split] - threshold).abs() <= gap) & ((ob[split] - threshold).abs() <= gap)
    explained = bool(((dropped < threshold) & (kept >= threshold) & near).all())
    return dict(slots=split.tolist(), opacity_card=oa[split].tolist(),
                opacity_cpu=ob[split].tolist(), opacity_gap=gap, explained=explained)


# ---- one mapping_step at a time from a shared state (bootstrap_stepped) ----
#
# Side a is the one under test (the card; the port in
# tests/test_torch_bootstrap_stepped.py), side b the reference (the CPU; the
# JAX package). Both step from the same state. A discrete output that differs
# is a tie when every value that decides it lies within float32 rounding of
# its threshold on both sides; any other discrete difference, and any
# continuous gap beyond the tolerances left after the ties, is a fault.
STEP_TOL = dict(
    loss_rtol=1e-5,  # total and photometric loss, relative
    grad_rel=1e-4,  # |g_a - g_b| / |g_b| per field, after the ties below
    # the rotation's gradient scales with a splat's anisotropy, which starts
    # at 0 (every insert is isotropic): near it the gradient is cancellation
    grad_rel_quats=1e-3,
    clear_g=1e-4,  # a gradient entry is clear of zero above this on both sides...
    clear_mu=1e-5,  # ...and so is its new first moment (m moves by 0.1 g)
    field_atol=1e-6,  # updated fields on clear entries: atol + rtol |p|
    field_rtol=1e-6,  # (tests/test_torch_mapping.py's, where |g| > 1e-4)
    round_rel=1e-5,  # a value within rounding of a threshold, relative
    alpha_band=1e-5,  # alpha_cut * (1 +- this): the band where the cut is rounding
    iso_rel=2e-6,  # |e^s - e^mean(s)| below this share of e^s: the isotropic |.| at its kink
    touched_share=1e-3,  # n_touched off by one on at most this share of live entries
)
STEP_TOL_TEXT = (
    "from a shared state, per iteration: total and photometric loss rtol 1e-5; each "
    "gradient |g_a - g_b| / |g_b| <= 1e-4 after ties (quats 1e-3: its gradient scales "
    "with the splat's anisotropy, 0 at insertion); where |g| > 1e-4 and the new "
    "first moment |m| > 1e-5 on both sides, Adam's step has one sign and each updated "
    "field is within 1e-6 + 1e-6 |p|; tile lists, n_pairs, radii > 0 and the opacity-"
    "decay mask equal; n_touched equal but off by one on <= 0.1% of live entries "
    "(at least 1). Ties, recorded: a binning value (x +- r at a tile edge or the image "
    "border, 3 sigma at the radius ceil, depth at the near plane, two depths in a "
    "tile's order) within 1e-5 of its threshold on both sides; a splat at the "
    "isotropic loss's kink (|e^s - e^mean(s)| <= 2e-6 e^s), whose gradient may flip "
    "by 2 w e^s, and the rotation of a splat with all three there, whose gradient is 0 "
    "but for rounding; a pixel's alpha within 1e-5 of alpha_cut, whose share of each "
    "output is what side a's own steps at alpha_cut * (1 +- 1e-5) move it by")


class StepCapture:
    """Records, while in a `with` block, what a port mapping_step computes
    inside: its render's projection (ops.rasterize.project_cameras), tile
    lists (ops.rasterize._bin_cameras) and window-loss gradients
    (mapping.backend_ops.window_grads), the first call of each."""

    TARGETS = (("gslam_tpu_torch.ops.rasterize", "project_cameras"),
               ("gslam_tpu_torch.ops.rasterize", "_bin_cameras"),
               ("gslam_tpu_torch.mapping.backend_ops", "window_grads"))

    def __enter__(self):
        import importlib

        self.seen, self._orig = {}, []
        for module_name, attr in self.TARGETS:
            module = importlib.import_module(module_name)
            orig = getattr(module, attr)

            def wrapped(*a, _orig=orig, _attr=attr, **kw):
                out = _orig(*a, **kw)
                self.seen.setdefault(_attr, out)
                return out

            setattr(module, attr, wrapped)
            self._orig.append((module, attr, orig))
        return self

    def __exit__(self, *exc):
        for module, attr, orig in self._orig:
            setattr(module, attr, orig)


def port_step(args, cfg):
    """One port mapping_step on (gmap, opt_state, kf, pose_opt, widx, wmask,
    K, width, height) as a step record: numpy arrays of what the comparison
    reads (the keys of mapping_step_agreement), and the step's outputs."""
    from gslam_tpu_torch.mapping.backend_ops import mapping_step
    from gslam_tpu_torch.mapping.gaussians import TRAINABLE_FIELDS

    def n(x):
        return x.detach().cpu().numpy()

    gmap0, wmask = args[0], args[5]
    with StepCapture() as cap:
        out = mapping_step(*args, cfg)
    gmap, opt, _kf, _pose_opt, aux = out
    proj, bins, wg = (cap.seen[k] for k in ("project_cameras", "_bin_cameras", "window_grads"))
    rec = dict(
        total_loss=float(aux.total_loss), photometric_loss=float(aux.photometric_loss),
        cam_mask=n(wmask), means2d=n(proj.means2d), radii_proj=n(proj.radii),
        depths=n(proj.depths), conics=n(proj.conics), valid=n(proj.valid),
        tile_gauss=n(bins.tile_gauss), tile_mask=n(bins.tile_mask), n_pairs=n(bins.n_pairs),
        radii=n(aux.radii), n_touched=n(aux.n_touched),
        decay=n(((aux.radii > 0).sum(0) > 1) & gmap0.alive), g_pose=n(wg.g_pose))
    for f in TRAINABLE_FIELDS:
        rec[f"g/{f}"], rec[f"mu/{f}"] = n(wg.g_map[f]), n(opt.mu[f])
        rec[f"p/{f}"] = n(getattr(gmap, f))
    return rec, out


def alpha_band_cfgs(cfg):
    """cfg with alpha_cut moved to the two edges of its rounding band."""
    r = cfg.render
    return [dataclasses.replace(cfg, render=dataclasses.replace(
        r, alpha_cut=r.alpha_cut * (1.0 + s * STEP_TOL["alpha_band"]))) for s in (1, -1)]


def _binning_values(side, c, s, r, rcfg, width, height):
    """The binning thresholds that slot s of camera c lies within rounding
    of on one side (radius r: the larger of the two sides')."""
    tol = STEP_TOL["round_rel"]
    x, y = (float(v) for v in side["means2d"][c, s])
    z = float(side["depths"][c, s])
    ts = rcfg.tile_size
    near = set()
    for name, q in (("x-r", x - r), ("x+r", x + r), ("y-r", y - r), ("y+r", y + r)):
        lim = width if name[0] == "x" else height
        for what, thr in (("tile edge", ts * round(q / ts)), ("border", lim)):
            if abs(q - thr) <= tol * max(abs(q), ts):
                near.add(f"{name} at {what}")
    ca, cb, cc = (float(v) for v in side["conics"][c, s])
    det = ca * cc - cb * cb
    if det > 0:  # the covariance is the conic's inverse: its larger eigenvalue
        mid = 0.5 * (ca + cc) / det
        three_sigma = 3.0 * np.sqrt(mid + np.sqrt(max(mid * mid - 1.0 / det, 0.0)))
        if abs(three_sigma - round(three_sigma)) <= tol * max(three_sigma, 1.0):
            near.add("3 sigma at the radius ceil")
    if abs(z - rcfg.near) <= tol * max(abs(z), rcfg.near):
        near.add("depth at the near plane")
    return near


def _footprints(side, rcfg, tiles_x, tiles_y):
    """[C, N, 5] tile rectangle (x0, y0, span_x, span_y) and valid of every
    slot, in float32 as binning computes them from the same inputs."""
    ts, ms = np.float32(rcfg.tile_size), rcfg.max_span
    m2d, r = side["means2d"].astype(np.float32), side["radii_proj"].astype(np.float32)
    x, y = m2d[..., 0], m2d[..., 1]

    def tile(v, hi):
        return np.clip(np.floor(v / ts), 0, hi - 1).astype(np.int64)

    tx0, tx1, ty0, ty1 = tile(x - r, tiles_x), tile(x + r, tiles_x), \
        tile(y - r, tiles_y), tile(y + r, tiles_y)
    sx, sy = tx1 - tx0 + 1, ty1 - ty0 + 1
    tx0 = np.where(sx > ms, np.clip(tile(x, tiles_x) - ms // 2, 0, tiles_x - ms), tx0)
    ty0 = np.where(sy > ms, np.clip(tile(y, tiles_y) - ms // 2, 0, tiles_y - ms), ty0)
    sx, sy = np.minimum(sx, ms), np.minimum(sy, ms)
    return np.stack([tx0, ty0, sx, sy, side["valid"].astype(np.int64)], -1)


def _depth_tie(a, b, c, u, v):
    tol = STEP_TOL["round_rel"]
    return all(abs(float(s["depths"][c, u]) - float(s["depths"][c, v]))
               <= tol * abs(float(s["depths"][c, u])) for s in (a, b))


def _list_tie(la, lb, drop, a, b, c):
    """Whether two front-to-back tile lists differ only by the slots in
    `drop` (binning ties), neighbours swapped at a depth tie, and the tail
    that a dropped slot shifts past the tile's capacity."""
    la, lb = [s for s in la if s not in drop], [s for s in lb if s not in drop]
    i, n = 0, min(len(la), len(lb))
    while i < n:
        if la[i] == lb[i]:
            i += 1
        elif (i + 1 < n and la[i] == lb[i + 1] and la[i + 1] == lb[i]
              and _depth_tie(a, b, c, la[i], la[i + 1])):
            i += 2
        else:
            return False
    return abs(len(la) - len(lb)) <= len(drop)


def binning_agreement(a, b, rcfg, width, height):
    """Tile lists, n_pairs and radii > 0 of the real cameras: the slots
    whose binning differs, each with the thresholds it ties at (empty: a
    fault), and the tiles whose lists differ beyond those ties."""
    tiles_x, tiles_y = -(-width // rcfg.tile_size), -(-height // rcfg.tile_size)
    fa, fb = _footprints(a, rcfg, tiles_x, tiles_y), _footprints(b, rcfg, tiles_x, tiles_y)
    ties, faults = [], []
    for c in np.nonzero(b["cam_mask"])[0]:
        slots = np.nonzero((fa[c] != fb[c]).any(-1) | (a["radii_proj"][c] != b["radii_proj"][c])
                           | ((a["radii"][c] > 0) != (b["radii"][c] > 0)))[0]
        tied = set()
        for s in slots:
            r = float(max(a["radii_proj"][c, s], b["radii_proj"][c, s]))
            why = sorted(_binning_values(a, c, s, r, rcfg, width, height)
                         & _binning_values(b, c, s, r, rcfg, width, height))
            (ties if why else faults).append(dict(cam=int(c), slot=int(s), why=why))
            if why:
                tied.add(int(s))
        for t in range(a["tile_gauss"].shape[1]):
            la = a["tile_gauss"][c, t][a["tile_mask"][c, t]].tolist()
            lb = b["tile_gauss"][c, t][b["tile_mask"][c, t]].tolist()
            if la != lb and not _list_tie(la, lb, tied, a, b, c):
                faults.append(dict(cam=int(c), tile=t, why="tile list"))
        if a["n_pairs"][c] != b["n_pairs"][c] and not tied:
            faults.append(dict(cam=int(c), why="n_pairs", n_pairs=[int(a["n_pairs"][c]),
                                                                   int(b["n_pairs"][c])]))
    return ties, faults


def mapping_step_agreement(a, b, band, shared, mcfg, width, height):
    """One iteration's comparison of side a with side b from the shared
    pre-step state `shared` (numpy: log_scales, alive). `band()` gives side
    a's step records at alpha_cut * (1 +- alpha_band); it is called, and
    the comparison made again with what it moves taken out, only where the
    first comparison finds a fault. Returns the iteration's gaps, ties and
    faults (the names of the outputs that part beyond rounding)."""
    rec = _step_gaps(a, b, [], shared, mcfg, width, height)
    if rec["faults"]:
        rec = _step_gaps(a, b, band(), shared, mcfg, width, height)
    return rec


def _step_gaps(a, b, band, shared, mcfg, width, height):
    from gslam_tpu_torch.mapping.gaussians import TRAINABLE_FIELDS

    tol = STEP_TOL
    faults = []

    def moved(key):  # how far the alpha-cut band moves side a's output
        return sum((np.abs(np.asarray(x[key], np.float64) - np.asarray(a[key], np.float64))
                    for x in band), np.zeros(np.shape(a[key])))

    rec = {}
    for k in ("total_loss", "photometric_loss"):
        rec[k] = [a[k], b[k]]
        if max(abs(a[k] - b[k]) - moved(k), 0.0) > tol["loss_rtol"] * abs(b[k]):
            faults.append(k)

    bin_ties, bin_faults = binning_agreement(a, b, mcfg.render, width, height)
    faults += [f"binning {f}" for f in bin_faults]
    tied_slots = {t["slot"] for t in bin_ties}
    rec["n_pairs"] = [a["n_pairs"][b["cam_mask"]].tolist(), b["n_pairs"][b["cam_mask"]].tolist()]
    decay_off = set(np.nonzero(a["decay"] != b["decay"])[0].tolist()) - tied_slots
    if decay_off:
        faults.append(f"opacity-decay mask at slots {sorted(decay_off)[:10]}")

    live = int(shared["alive"].sum()) * int(b["cam_mask"].sum())
    allowed = max(1, int(np.ceil(tol["touched_share"] * live)))
    off = np.abs(a["n_touched"].astype(np.int64) - b["n_touched"]) - moved("n_touched")
    off[:, sorted(tied_slots)] = 0
    rec["n_touched_off"] = int((off > 0).sum())
    if off.max() > 1 or rec["n_touched_off"] > allowed:
        faults.append("n_touched")

    # the isotropic loss |e^s - e^mean(s)| at its kink: which side of it the
    # float32 mean lands on is rounding, and Adam steps either way by ~lr
    ls = shared["log_scales"].astype(np.float64)
    e = np.exp(ls)
    kink = (np.abs(e - np.exp(ls.mean(1, keepdims=True))) <= tol["iso_rel"] * e) \
        & shared["alive"][:, None]
    flip = 2.0 * mcfg.isotropic_weight * e
    rec.update(iso_kink=int(kink.sum()), iso_splats=int(kink.all(1).sum()), grad_rel={},
               grad_rel_raw={}, sign_flips={}, field_gap={}, alpha_band_entries=0)
    for f in TRAINABLE_FIELDS:
        ga, gb = a[f"g/{f}"].astype(np.float64), b[f"g/{f}"].astype(np.float64)
        gap = np.maximum(np.abs(ga - gb) - moved(f"g/{f}"), 0.0)
        norm = max(float(np.linalg.norm(gb)), 1e-30)
        rec["grad_rel_raw"][f] = float(np.linalg.norm(ga - gb)) / norm
        at_kink = np.zeros(ga.shape, bool)
        if f == "log_scales":
            at_kink = kink
            rec["iso_flips"] = int((at_kink & (gap > 0.5 * flip)).sum())
            gap = np.where(at_kink, np.maximum(gap - flip, 0.0), gap)
        elif f == "quats":  # an isotropic splat's covariance ignores its rotation
            at_kink = np.broadcast_to(kink.all(1)[:, None], ga.shape)
            gap = np.where(at_kink, 0.0, gap)
        rec["grad_rel"][f] = float(np.linalg.norm(gap)) / norm
        if rec["grad_rel"][f] > tol["grad_rel_quats" if f == "quats" else "grad_rel"]:
            faults.append(f"gradient {f}")
        in_band = moved(f"g/{f}") > 0
        rec["alpha_band_entries"] += int(in_band.sum())
        ma, mb = a[f"mu/{f}"], b[f"mu/{f}"]
        clear = ((np.abs(ga) > tol["clear_g"]) & (np.abs(gb) > tol["clear_g"])
                 & (np.abs(ma) > tol["clear_mu"]) & (np.abs(mb) > tol["clear_mu"])
                 & ~at_kink & ~in_band)
        rec["sign_flips"][f] = int((np.sign(ma) != np.sign(mb))[clear].sum())
        if rec["sign_flips"][f]:
            faults.append(f"Adam step sign {f}")
        pb = b[f"p/{f}"].astype(np.float64)
        pgap = np.maximum(np.abs(a[f"p/{f}"] - pb) - moved(f"p/{f}"), 0.0)[clear]
        rec["field_gap"][f] = float(pgap.max()) if pgap.size else 0.0
        if (pgap > tol["field_atol"] + tol["field_rtol"] * np.abs(pb[clear])).any():
            faults.append(f"updated {f}")
    gpa, gpb = a["g_pose"].astype(np.float64), b["g_pose"].astype(np.float64)
    rec["grad_rel"]["pose"] = float(np.maximum(np.abs(gpa - gpb) - moved("g_pose"), 0.0)
                                    .max() / max(np.abs(gpb).max(), 1e-30))
    if rec["grad_rel"]["pose"] > tol["grad_rel"]:
        faults.append("gradient pose")
    rec.update(binning_ties=bin_ties, faults=faults)
    return rec


def stepped_summary(records):
    """The first iteration and output where the sides part beyond rounding
    (None if none does), and the ties over the run."""
    first = next(({"iteration": k, "tensor": r["faults"][0]}
                  for k, r in enumerate(records) if r["faults"]), None)
    return dict(first_part=first, iterations=len(records),
                iso_flips=[r["iso_flips"] for r in records],
                binning_ties=sum(len(r["binning_ties"]) for r in records),
                alpha_band_iterations=[k for k, r in enumerate(records)
                                       if r["alpha_band_entries"]])


class BootstrapStepper:
    """While in a `with` block, each mapping_step that runtime.fused runs on
    the card is also run on the CPU from a copy of the card's state before
    it (and the card's step again at the edges of the alpha-cut band where
    the comparison asks for it); each iteration is compared
    (mapping_step_agreement) and the card's own result returned, so the
    card's run goes on as it would."""

    def __enter__(self):
        import gslam_tpu_torch.runtime.fused as fused

        self.records, self._fused = [], fused
        self._orig = fused.mapping_step

        def stepped(*args):
            *state, width, height, cfg = args
            shared = dict(log_scales=state[0].log_scales.cpu().numpy(),
                          alive=state[0].alive.cpu().numpy())
            b, _ = port_step((*_moved(state, "cpu"), width, height), cfg)
            a, out = port_step((*state, width, height), cfg)

            def band():
                return [port_step((*state, width, height), c)[0] for c in alpha_band_cfgs(cfg)]

            self.records.append(mapping_step_agreement(a, b, band, shared, cfg, width, height))
            return out

        fused.mapping_step = stepped
        return self

    def __exit__(self, *exc):
        self._fused.mapping_step = self._orig


def slam_replay(cfg, ds, w, h, cap, kf_cap, stepped=False):
    """Steps `ds` on the card, each frame stepped again on the CPU from a
    copy of the card's state before it (the same draws: the CPU generator).
    Returns the card's final state and per frame the pose gap, the
    keyframe flag and counts of both, and where the trackers' evaluations
    part; with `stepped`, also frame 0's mapping iterations compared one
    at a time from the card's state (BootstrapStepper), else None."""
    import contextlib

    from gslam_tpu_torch.runtime.checkpoint import fused_state_from_numpy, state_leaves
    from gslam_tpu_torch.runtime.fused import init_fused_state, slam_step

    def to_cpu(state):
        leaves = {"leaf/" + p: v.cpu().numpy() for p, v in state_leaves(state).items()}
        return fused_state_from_numpy(leaves, cfg, device="cpu")

    state = init_fused_state(cfg, cap, kf_cap, h, w, seed=0, device="cuda")
    frames, records = [], None
    for i in range(len(ds)):
        args = (ds.images[i], ds.depths[i], ds.camera.K, w, h, cfg)
        with EvalRecorder() as cpu_evals:
            cpu = slam_step(to_cpu(state), *args)
        stepper = BootstrapStepper() if stepped and i == 0 else contextlib.nullcontext()
        with EvalRecorder() as card_evals, stepper:
            state = slam_step(state, *args)
        if stepped and i == 0:
            records = stepper.records
        dt, drot = pose_gap(state.traj[i:i + 1].cpu(), cpu.traj[i:i + 1])
        frames.append(dict(frame=i, pose_gap_m=dt, rot_gap_rad=drot,
                           keyframe=[bool(state.kf_flags[i]), bool(cpu.kf_flags[i])],
                           **{f: [int(getattr(state, f)), int(getattr(cpu, f))]
                              for f in SLAM_COUNTS},
                           tracker=tracker_agreement(card_evals.evals, cpu_evals.evals,
                                                     cfg.tracking.warmup_steps),
                           prune_ties=prune_ties(state, cpu,
                                                 cfg.mapping.opacity_prune_threshold)))
    return state, frames, records


def phase_slam_reference():
    """A small fused SLAM run on the card (CUDA kernels), each frame held
    against the same step on the CPU (plain versions) from the card's state
    before it, monocular and RGB-D. Per frame the discrete decisions and
    counts must be equal (the live count may differ only by splats that the
    opacity prune splits at its threshold, `prune_ties`: a 40-iteration
    bootstrap can leave a splat's opacity within the two sides' rounding
    drift of it), and the tracker's evaluations must agree: the
    first one's loss within 1e-5 and gradient within 1e-4 (relative), and
    every later one's loss within 1e-5 until the host-side line search
    first branches apart, which may not happen before its first trial. Where
    no evaluation parts, the pose must be within 2 mm / 2 mrad. (On this
    64x48 scene, a 12-evaluation tracker on a 40-iteration bootstrap map
    stops in a flat basin, where such a branch moves the pose by
    millimetres.) A whole monocular CPU run is compared too: its discrete
    decisions must match the card's; its pose and live-count gaps are
    printed. The RGB-D bootstrap is also compared one mapping iteration at
    a time from the card's state (`bootstrap_stepped`): no iteration may
    part beyond STEP_TOL once its ties are taken out."""
    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.runtime.fused import FusedSlam

    w, h, cap, kf_cap = 64, 48, 2048, 8
    ds = SyntheticDataset(seq_len=4, width=w, height=h, n_splats=400, seed=3, device="cpu")
    mono = slam_small_cfg()
    rgbd = with_gt_depths(mono)
    state, mono_frames, _ = slam_replay(mono, ds, w, h, cap, kf_cap)
    _, rgbd_frames, steps = slam_replay(rgbd, ds, w, h, cap, kf_cap, stepped=True)
    stepped = dict(stepped_summary(steps), per_iteration=steps, tolerance=STEP_TOL_TEXT)
    cuda_traj = state.traj[:len(ds)].cpu().numpy()
    slam = FusedSlam(mono, w, h, capacity=cap, kf_capacity=kf_cap, seed=0, device="cpu")
    mc = slam.run(ds, chunk=1, sync_every=0)
    whole = dict(kf_frames=np.nonzero(state.kf_flags[:len(ds)].cpu().numpy())[0].tolist(),
                 inserted_total=int(state.inserted_total),
                 total_map_iters=int(state.total_map_iters), N=int(state.live_count))
    wdt, wdrot = pose_gap(cuda_traj, slam.trajectory)
    emit("slam_reference", mono=mono_frames, rgbd=rgbd_frames, bootstrap_stepped=stepped,
         whole_cuda=whole,
         whole_cpu={k: mc[k] for k in whole}, whole_pose_gap_m=wdt, whole_rot_gap_rad=wdrot,
         tolerance="per frame from the card's state: keyframe flag and counts equal, except "
                   "live counts split only by opacity-prune ties (the dropping side below "
                   "the threshold, the keeping side at or above, both within the largest "
                   "opacity gap over the slots both kept); first "
                   "tracking evaluation loss rtol 1e-5, gradient 1e-4 of its norm; later "
                   "losses rtol 1e-5 until the line search branches, not before its first "
                   "trial; pose within 2 mm / 2 mrad where no evaluation parts; whole "
                   "monocular runs: kf_frames, inserted_total, total_map_iters equal")
    for mode, frames in (("mono", mono_frames), ("rgbd", rgbd_frames)):
        for f in frames:
            where = f"slam_reference {mode}: frame {f['frame']}"
            bad = [k for k in ("keyframe",) + SLAM_COUNTS if f[k][0] != f[k][1]]
            if bad == ["live_count"] and f["prune_ties"]["explained"]:
                bad = []
            check(not bad, f"{where}: {bad} differ: {f}")
            t = f["tracker"]
            if t["n_evals"][1]:
                check(t["first_f_rel"] <= 1e-5 and t["first_g_rel"] <= 1e-4,
                      f"{where}: first tracking evaluation differs: {t}")
            if t["parted_at"] is None:
                check(f["pose_gap_m"] <= 2e-3 and f["rot_gap_rad"] <= 2e-3,
                      f"{where}: poses differ by {f['pose_gap_m']} m, {f['rot_gap_rad']} rad")
            else:
                check(t["parted_at"] >= t["min_part"],
                      f"{where}: tracking evaluations part before the line search: {t}")
    for k in ("kf_frames", "inserted_total", "total_map_iters"):
        check(whole[k] == mc[k], f"slam_reference: whole runs: {k} cuda {whole[k]}, cpu {mc[k]}")
    check(len(steps) == rgbd.mapping.num_iters_init,
          f"slam_reference: {len(steps)} bootstrap iterations stepped")
    check(stepped["first_part"] is None,
          f"slam_reference: the bootstrap parts from a shared state at {stepped['first_part']}: "
          f"{steps[stepped['first_part']['iteration']] if stepped['first_part'] else ''}")


class FrameClock:
    """CUDA events and host-sync counts at the fused step's phase boundaries:
    wraps runtime.fused's slam_step_impl, track_frame_pyramid_impl and
    _mapping_phase for the duration of a `with` block. Host syncs are the
    warnings of torch.cuda.set_sync_debug_mode("warn"), one per
    synchronizing CUDA call."""

    def __init__(self):
        import warnings

        self.frames = []
        self._warnings = warnings

    def _mark(self, name):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.frames[-1][name] = (ev, len(self._seen))

    def __enter__(self):
        import torch

        from gslam_tpu_torch.runtime import fused

        self._fused = fused
        self._orig = {n: getattr(fused, n) for n in
                      ("slam_step_impl", "track_frame_pyramid_impl", "_mapping_phase")}
        orig = self._orig

        def step(*a, **kw):
            self.frames.append({})
            self._mark("start")
            out = orig["slam_step_impl"](*a, **kw)
            self._mark("end")
            return out

        def track(*a, **kw):
            out = orig["track_frame_pyramid_impl"](*a, **kw)
            self._mark("tracked")
            return out

        def mapping(*a, **kw):
            self._mark("map_start")
            out = orig["_mapping_phase"](*a, **kw)
            self._mark("map_end")
            return out

        fused.slam_step_impl, fused.track_frame_pyramid_impl, fused._mapping_phase = (
            step, track, mapping)
        self._catch = self._warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        self._warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        for n, f in self._orig.items():
            setattr(self._fused, n, f)

    def split(self):
        """Per frame: ms and host syncs of tracking, decision + insertion,
        the mapping pass and the whole step."""
        import torch

        torch.cuda.synchronize()
        out = []
        for f in self.frames:
            tracked = f.get("tracked", f["start"])

            def span(a, b):
                return a[0].elapsed_time(b[0]), b[1] - a[1]

            parts = {"tracking": span(f["start"], tracked),
                     "decision_insertion": span(tracked, f["map_start"]),
                     "mapping": span(f["map_start"], f["map_end"]),
                     "step": span(f["start"], f["end"])}
            out.append({**{f"{k}_ms": v[0] for k, v in parts.items()},
                        **{f"{k}_syncs": v[1] for k, v in parts.items()}})
        return out


def phase_slam(smi):
    """The third main path: FusedSlam.run over 12 frames of the port's
    synthetic room at 320x240 with every default but the render config, on
    a 131,072-slot map; the launch counters are set to 0 just before the
    run and read just after."""
    import torch

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.runtime.fused import FusedConfig, FusedSlam
    from gslam_tpu_torch.tracking.track import TrackingConfig

    ds = SyntheticDataset(seq_len=SLAM_FRAMES, width=W, height=H, n_splats=10_000, seed=3,
                          motion_scale=0.015, device="cuda")
    r = RenderConfig(tile_capacity=512, pairs_per_gaussian=8)
    cfg = FusedConfig(tracking=TrackingConfig(render=r), mapping=MapConfig(render=r),
                      max_frames=32)
    slam = FusedSlam(cfg, W, H, capacity=MAP_CAP, kf_capacity=KF_CAP, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with FrameClock() as clock:
        m = slam.run(ds, chunk=1, sync_every=4, eval_stride=4)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(blend.launches)
    binning_launches("slam")
    peak = torch.cuda.max_memory_allocated()
    frames = clock.split()
    rest = frames[1:]
    n_evals = int(slam.telemetry["n_evals"].sum())
    n_eval_views = len(range(0, SLAM_FRAMES, 4))
    # one forward per tracking evaluation, per keyframe-decision camera (2 a
    # frame), per window camera of a mapping iteration (window_size, padded
    # ones included) and per eval view; one backward per evaluation and per
    # window camera of a mapping iteration
    window = cfg.mapping.window_size
    want = {"blend_fwd": n_evals + 2 * m["L"] + window * m["total_map_iters"] + n_eval_views,
            "blend_bwd": n_evals + window * m["total_map_iters"]}

    def med(key):
        return float(np.median([f[key] for f in rest]))

    emit("slam", nvidia_smi=smi, frames=frames, bootstrap_frame=frames[0],
         median_frame={k: med(k) for k in frames[0]}, wall_s=wall_s,
         launches=launches, launches_predicted=want, sum_n_evals=n_evals,
         max_memory_allocated_bytes=int(peak),
         metrics={k: v for k, v in m.items() if k not in ("wall_s", "enqueue_s", "fps_wall")},
         gt_splats=10_000, capacity=MAP_CAP)
    check(np.isfinite(slam.trajectory).all() and m["nonfinite_poses"] == 0,
          "slam: a pose is not finite")
    check(not m["diverged"], f"slam: the run diverged (health {m['health']})")
    check(m["C"] >= 2 and 0 in m["kf_frames"], f"slam: keyframes {m['kf_frames']}")
    check(m["inserted_total"] >= 5000 and m["dropped_inserts"] == 0,
          f"slam: inserted {m['inserted_total']}, dropped {m['dropped_inserts']}")
    check(m["N"] > 500, f"slam: {m['N']} live splats")
    check(m["ate"] < 0.06, f"slam: ATE {m['ate']} m >= 0.06")
    check(launches == want, f"slam: launches {launches} != predicted {want}")
    return launches


def _moved(x, dev):
    """A copy of x with every tensor in it on `dev` (tuples, NamedTuples,
    dicts, lists and sets walked; anything else deep-copied)."""
    import copy

    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(v, dev) for v in x))
    if isinstance(x, (tuple, list, set)):
        return type(x)(_moved(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _moved(v, dev) for k, v in x.items()}
    return copy.deepcopy(x)


def system_copy(system, dev):
    """The SlamSystem's whole state (both actors) copied onto `dev`."""
    import copy

    import torch

    new = copy.copy(system)
    for name in ("frontend", "backend"):
        actor = copy.copy(getattr(system, name))
        actor.__dict__ = {k: _moved(v, dev) for k, v in vars(actor).items()}
        actor.device = torch.device(dev)
        setattr(new, name, actor)
    new.device = torch.device(dev)
    return new


def actor_small_cfg(mode):
    """The actor at slam_small_cfg's sizes (64x48 frames, tile_capacity 64,
    40 + 5 mapping iterations over a window of 4), in one of four modes:
    igs, warp, pgo, rgbd."""
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.runtime.system import SlamConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    r = RenderConfig(tile_capacity=64, pairs_per_gaussian=8)
    track = dict(warmup_steps=5, lbfgs_max_iter=10, lbfgs_max_eval=12, render=r)
    mapping = dict(num_iters_init=40, num_iters_mapping=5, window_size=4, recent_window=4,
                   render=r)
    if mode == "warp":
        track["method"] = "warp"
    elif mode == "pgo":
        mapping.update(enable_pgo=True, kf_m=0.03)
    elif mode == "rgbd":
        track["use_gt_depths"] = mapping["use_gt_depths"] = True
    return SlamConfig(tracking=TrackingConfig(**track), mapping=MapConfig(**mapping),
                      capacity=8192, kf_capacity=8, eval_stride=2)


def actor_replay(mode, ds, w, h):
    """Runs `ds` through a synchronous SlamSystem on the card, each frame run
    again on the CPU from a copy of the card's system before it (the same
    draws: the CPU generator). The CPU's frontend tracks the frame itself
    (its evaluations and pose are compared), then hands its backend the
    card's tracked pose, so the backends' decisions and counts are compared
    from the same inputs. Per frame: the keyframe flag, keyframe and live
    counts and health of both, the pose gap, and where the trackers'
    evaluations part. Returns the card's system and the frames."""
    from gslam_tpu_torch.runtime.system import SlamSystem

    cfg = actor_small_cfg(mode)
    card = SlamSystem(cfg, w, h, device="cuda")
    # the tracker's host-side optimizer: the warp tracker's L-BFGS or igs's
    recorder = (("gslam_tpu_torch.tracking.warp", "lbfgs_impl") if mode == "warp" else
                ("gslam_tpu_torch.tracking.track", "warmup_lbfgs_impl"))
    warmup = 0 if mode == "warp" else cfg.tracking.warmup_steps
    frames = []
    for i in range(len(ds)):
        cpu = system_copy(card, "cpu")
        with EvalRecorder(*recorder) as card_evals:
            card._process_frame_sync(ds[i])
        tracked = card.frontend.frames[-1]
        own = {}

        def track(frame, cpu_track=cpu.frontend.track, tracked=tracked, own=own):
            frame = cpu_track(frame)
            own["pose"] = frame.est_pose
            frame.est_pose, frame.exposure = tracked.est_pose, tracked.exposure
            frame.rejected = tracked.rejected
            return frame

        cpu.frontend.track = track
        with EvalRecorder(*recorder) as cpu_evals:
            cpu._process_frame_sync(ds[i])
        dt, drot = pose_gap(tracked.est_pose[None], own["pose"][None])
        frames.append(dict(
            frame=i, pose_gap_m=dt, rot_gap_rad=drot,
            **{k: [f(card), f(cpu)] for k, f in (
                ("keyframe", lambda s: i in s.backend.frame_slot),
                ("kf_count", lambda s: len(s.backend.kf_order)),
                ("live", lambda s: s.backend.n_live_splats()),
                ("health", lambda s: s.frontend.health))},
            tracker=tracker_agreement(card_evals.evals, cpu_evals.evals, warmup)))
    return card, frames


def refine_agreement(system):
    """pose_refinement_lbfgs over the system's window, on the card and on a
    CPU copy: the first evaluation's loss and gradient, the evaluations,
    and whether the frozen and padded slots kept their bits."""
    import torch

    from gslam_tpu_torch.mapping import backend_ops

    out = {}
    for dev, sys_ in (("cuda", system), ("cpu", system_copy(system, "cpu"))):
        be = sys_.backend
        widx, wmask = be._window()
        safe = torch.where(wmask, widx, 0)
        frozen = (~wmask | (be.kf.frame_idx[safe] == 0)).cpu().numpy()
        before = torch.cat([be.kf.d_rot6[safe], be.kf.d_t[safe]], -1).cpu().numpy()
        with EvalRecorder("gslam_tpu_torch.mapping.backend_ops", "lbfgs_impl") as rec:
            kf, f, n_evals = backend_ops.pose_refinement_lbfgs(
                be.gmap, be.kf, widx, wmask, be.K, be.width, be.height, be.cfg)
        after = torch.cat([kf.d_rot6[safe], kf.d_t[safe]], -1).cpu().numpy()
        out[dev] = dict(f0=rec.evals[0]["f"], g0=rec.evals[0]["g"], f=float(f),
                        n_evals=n_evals, n_free=int((~frozen).sum()),  # slots
                        frozen_kept=bool((after[frozen] == before[frozen]).all()),
                        moved=float(np.abs(after - before).max()))
    a, b = out["cuda"], out["cpu"]
    return dict(
        first_f_rel=abs(a["f0"] - b["f0"]) / abs(b["f0"]),
        first_g_rel=float(np.linalg.norm(a["g0"] - b["g0"]) / np.linalg.norm(b["g0"])),
        **{k: [a[k], b[k]] for k in ("f0", "f", "n_evals", "n_free", "frozen_kept",
                                     "moved")})


def phase_actor_reference():
    """The actor runtime on a small scene (64x48) on the card, each frame held
    against the same frame on the CPU from a copy of the card's system
    before it, in four modes (igs, warp, pgo, rgbd): per frame the keyframe
    flag and the keyframe, live and health counts must be equal (the CPU's
    backend steps from the card's tracked pose: a pose that parted by a
    millimetre moves a keyframe's inserted splats and can flip one of them
    across the occlusion or pruning threshold); the
    tracker's first evaluation within 1e-5 (loss) and 1e-4 (gradient,
    relative), every later loss within 1e-5 until the host-side line search
    branches, never before its first trial; where no evaluation parts the
    pose within 2 mm / 2 mrad. pose_refinement_lbfgs over each run's final
    window: its first evaluation within rtol 1e-4, frozen and padded slots
    bit for bit. One threaded run must finish with finite poses."""
    import torch

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.runtime.system import SlamSystem

    w, h = 64, 48
    ds = SyntheticDataset(seq_len=4, width=w, height=h, n_splats=400, seed=3,
                          motion_scale=0.02, device="cpu")
    modes, systems = {}, {}
    for mode in ("igs", "warp", "pgo", "rgbd"):
        systems[mode], modes[mode] = actor_replay(mode, ds, w, h)
    refine = {mode: refine_agreement(sys_) for mode, sys_ in systems.items()}
    thr_ds = SyntheticDataset(seq_len=6, width=w, height=h, n_splats=400, seed=2,
                              motion_scale=0.01, device="cpu")
    thr_cfg = dataclasses.replace(actor_small_cfg("igs"), synchronous=False)
    thr_sys = SlamSystem(thr_cfg, w, h, device="cuda")
    thr = thr_sys.run(thr_ds)
    thr_poses = np.stack([f.est_pose for f in thr_sys.frontend.frames])
    torch.cuda.synchronize()
    emit("actor_reference", modes=modes, pose_refinement=refine,
         threaded={k: thr.get(k) for k in ("L", "C", "N", "ate", "health", "diverged")},
         tolerance="per frame from the card's system: keyframe flag, keyframe, live and "
                   "health counts equal; first tracking evaluation loss rtol 1e-5, gradient "
                   "1e-4 of its norm; later losses rtol 1e-5 until the line search branches, "
                   "not before its first trial; pose within 2 mm / 2 mrad where no "
                   "evaluation parts; pose refinement's first evaluation rtol 1e-4, frozen "
                   "slots bit for bit")
    for mode, frames in modes.items():
        for f in frames:
            where = f"actor_reference {mode}: frame {f['frame']}"
            bad = [k for k in ("keyframe", "kf_count", "live", "health") if f[k][0] != f[k][1]]
            check(not bad, f"{where}: {bad} differ: {f}")
            t = f["tracker"]
            if t["n_evals"][1]:
                check(t["first_f_rel"] <= 1e-5 and t["first_g_rel"] <= 1e-4,
                      f"{where}: first tracking evaluation differs: {t}")
            if t["parted_at"] is None:
                check(f["pose_gap_m"] <= 2e-3 and f["rot_gap_rad"] <= 2e-3,
                      f"{where}: poses differ by {f['pose_gap_m']} m, {f['rot_gap_rad']} rad")
            else:
                check(t["parted_at"] >= t["min_part"],
                      f"{where}: tracking evaluations part before the line search: {t}")
        check(sum(f["tracker"]["n_evals"][0] for f in frames) > 0,
              f"actor_reference {mode}: no frame was tracked")
    for mode, r in refine.items():
        where = f"actor_reference {mode}: pose refinement"
        check(r["n_free"][0] >= 1 and r["n_free"] == r["n_free"][::-1],
              f"{where} has no free slot: {r}")
        check(r["first_f_rel"] <= 1e-4 and r["first_g_rel"] <= 1e-4,
              f"{where}: the first evaluation differs: {r}")
        check(all(r["frozen_kept"]), f"{where}: a frozen slot moved: {r}")
    check(thr["L"] == len(thr_ds) and np.isfinite(thr_poses).all(),
          f"actor_reference: the threaded run: {thr}")


class ActorClock:
    """CUDA events and host-sync counts around the actor runtime's parts, per
    frame, for the duration of a `with` block: wraps the system's
    _process_frame_sync (the frame) and, on the actor objects, the frontend's
    track and apply_sync and the backend's initialize, maybe_add_keyframe,
    optimize_map, run_pruning, refine_poses and sync_payload. Host syncs are
    the warnings of torch.cuda.set_sync_debug_mode("warn")."""

    PARTS = (("frontend", "track", "track"), ("frontend", "apply_sync", "sync"),
             ("backend", "initialize", "insert_decision"),
             ("backend", "maybe_add_keyframe", "insert_decision"),
             ("backend", "optimize_map", "map"), ("backend", "run_pruning", "prune"),
             ("backend", "refine_poses", "pose_refine"), ("backend", "sync_payload", "sync"))

    def __init__(self, system):
        import warnings

        self.system = system
        self.frames = []
        self._warnings = warnings
        self._current = None

    def _mark(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev, len(self._seen)

    def _wrap(self, obj, method, part):
        orig = getattr(obj, method)

        def run(*a, **kw):
            start = self._mark()
            out = orig(*a, **kw)
            if self._current is not None:
                self._current["parts"].append((part, start, self._mark()))
            return out

        setattr(obj, method, run)

    def __enter__(self):
        import torch

        for actor, method, part in self.PARTS:
            self._wrap(getattr(self.system, actor), method, part)
        orig = self.system._process_frame_sync

        def frame(f):
            self._current = {"start": self._mark(), "parts": []}
            orig(f)
            self._current["end"] = self._mark()
            self.frames.append(self._current)
            self._current = None

        self.system._process_frame_sync = frame
        self._catch = self._warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        self._warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        for actor, method, _ in self.PARTS:
            vars(getattr(self.system, actor)).pop(method, None)
        vars(self.system).pop("_process_frame_sync", None)

    def split(self):
        """Per frame: ms and host syncs of each part and of the whole frame."""
        import torch

        torch.cuda.synchronize()
        names = sorted({p for _, _, p in self.PARTS})
        out = []
        for f in self.frames:
            row = {"frame_ms": f["start"][0].elapsed_time(f["end"][0]),
                   "frame_syncs": f["end"][1] - f["start"][1]}
            for n in names:
                row[f"{n}_ms"] = sum(a[0].elapsed_time(b[0]) for p, a, b in f["parts"]
                                     if p == n)
                row[f"{n}_syncs"] = sum(b[1] - a[1] for p, a, b in f["parts"] if p == n)
            out.append(row)
        return out


def phase_actor(smi):
    """The fourth main path, main.py's default: SlamSystem over the slam
    phase's 12 frames at 320x240 with every SlamConfig, TrackingConfig and
    MapConfig default but the render config, 131,072 slots, a 32-slot
    keyframe store, telemetry off, eval_stride 4; the launch counters are set
    to 0 just before the run and read just after."""
    import torch

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.runtime.system import SlamConfig, SlamSystem
    from gslam_tpu_torch.tracking.track import TrackingConfig

    ds = SyntheticDataset(seq_len=SLAM_FRAMES, width=W, height=H, n_splats=10_000, seed=3,
                          motion_scale=0.015, device="cuda")
    r = RenderConfig(tile_capacity=512, pairs_per_gaussian=8)
    cfg = SlamConfig(tracking=TrackingConfig(render=r), mapping=MapConfig(render=r),
                     capacity=MAP_CAP, kf_capacity=KF_CAP, telemetry="null", eval_stride=4,
                     synchronous=True)
    system = SlamSystem(cfg, W, H, device="cuda")
    be = system.backend
    # how far each pose refinement moved the store's pose deltas, kept on
    # the card until the run ends (no host sync inside the timed parts)
    moved, refine = [], be.refine_poses

    def refine_poses():
        before = torch.cat([be.kf.d_rot6, be.kf.d_t], -1)
        refine()
        moved.append(torch.amax(torch.abs(torch.cat([be.kf.d_rot6, be.kf.d_t], -1) - before)))

    be.refine_poses = refine_poses
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with ActorClock(system) as clock:
        m = system.run(ds)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(blend.launches)
    binning_launches("actor")
    peak = torch.cuda.max_memory_allocated()
    frames = clock.split()
    rest = frames[1:]
    fe = system.frontend
    n_track = int(sum(fe.evals))
    n_refine = int(sum(be.refine_evals))
    # one forward and one backward per tracking evaluation and per window
    # camera (padded ones included) of each mapping iteration and each pose
    # refinement evaluation; one forward per render_view_stats (the sync
    # render closing each optimize_map, and each run_pruning), per
    # keyframe-decision camera (2 a frame after the first) and per eval view
    window = cfg.mapping.window_size
    view_stats = m["phase_calls"].get("map", 0) + m["phase_calls"].get("prune", 0)
    n_eval_views = len(range(0, m["L"], cfg.eval_stride))
    grads = n_track + window * (be.total_step + n_refine)
    want = {"blend_fwd": grads + view_stats + 2 * (m["L"] - 1) + n_eval_views,
            "blend_bwd": grads}
    poses = np.stack([f.est_pose for f in fe.frames])

    def med(key):
        return float(np.median([f[key] for f in rest]))

    emit("actor", nvidia_smi=smi, frames=frames, bootstrap_frame=frames[0],
         median_frame={k: med(k) for k in frames[0]}, wall_s=wall_s,
         launches=launches, launches_predicted=want,
         counts=dict(track_evals=n_track, refine_evals=be.refine_evals,
                     refine_moved=[float(x) for x in moved],
                     mapping_iterations=be.total_step, view_stats_renders=view_stats,
                     eval_views=n_eval_views),
         max_memory_allocated_bytes=int(peak),
         metrics={k: v for k, v in m.items() if k not in ("wall_time_s",)},
         gt_splats=10_000, capacity=MAP_CAP)
    check(np.isfinite(poses).all() and m["nonfinite_poses"] == 0, "actor: a pose is not finite")
    check(not m["diverged"], f"actor: the run diverged (health {m['health']})")
    check(m["C"] >= 2, f"actor: {m['C']} keyframes")
    check(m["ate"] < 0.06, f"actor: ATE {m['ate']} m >= 0.06")
    check(launches == want, f"actor: launches {launches} != predicted {want}")
    return launches


SHARDED_BANDS = 2  # the sharded path's depth bands


def sharded_devices(n):
    """n devices for a mesh: one per card where the host has n cards, else
    cuda:0 repeated (two bands then share the card)."""
    import torch

    count = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if count >= n else ["cuda:0"] * n


def sharded_scene(device, n=256, width=64, height=48, seed=7):
    """tests/test_sharded_slam.py's scene (scene_utils.make_scene: n splats
    at depths 2-4 before a 64x48 camera), depth-ordered at the identity, its
    Adam state and K."""
    import torch

    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.mapping.optimizer import init_adam
    from gslam_tpu_torch.parallel.sharding import partition_by_depth

    rng = np.random.default_rng(seed)
    fx = 0.9 * width
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32)
    z = rng.uniform(2.0, 4.0, n)
    u, v = rng.uniform(4, width - 4, n), rng.uniform(4, height - 4, n)
    quats = rng.normal(size=(n, 4))
    gmap = gaussian_map_from_numpy(dict(
        means=np.stack([(u - width / 2) * z / fx, (v - height / 2) * z / fx, z], -1),
        quats=quats / np.linalg.norm(quats, axis=-1, keepdims=True),
        log_scales=np.log(rng.uniform(0.04, 0.12, (n, 3))),
        logit_opacities=rng.uniform(-1.0, 3.0, n), logit_colors=rng.normal(size=(n, 3)),
        log_uncertainties=rng.uniform(-0.5, 0.5, n), alive=np.ones(n, bool)), device=device)
    gmap, opt = partition_by_depth(gmap, torch.eye(4, device=device), init_adam(gmap))
    return gmap, opt, torch.tensor(K, device=device)


class LossRecorder:
    """Records each loss the parallel steps compute (sharding._mapping_loss)
    while in a `with` block."""

    def __enter__(self):
        from gslam_tpu_torch.parallel import sharding

        self.losses, self._mod = [], sharding
        self._orig = sharding._mapping_loss

        def loss(*a, **kw):
            out = self._orig(*a, **kw)
            self.losses.append(float(out.detach()))
            return out

        sharding._mapping_loss = loss
        return self

    def __exit__(self, *exc):
        self._mod._mapping_loss = self._orig


def step_agreement(a, b):
    """Two results (map or bands, Adam state or bands, pose_vec) of one
    mapping step from the same inputs: the largest first-moment gap per
    field relative to the field's largest |mu| (mu = 0.1 g after one step),
    the largest parameter gap where |g| > 1e-4 in both, and the pose_vec
    gap."""
    import torch

    from gslam_tpu_torch.parallel.sharding import join_bands

    def joined(x):
        return join_bands(x, "cpu") if isinstance(x, list) else join_bands([x], "cpu")

    (ma, oa, pa), (mb, ob, pb) = ((joined(m), joined(o), p.cpu()) for m, o, p in (a, b))
    mu_rel, param = 0.0, 0.0
    for f in oa.mu:
        ga, gb = oa.mu[f], ob.mu[f]
        mu_rel = max(mu_rel, float((ga - gb).abs().max() / gb.abs().max().clamp(min=1e-30)))
        big = (ga.abs() > 1e-5) & (gb.abs() > 1e-5)
        if bool(big.any()):
            param = max(param, float((getattr(ma, f) - getattr(mb, f))[big].abs().max()))
    return dict(mu_rel=mu_rel, param_max_abs=param,
                pose_vec_max_abs=float((pa - pb).abs().max()))


def sharded_small_cfg():
    """tests/test_torch_sharded_slam.py's configuration with the pose graph
    and densification (its mesh-size invariance run), at 64x48."""
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.parallel.slam import ShardedSlamConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    r = RenderConfig(tile_capacity=64, pairs_per_gaussian=8)
    return ShardedSlamConfig(
        tracking=TrackingConfig(warmup_steps=4, lbfgs_max_iter=20, lbfgs_max_eval=25, render=r),
        mapping=MapConfig(window_size=3, recent_window=2, num_iters_init=20,
                          num_iters_mapping=4, enable_pgo=True, densify_every=8,
                          densify_max_new=32, render=r),
        init_n_new=600, kf_n_new=100, idle_iters=1)


def phase_sharded_reference():
    """The multi-device package on a small scene, card against CPU, two
    bands on the card's devices against two on ["cpu"] * 2: gauss_render,
    one make_gauss_mapping_step, one dp_mapping_train_step, the banded
    tracking loss and gradient at x0; two bands against one on the card;
    then 4 ShardedSlam frames, each stepped again on the CPU from a copy of
    the card's state before it (the same draws)."""
    import torch

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops.rasterize import RenderConfig, compute_bins
    from gslam_tpu_torch.parallel import sharding as ts
    from gslam_tpu_torch.parallel.slam import ShardedSlam, ShardedSlamConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    w, h, D = 64, 48, SHARDED_BANDS
    card_devs = sharded_devices(D)
    cfg = MapConfig(render=RenderConfig(tile_capacity=160, pairs_per_gaussian=8))
    res, parts = {}, {}
    for name, devs in (("cuda", card_devs), ("cpu", ["cpu"] * D), ("cuda_1", ["cuda:0"])):
        gmap, opt, K = sharded_scene(devs[0])
        vms = torch.eye(4, device=devs[0]).repeat(2, 1, 1)
        vms[1, 0, 3] = 0.05
        Ks = K[None].expand(2, 3, 3)
        mesh = ts.make_mesh(len(devs), axis="gauss", devices=devs)
        bands = ts.split_bands(gmap, mesh.axis_devices("gauss"))
        out = {"render": [x.cpu() for x in ts.gauss_render(mesh, bands, vms, Ks, w, h, cfg)]}
        if name == "cuda_1":
            bins = compute_bins(gmap.means, gmap.quats, gmap.log_scales, gmap.alive, vms,
                                Ks, w, h, cfg.render)
            out["max_list"] = int(bins.tile_mask.sum(-1).max())
            res[name] = out
            continue
        rng = np.random.default_rng(11)
        gt = torch.tensor(rng.random((2, h, w, 3)), dtype=torch.float32, device=devs[0])
        exps = torch.tensor(rng.normal(scale=0.05, size=(2, 2)), dtype=torch.float32,
                            device=devs[0])
        pv = torch.zeros((2, 9), device=devs[0])
        with LossRecorder() as rec:
            out["gauss_step"] = ts.make_gauss_mapping_step(mesh, w, h, cfg)(
                bands, ts.split_bands(opt, mesh.axis_devices("gauss")), pv, vms, gt, exps, Ks)
            out["dp_step"] = ts.dp_mapping_train_step(
                gmap, opt, pv, vms, gt, exps, Ks, w, h, cfg,
                mesh=ts.make_mesh(D, devices=devs))
        out["losses"] = rec.losses
        # the banded tracking loss and its gradient at x0
        tcfg = ShardedSlamConfig(tracking=TrackingConfig(warmup_steps=0, lbfgs_max_eval=1,
                                                         render=cfg.render))
        slam = ShardedSlam(tcfg, mesh, w, h, capacity=gmap.capacity, kf_capacity=4)
        slam._set_joined(gmap, opt)
        with EvalRecorder("gslam_tpu_torch.parallel.slam") as evals:
            slam._track(vms[1], torch.zeros(2, device=devs[0]), gt[0], K,
                        torch.zeros((h, w), device=devs[0]))
        out["track"] = evals.evals[0]
        res[name] = out

    def gap(a, b):
        return [float((x - y).abs().max()) for x, y in zip(a, b)]

    parts["render_card_vs_cpu"] = gap(res["cuda"]["render"], res["cpu"]["render"])
    parts["render_2_vs_1_band"] = gap(res["cuda"]["render"], res["cuda_1"]["render"])
    parts["max_list_1_band"] = res["cuda_1"]["max_list"]
    parts["losses"] = {k: res[k]["losses"] for k in ("cuda", "cpu")}
    parts["gauss_step"] = step_agreement(res["cuda"]["gauss_step"], res["cpu"]["gauss_step"])
    parts["dp_step"] = step_agreement(res["cuda"]["dp_step"], res["cpu"]["dp_step"])
    ta, tb = res["cuda"]["track"], res["cpu"]["track"]
    parts["track_f_rel"] = abs(ta["f"] - tb["f"]) / abs(tb["f"])
    parts["track_g_rel"] = float(np.linalg.norm(ta["g"] - tb["g"]) / np.linalg.norm(tb["g"]))

    # 4 frames of the loop, card and CPU from the card's state
    scfg = sharded_small_cfg()
    ds = SyntheticDataset(seq_len=4, width=w, height=h, n_splats=400, seed=3,
                          motion_scale=0.01, device="cpu")
    card = ShardedSlam(scfg, ts.make_mesh(D, axis="gauss", devices=card_devs), w, h,
                       capacity=1024, kf_capacity=8)
    frames = []
    for i in range(len(ds)):
        cpu = ShardedSlam(scfg, ts.make_mesh(D, axis="gauss", devices=["cpu"] * D), w, h,
                          capacity=1024, kf_capacity=8)
        cpu.load_state(card.state_to_numpy())
        with EvalRecorder("gslam_tpu_torch.parallel.slam") as cpu_evals:
            cpu.step(i, ds.images[i], None, ds.camera.K)
        with EvalRecorder("gslam_tpu_torch.parallel.slam") as card_evals:
            card.step(i, ds.images[i], None, ds.camera.K)
        dt, drot = pose_gap(card.trajectory[-1][None], cpu.trajectory[-1][None])
        frames.append(dict(
            frame=i, pose_gap_m=dt, rot_gap_rad=drot,
            keyframe=[card.kf_frames[-1] == i, cpu.kf_frames[-1] == i],
            **{k: [int(getattr(s, k)) for s in (card, cpu)]
               for k in ("kf_count", "health", "loop_closures", "total_map_iters")},
            live=[sum(int(b.n_live()) for b in s.bands) for s in (card, cpu)],
            tracker=tracker_agreement(card_evals.evals, cpu_evals.evals,
                                      scfg.tracking.warmup_steps)))
    emit("sharded_reference", devices=card_devs, frames=frames, **parts,
         tolerance="card vs CPU (2 bands each): render rgb/alpha 2e-5, depth/beta 1e-4; "
                   "step losses rtol 1e-5, first moments within 1e-4 of each field's "
                   "largest, parameters 1e-5 where |g| > 1e-4, pose_vec 1e-6; tracking "
                   "loss and gradient at x0 rtol 1e-4; 2 bands vs 1 on the card: 2e-5 / "
                   "1e-4 (unsaturated lists); frames: keyframe flag, C, live, health, "
                   "loop closures equal, tracker as slam_reference")
    for k, g in (("render_card_vs_cpu", parts["render_card_vs_cpu"]),
                 ("render_2_vs_1_band", parts["render_2_vs_1_band"])):
        check(max(g[:2]) <= 2e-5 and max(g[2:]) <= 1e-4, f"sharded_reference: {k} {g}")
    check(parts["max_list_1_band"] < cfg.render.tile_capacity,
          f"sharded_reference: one band's lists saturate ({parts['max_list_1_band']})")
    la, lb = parts["losses"]["cuda"], parts["losses"]["cpu"]
    check(len(la) == len(lb) == 2 and all(abs(a / b - 1) <= 1e-5 for a, b in zip(la, lb)),
          f"sharded_reference: step losses {la} vs {lb}")
    for k in ("gauss_step", "dp_step"):
        s = parts[k]
        check(s["mu_rel"] <= 1e-4 and s["param_max_abs"] <= 1e-5
              and s["pose_vec_max_abs"] <= 1e-6, f"sharded_reference: {k} {s}")
    check(parts["track_f_rel"] <= 1e-4 and parts["track_g_rel"] <= 1e-4,
          f"sharded_reference: tracking at x0 f {parts['track_f_rel']} g {parts['track_g_rel']}")
    for f in frames:
        where = f"sharded_reference: frame {f['frame']}"
        bad = [k for k in ("keyframe", "kf_count", "health", "loop_closures",
                           "total_map_iters", "live") if f[k][0] != f[k][1]]
        check(not bad, f"{where}: {bad} differ: {f}")
        t = f["tracker"]
        if t["n_evals"][1]:
            check(t["first_f_rel"] <= 1e-5 and t["first_g_rel"] <= 1e-4,
                  f"{where}: first tracking evaluation differs: {t}")
        if t["parted_at"] is None:
            check(f["pose_gap_m"] <= 2e-3 and f["rot_gap_rad"] <= 2e-3,
                  f"{where}: poses differ by {f['pose_gap_m']} m, {f['rot_gap_rad']} rad")
        else:
            check(t["parted_at"] >= t["min_part"],
                  f"{where}: tracking evaluations part before the line search: {t}")


class ShardedClock:
    """CUDA events and host-sync counts around ShardedSlam's parts, per
    frame, for the duration of a `with` block: wraps the instance's step (the
    frame), _repartition_all, _track, _kd_stats, _insert, _run_mapping,
    _densify and _prune. Host syncs are the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""

    PARTS = (("_repartition_all", "repartition"), ("_track", "track"),
             ("_kd_stats", "kd_stats"), ("_insert", "insert"), ("_run_mapping", "map"),
             ("_densify", "densify_prune"), ("_prune", "densify_prune"))

    def __init__(self, slam):
        import warnings

        self.slam, self.frames, self._warnings, self._current = slam, [], warnings, None

    def _mark(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev, len(self._seen)

    def _wrap(self, method, part):
        orig = getattr(self.slam, method)

        def run(*a, **kw):
            start = self._mark()
            out = orig(*a, **kw)
            if self._current is not None:
                self._current["parts"].append((part, start, self._mark()))
                if method == "_track":
                    self._current["evals"] = out[3]
            return out

        setattr(self.slam, method, run)

    def __enter__(self):
        import torch

        for method, part in self.PARTS:
            self._wrap(method, part)
        orig = self.slam.step

        def step(*a, **kw):
            iters = self.slam.total_map_iters
            self._current = {"start": self._mark(), "parts": [], "evals": 0}
            orig(*a, **kw)
            self._current["end"] = self._mark()
            self._current["map_iters"] = self.slam.total_map_iters - iters
            self.frames.append(self._current)
            self._current = None

        self.slam.step = step
        self._catch = self._warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        self._warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        for method, _ in self.PARTS + (("step", None),):
            vars(self.slam).pop(method, None)

    def split(self):
        """Per frame: ms and host syncs of each part and of the whole frame,
        tracking evaluations and mapping iterations."""
        import torch

        torch.cuda.synchronize()
        names = sorted({p for _, p in self.PARTS})
        out = []
        for f in self.frames:
            row = {"frame_ms": f["start"][0].elapsed_time(f["end"][0]),
                   "frame_syncs": f["end"][1] - f["start"][1],
                   "evals": f["evals"], "map_iters": f["map_iters"]}
            for n in names:
                row[f"{n}_ms"] = sum(a[0].elapsed_time(b[0]) for p, a, b in f["parts"]
                                     if p == n)
                row[f"{n}_syncs"] = sum(b[1] - a[1] for p, a, b in f["parts"] if p == n)
            out.append(row)
        return out


def timed_step(fn):
    """fn() between CUDA events: (its result, ms)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def mapping_point_parallel(point):
    """One dp_mapping_train_step over two camera chunks and one hybrid 2x2
    step at the mapping point, each against the same step on one device
    from the same inputs: dp on a one-device mesh, the hybrid step against
    the splat-sharded step over the same two bands on cuda:0 (at 100,000
    live splats one band's 512-slot tile lists saturate, so one band renders
    fewer splats than two: its loss, `gauss_1`, is printed, not compared).
    Each step runs twice, the second timed. Returns the comparison, the ms
    and the launches."""
    import torch

    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.parallel import sharding as ts

    gmap, opt, kf, _pose_opt, widx, _wmask, K, cfg = point
    C = widx.shape[0]
    with torch.no_grad():
        pose_base = kf.poses()[widx]
    cams = (torch.zeros((C, 9), device="cuda"), pose_base, kf.images[widx],
            kf.exposures[widx], K[None].expand(C, 3, 3))
    gp, op = ts.partition_by_depth(gmap, pose_base[0], opt)
    n_cards = torch.cuda.device_count()
    hyb_devs = [f"cuda:{g % n_cards}" for g in range(2) for _ in range(2)]
    runs = {
        "dp_2": lambda: ts.dp_mapping_train_step(
            gmap, opt, *cams, W, H, cfg, mesh=ts.make_mesh(2, devices=sharded_devices(2))),
        "dp_1": lambda: ts.dp_mapping_train_step(
            gmap, opt, *cams, W, H, cfg, mesh=ts.make_mesh(1, devices=["cuda:0"])),
        "hybrid_2x2": lambda: ts.make_hybrid_mapping_step(
            ts.make_hybrid_mesh(2, 2, devices=hyb_devs), W, H, cfg)(
            ts.split_bands(gp, hyb_devs[::2]), ts.split_bands(op, hyb_devs[::2]), *cams),
        "gauss_2": lambda: ts.make_gauss_mapping_step(
            ts.make_mesh(2, axis="gauss", devices=["cuda:0"] * 2), W, H, cfg)(
            ts.split_bands(gp, ["cuda:0"] * 2), ts.split_bands(op, ["cuda:0"] * 2), *cams),
        "gauss_1": lambda: ts.make_gauss_mapping_step(
            ts.make_mesh(1, axis="gauss", devices=["cuda:0"]), W, H, cfg)(
            [gp], [op], *cams),
    }
    out, ms, losses, launches = {}, {}, {}, {}
    for name, fn in runs.items():
        blend.reset_launches()
        with LossRecorder() as rec:
            out[name] = fn()
            _, ms[name] = timed_step(fn)
        launches[name] = dict(blend.launches)
        losses[name] = rec.losses
    res = dict(ms=ms, losses=losses, launches=launches,
               dp=step_agreement(out["dp_2"], out["dp_1"]),
               hybrid=step_agreement(out["hybrid_2x2"], out["gauss_2"]),
               devices={"dp": sharded_devices(2), "hybrid": hyb_devs})
    for a, b in (("dp_2", "dp_1"), ("hybrid_2x2", "gauss_2")):
        la, lb = losses[a], losses[b]
        check(len(la) == len(lb) == 2 and all(abs(x / y - 1) <= 1e-5 for x, y in zip(la, lb)),
              f"sharded: {a} losses {la} vs {b} {lb}")
    for k in ("dp", "hybrid"):
        check(res[k]["mu_rel"] <= 1e-4 and res[k]["param_max_abs"] <= 1e-5
              and res[k]["pose_vec_max_abs"] <= 1e-6, f"sharded: {k} step {res[k]}")
    for name, n in launches.items():
        # two calls, each one launch of each kernel per camera and band
        per_call = C * (2 if name in ("hybrid_2x2", "gauss_2") else 1)
        check(n == {"blend_fwd": 2 * per_call, "blend_bwd": 2 * per_call},
              f"sharded: {name} launched {n}")
    return res


def phase_sharded(smi):
    """The sixth main path: ShardedSlam.run over the slam phase's frames at
    320x240 with every config default but the render config, 131,072 slots
    in two depth bands of 65,536 (one per card, or both on cuda:0), a
    32-slot ring, eval_stride 4; the launch counters are set to 0 just
    before the run and read just after. Then the camera-DP and hybrid steps
    at the mapping point against one device."""
    import torch

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.backend_ops import MapConfig
    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.parallel.sharding import make_mesh
    from gslam_tpu_torch.parallel.slam import ShardedSlam, ShardedSlamConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    D, eval_stride = SHARDED_BANDS, 4
    devs = sharded_devices(D)
    print(f"sharded: {D} bands on {devs}", flush=True)
    ds = SyntheticDataset(seq_len=SHARDED_FRAMES, width=W, height=H, n_splats=10_000,
                          seed=3, motion_scale=0.015, device="cuda")
    r = RenderConfig(tile_capacity=512, pairs_per_gaussian=8)
    cfg = ShardedSlamConfig(tracking=TrackingConfig(render=r), mapping=MapConfig(render=r))
    slam = ShardedSlam(cfg, make_mesh(D, axis="gauss", devices=devs), W, H,
                       capacity=MAP_CAP, kf_capacity=KF_CAP, seed=0)
    cards = range(torch.cuda.device_count())
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    reset_launches()
    t0 = time.perf_counter()
    with ShardedClock(slam) as clock:
        m = slam.run(ds, eval_stride=eval_stride)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(blend.launches)
    binning_launches("sharded")
    peaks = [torch.cuda.max_memory_allocated(d) for d in cards]
    frames = clock.split()
    n_evals = sum(f["evals"] for f in frames)
    n_eval_views = len(range(0, m["L"], eval_stride))
    # per band: one forward and one backward per tracking evaluation and
    # per window camera (padded ones included) of each mapping iteration;
    # one forward per keyframe decision (a frame after the first) and per
    # eval view (no visibility renders: the pose graph is off)
    window = cfg.mapping.window_size
    grads = n_evals + window * m["total_map_iters"]
    want = {"blend_fwd": D * (grads + (m["L"] - 1) + n_eval_views),
            "blend_bwd": D * grads}

    def med(key):
        return float(np.median([f[key] for f in frames[1:]]))

    emit("sharded", nvidia_smi=smi, devices=devs, bands=D, frames=frames,
         bootstrap_frame=frames[0], median_frame={k: med(k) for k in frames[0]},
         wall_s=wall_s, launches=launches, launches_predicted=want, sum_n_evals=n_evals,
         max_memory_allocated_bytes=peaks[0], max_memory_allocated_bytes_by_card=peaks,
         metrics=m, gt_splats=10_000,
         capacity=MAP_CAP)
    check(np.isfinite(np.stack(slam.trajectory)).all() and m["nonfinite_poses"] == 0,
          "sharded: a pose is not finite")
    check(m["health"] == 0, f"sharded: health {m['health']}")
    check(m["C"] >= 2 and 0 in m["kf_frames"], f"sharded: keyframes {m['kf_frames']}")
    check(m["ate"] < 0.06, f"sharded: ATE {m['ate']} m >= 0.06")
    check(launches == want, f"sharded: launches {launches} != predicted {want}")
    del slam
    torch.cuda.empty_cache()
    point = mapping_point()
    steps = mapping_point_parallel(point)
    del point
    emit("sharded_mapping_point", nvidia_smi=smi, **steps,
         tolerance="loss rtol 1e-5; first moments within 1e-4 of each field's largest; "
                   "parameters 1e-5 where |g| > 1e-4; pose_vec 1e-6")
    return launches


CLI_FRAMES = 8


def cli_rows(system):
    """The blend's rows of the cli actor run's first keyframe, as its
    mapping renders gather them: the raytraced room's map at main.py's
    default tile_capacity (T=300, M=256)."""
    import torch

    from gslam_tpu_torch.ops.rasterize import render_rows

    be = system.backend
    cfg = be.cfg.render
    ts = cfg.tile_size
    with torch.no_grad():
        r = render_rows(**be.gmap.render_kwargs(), viewmats=be.kf.poses()[:1],
                        Ks=be.K[None], width=W, height=H, cfg=cfg)
    return [r.xy, r.con, r.op, r.feat], ts, -(-W // ts), cfg
# main_torch's flags for the cli phase: the raytraced room at 320x240 with
# the repo's gate configuration (runs/r5_gate_gn/args.txt), every other flag
# main.py's default (capacity 2^17, kf-capacity 64, tile_capacity 256)
CLI_FLAGS = ["--width", str(W), "--height", str(H), "--seq-len", str(CLI_FRAMES),
             "--seed", "1", "--motion-scale", "0.03", "--use-gt-depths",
             "--set", "tracking.method=gn", "--set", "tracking.pyramid_levels=3",
             "--set", "tracking.gn_iters=8"]


def phase_cli(smi):
    """The fifth main path, the command line as the repo's runs use it:
    main_torch.main in this process, first on the default actor runtime over
    the raytraced room (--dataset raytrace), then over the same 8 frames
    written with save_dataset_npz under chiprun_out/cli/ and read back with
    --dataset npz --fused --chunk 1 --sync-every 4. Each run's launch
    counters are set to 0 just before it and read just after. Prints wall
    time, per-frame CUDA-event ms (median of the frames after the first), C,
    N, ATE, PSNR/SSIM and launches; fails on a crash, a non-finite pose, a
    missing artifact, a trajectory.npy that is not [8, 4, 4], or a blend
    kernel that was not launched. Then holds both kernels against their plain
    version at this path's own shape (cli_rows, compare_and_time) and returns
    (launches, that comparison). ATE is printed, not bounded: the JAX
    package's own fused GN gate diverged on its raytraced room
    (runs/r5_gate_gn/metrics.json)."""
    import os

    import torch

    import main_torch
    from gslam_tpu_torch.io.npz import save_dataset_npz
    from gslam_tpu_torch.io.raytrace import RaytracedDataset
    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.runtime.system import SlamSystem

    out_dir = ROOT / "chiprun_out" / "cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    npz = out_dir / f"raytrace_{W}x{H}_{CLI_FRAMES}.npz"
    save_dataset_npz(RaytracedDataset(seq_len=CLI_FRAMES, width=W, height=H, seed=1,
                                      motion_scale=0.03), npz)
    actor_clocks, actor_systems, run_actor = [], [], SlamSystem.run

    def clocked_run(system, dataset):
        actor_systems.append(system)
        with ActorClock(system) as clock:
            actor_clocks.append(clock)
            return run_actor(system, dataset)

    runs = {}
    cwd = os.getcwd()
    os.chdir(out_dir)  # main_torch writes runs/<run-name>/ under the working directory
    try:
        for name, argv in (("actor", ["--dataset", "raytrace", *CLI_FLAGS]),
                           ("fused", ["--dataset", "npz", "--scene", str(npz), "--fused",
                                      "--chunk", "1", "--sync-every", "4", *CLI_FLAGS])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            if name == "actor":
                SlamSystem.run = clocked_run
                try:
                    m = main_torch.main(argv + ["--run-name", name])
                finally:
                    SlamSystem.run = run_actor
                frames = [f["frame_ms"] for f in actor_clocks[-1].split()]
            else:
                with FrameClock() as clock:
                    m = main_torch.main(argv + ["--run-name", name])
                frames = [f["step_ms"] for f in clock.split()]
            torch.cuda.synchronize()
            run_dir = out_dir / "runs" / name
            traj = (np.load(run_dir / "trajectory.npy")
                    if (run_dir / "trajectory.npy").is_file() else None)
            need = ("metrics.json", "args.txt", "trajectory.npy") + (
                ("splats.npz",) if name == "actor" else ("telemetry.npz",))
            binning_launches("cli", add=True)
            runs[name] = dict(
                wall_s=time.perf_counter() - t0, launches=dict(blend.launches),
                frame_ms=frames, bootstrap_ms=frames[0],
                median_later_frame_ms=float(np.median(frames[1:])),
                max_memory_allocated_bytes=int(torch.cuda.max_memory_allocated()),
                missing=[f for f in need if not (run_dir / f).is_file()],
                trajectory_shape=None if traj is None else list(traj.shape),
                trajectory_finite=traj is not None and bool(np.isfinite(traj).all()),
                metrics={k: m.get(k) for k in ("C", "N", "L", "ate", "ate_rmse", "psnr",
                                               "ssim", "health", "diverged",
                                               "nonfinite_poses", "mean_track_evals",
                                               "total_map_iters", "kf_frames")})
    finally:
        os.chdir(cwd)
    emit("cli", nvidia_smi=smi, flags=CLI_FLAGS, **runs)
    for name, c in runs.items():
        where = f"cli {name}"
        check(not c["missing"], f"{where}: missing artifacts {c['missing']}")
        check(c["trajectory_shape"] == [CLI_FRAMES, 4, 4],
              f"{where}: trajectory.npy is {c['trajectory_shape']}")
        check(c["trajectory_finite"] and c["metrics"]["nonfinite_poses"] == 0,
              f"{where}: a pose is not finite")
        check(all(v > 0 for v in c["launches"].values()),
              f"{where}: a blend kernel was not launched: {c['launches']}")
    launches = {k: sum(c["launches"][k] for c in runs.values()) for k in blend.launches}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = compare_and_time(*cli_rows(actor_systems[-1]), gen)
    emit("kernels_vs_plain_cli", nvidia_smi=smi, cli_full_res=shape, tolerance=TOLERANCE)
    check(shape["T"] == 300 and shape["M"] == 256,
          f"unexpected cli shape {shape['T']}x{shape['M']}")
    return launches, shape


def tools():
    """The port's tools under scripts/, imported as modules."""
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    import bench_1m_torch
    import demo_track_torch
    import repro_f16_torch
    import study_tracking_torch

    return bench_1m_torch, study_tracking_torch, demo_track_torch, repro_f16_torch


def tiles_over_capacity(gmap, poses, K, width, height, cfg):
    """Per camera, the tiles whose list holds more splats than
    tile_capacity keeps (binning's tile_counts before truncation)."""
    import torch

    from gslam_tpu_torch.ops.binning import bin_gaussians
    from gslam_tpu_torch.ops.rasterize import project_cameras

    ts = cfg.tile_size
    with torch.no_grad():
        proj = project_cameras(gmap.means, gmap.quats, torch.exp(gmap.log_scales), gmap.alive,
                               poses, K[None].expand(poses.shape[0], 3, 3), width, height,
                               cfg)
        return [int((bin_gaussians(proj.means2d[c], proj.radii[c], proj.depths[c],
                                   proj.valid[c], ts, -(-width // ts), -(-height // ts),
                                   int(cfg.pairs_per_gaussian * gmap.capacity),
                                   cfg.tile_capacity, cfg.max_span).tile_counts
                     > cfg.tile_capacity).sum())
                for c in range(poses.shape[0])]


def phase_onemillion(smi):
    """The seventh main path, BASELINE config 3's scale point, through
    scripts/bench_1m_torch.py (point_arrays, build_point, measure) with the
    launch counters set to 0 just before it. The point is built once: the
    blend pair is held against its plain versions (compare_and_time, as in
    phase 2) on the first window camera's rows of the fresh map before the
    path runs and of the map its mapping steps leave after it. Returns its
    launches and the two comparisons."""
    import torch

    from gslam_tpu_torch.ops import blend
    from gslam_tpu_torch.ops.rasterize import render_rows

    bench, *_ = tools()
    w, h = bench.W, bench.H
    t0 = time.perf_counter()
    point = bench.build_point(*bench.point_arrays(), device="cuda")
    build_s = time.perf_counter() - t0
    gmap, _opt, kf, _pose_opt, widx, _wmask, K, cfg = point
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"onemillion": compare_and_time(
        *onemillion_rows(gmap, kf, widx, K, cfg, w, h), gen)}
    with torch.no_grad():
        bin_row = binning_vs_plain(binning_inputs(lambda: render_rows(
            **gmap.render_kwargs(), viewmats=kf.poses()[widx],
            Ks=K[None].expand(len(widx), 3, 3), width=w, height=h, cfg=cfg.render)))
    emit("onemillion_binning_vs_plain", nvidia_smi=smi, onemillion=bin_row)
    check(bin_row["C"] == len(widx) and bin_row["T"] == 1200 and bin_row["M"] == 256
          and bin_row["max_pairs"] == 4 * bench.CAP, f"unexpected 1M binning shape {bin_row}")
    reset_launches()
    detail, steps, state = bench.measure(point)
    launches = dict(blend.launches)
    bin_launches = binning_launches("onemillion")
    line = bench.result_line(detail, steps, w, h)
    print(json.dumps(line), flush=True)

    gmap, _opt, kf, _pose_opt = state
    shapes["onemillion_after_pass"] = compare_and_time(
        *onemillion_rows(gmap, kf, widx, K, cfg, w, h), gen)
    emit("onemillion_kernels_vs_plain", nvidia_smi=smi, tolerance=TOLERANCE, **shapes)
    for name, r in shapes.items():
        check(r["T"] == 1200 and r["M"] == 256, f"unexpected {name} shape {r['T']}x{r['M']}")
    window = int(widx.shape[0])
    n_steps = len(steps)
    timed = [st for st in steps if not st["warmup"]]
    budget = int(cfg.render.pairs_per_gaussian * bench.CAP)
    reps = 1 + bench.RENDER_REPS  # the warm-up render and the timed ones
    expected = {"blend_fwd": reps + window * n_steps, "blend_bwd": window * n_steps}
    finite = (all(np.isfinite([st["total_loss"] for st in steps]))
              and all(bool(torch.isfinite(x).all()) for x in gmap.trainable().values())
              and bool(torch.isfinite(kf.d_t).all()) and bool(torch.isfinite(kf.d_rot6).all()))
    over = tiles_over_capacity(gmap, kf.poses()[widx], K, w, h, cfg.render)
    result = dict(
        nvidia_smi=smi, build_s=build_s, n_steps=n_steps, n_warmup=n_steps - len(timed),
        launches=launches, expected_launches=expected, binning_launches=bin_launches,
        blend_launches_per_render=detail["blend_launches_per_render"],
        blend_launches_per_step=detail["blend_launches_per_step"],
        photometric_loss_first3=float(np.mean([st["photometric_loss"] for st in timed[:3]])),
        photometric_loss_last3=float(np.mean([st["photometric_loss"] for st in timed[-3:]])),
        total_loss=[st["total_loss"] for st in steps],
        max_n_pairs=max(st["max_n_pairs"] for st in steps), pair_budget=budget,
        tiles_over_capacity=over,
        tiles_per_camera=-(-w // cfg.render.tile_size) * -(-h // cfg.render.tile_size),
        max_memory_allocated_bytes=detail["max_memory_allocated_bytes"], finite=finite)
    emit("onemillion", **result)
    check(detail["blend_launches_per_render"] == {"blend_fwd": 1, "blend_bwd": 0},
          f"a render launched {detail['blend_launches_per_render']}, expected 1 + 0")
    check(detail["blend_launches_per_step"] == {"blend_fwd": window, "blend_bwd": window},
          f"a step launched {detail['blend_launches_per_step']}, expected {window} + {window}")
    check(launches == expected, f"onemillion launched {launches}, expected {expected}")
    check(bin_launches["bin_count"] == reps + n_steps,
          f"onemillion binned {bin_launches}, expected one call a render and a step "
          f"({reps} + {n_steps})")
    check(finite and detail["render_finite"], "onemillion produced non-finite values")
    check(result["photometric_loss_last3"] < result["photometric_loss_first3"],
          "the photometric loss did not fall over the pass")
    check(result["max_n_pairs"] > 0, "onemillion binned no pair")
    return launches, shapes, bin_row


STUDY_FRAMES = 14  # docs/TRACKING_STUDY.md's oracle run


def phase_scripts(smi):
    """The port's tools on the card in this process, with the launch
    counters set to 0 just before them: study_tracking_torch's oracle at its
    defaults (docs/TRACKING_STUDY.md:16-24's run: 160x120, 4,000 splats,
    motion_scale 0.045, 200 evaluations) over 14 frames, demo_track_torch and
    repro_f16_torch. Returns their launches."""
    import torch

    from gslam_tpu_torch.ops import blend

    _bench, study, demo, repro = tools()
    reset_launches()
    times = {}
    t0 = time.perf_counter()
    oracle = study.main(["oracle", "--frames", str(STUDY_FRAMES)])
    times["study_oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        recovered = demo.main([out_dir])
    times["demo_track_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = repro.main([])
    times["repro_f16_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(blend.launches)
    binning_launches("scripts")

    errs = np.array(oracle["per_frame_err_m"])
    objectives = [row[k][f] for row in rows[1:] for k in ("prior", "gt", "diverged", "tracked")
                  for f in ("photo", "depth", "total")]
    emit("scripts", nvidia_smi=smi, launches=launches, **times,
         study_oracle=dict(frames=STUDY_FRAMES, median_err_m=float(np.median(errs)),
                           max_err_m=float(errs.max()), mean_evals=oracle["mean_evals"]),
         demo_track=recovered, repro_f16_rows=len(rows))
    check(len(errs) == STUDY_FRAMES - 1 and np.isfinite(errs).all(),
          f"study oracle: {len(errs)} errors, finite {np.isfinite(errs).all()}")
    check(np.median(errs) < 0.01 and errs.max() < 0.05,
          f"study oracle: median {np.median(errs)} m, largest {errs.max()} m")
    check(recovered["ok"] and np.isfinite(recovered["pose_err_after_m"]),
          f"demo_track did not recover: {recovered}")
    check(len(rows) == 4 and np.isfinite(objectives).all(),
          f"repro_f16: {len(rows)} lines, objectives finite {np.isfinite(objectives).all()}")
    check(all(v > 0 for v in launches.values()), f"scripts: a kernel was not launched {launches}")
    return launches


# the bench path's depth: bench_torch.py's sections at full width, cut in frames and steps
BENCH_DEPTH = {
    "tracking": dict(n_frames=3, marginal={"tracking_device": (2, 4),
                                           "tracking_device_converged": (2, 4),
                                           "tracking_device_gn": (1, 3)}),
    "mapping": dict(marginal=(5, 10)),
    "onemillion": dict(iters=3),
}


def phase_bench(smi):
    """The eighth main path: bench_torch.py's three sections in this
    process on the card at full width and BENCH_DEPTH's cut depth, with the
    launch counters set to 0 just before them. Every part must land with
    bench.py's keys, finite numbers, CUDA-event times and a profiled device
    busy time; each igs frame launches each kernel once per evaluation, a GN
    frame none, a mapping step one of each per window camera and a 1M
    render one forward. Returns the launches."""
    import torch

    import bench_torch
    from gslam_tpu_torch.ops import blend

    reset_launches()
    parts, times = {}, {}
    for section, run in bench_torch.SECTIONS.items():
        t0 = time.perf_counter()
        parts.update(run(device="cuda", **BENCH_DEPTH[section]))
        times[f"{section}_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(blend.launches)
    binning_launches("bench")
    headline = bench_torch._summarize(parts)
    emit("bench", nvidia_smi=smi, launches=launches, **times,
         headline={k: v for k, v in headline.items() if k != "detail"})

    check(list(parts) == [p for ps in bench_torch.SECTION_PARTS.values() for p in ps],
          f"bench parts {list(parts)}")
    for name, part in parts.items():
        missing = set(bench_torch.BENCH_PY_KEYS[name]) - set(part)
        check(not missing, f"bench part {name} lacks bench.py's keys {missing}")
        check(bench_torch.finite(part), f"bench part {name} is not finite")
        check(part["timer"] == "cuda_events", f"bench part {name} timed by {part['timer']}")
        if name.endswith("_device"):
            check((part["device_busy_ms"] or 0) > 0, f"bench part {name}: no device busy time")
    for name in ("tracking_device", "tracking_device_converged"):
        runs = parts[name]["n_evals"]
        per_frame = sum(sum(r) for r in runs.values()) / sum(len(r) for r in runs.values())
        got = parts[name]["blend_launches_per_frame"]
        check(got == {"blend_fwd": per_frame, "blend_bwd": per_frame},
              f"bench {name}: {got} launches a frame, {per_frame} evaluations")
    check(parts["tracking_device_gn"]["blend_launches_per_frame"]
          == {"blend_fwd": 0, "blend_bwd": 0}, "bench: a GN frame launched a blend kernel")
    each = {"blend_fwd": WINDOW, "blend_bwd": WINDOW}
    for name in ("mapping", "mapping_device", "onemillion_device"):
        check(parts[name]["blend_launches_per_step"] == each,
              f"bench {name}: {parts[name]['blend_launches_per_step']} launches a step")
    check(parts["onemillion_device"]["blend_launches_per_render"]
          == {"blend_fwd": 1, "blend_bwd": 0}, "bench: a 1M render did not launch 1 + 0")
    check(parts["tracking"]["final_pose_err_m"] < 0.05,
          f"bench tracking: final error {parts['tracking']['final_pose_err_m']} m")
    check(headline["value"] == parts["tracking_device_gn"]["device_fps_lower_bound"] > 0,
          f"bench headline {headline['value']}")
    check(all(v > 0 for v in launches.values()), f"bench: a kernel was not launched {launches}")
    return launches


BY_SHAPE = ("max_abs_err", "err_over_limit", "ms", "plain_ms", "bound_ms", "bound_by",
            "segments")


def main() -> int:
    if not (ROOT / "gslam_tpu_torch" / "csrc" / "blend.cu").is_file():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(gslam_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    t_start = time.perf_counter()
    smi = phase_env()
    rng = np.random.default_rng(0)
    gmap = gaussian_map_from_numpy(make_map_fields(N_SPLATS, N_SPLATS, rng),
                                   device="cuda")
    xis = rng.normal(scale=0.004, size=(N_FRAMES, 6)).astype(np.float32)
    K = torch.tensor([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], device="cuda")
    tcfg = TrackingConfig(render=RenderConfig(tile_capacity=512, pairs_per_gaussian=8))

    point = mapping_point()
    shapes = phase_kernels(gmap, K, tcfg, point, smi)
    full = shapes["tracking_full_res"]
    bin_rows = phase_binning(gmap, K, tcfg, point, smi)
    phase_reference()
    poses, gts = tracking_frames(gmap, K, tcfg.render, xis)
    launches = phase_tracking(gmap, K, tcfg, poses, gts, smi)
    phase_gn_reference()
    phase_gn(gmap, K, tcfg, poses, gts, smi)
    del poses, gts
    phase_mapping_reference()
    map_launches = phase_mapping(point, smi)
    del point
    phase_slam_reference()
    slam_launches = phase_slam(smi)
    phase_actor_reference()
    actor_launches = phase_actor(smi)
    phase_sharded_reference()
    sharded_launches = phase_sharded(smi)
    cli_launches, shapes["cli_full_res"] = phase_cli(smi)
    onemillion_launches, onemillion_shapes, bin_rows["onemillion"] = phase_onemillion(smi)
    shapes.update(onemillion_shapes)
    scripts_launches = phase_scripts(smi)
    bench_launches = phase_bench(smi)

    replaces = {"blend_fwd": "gslam_tpu/ops/blend_pallas.py:104",
                "blend_bwd": "gslam_tpu/ops/blend_pallas.py:136"}
    # launches: the main paths; launches_by_path: each path's own
    # count, read just after that path ran with the counters set to 0 before
    # it. The headline numbers are the tracking rows (T=300, M=512); by_shape
    # holds every shape the paths give the kernels
    by_path = {"tracking": launches, "mapping": map_launches, "slam": slam_launches,
               "actor": actor_launches, "sharded": sharded_launches, "cli": cli_launches,
               "onemillion": onemillion_launches, "scripts": scripts_launches,
               "bench": bench_launches}
    kernels = [dict(name=name, route="cuda", source="gslam_tpu_torch/csrc/blend.cu",
                    replaces=replaces[name], launches=sum(p[name] for p in by_path.values()),
                    launches_by_path={k: p[name] for k, p in by_path.items()},
                    max_abs_err=full[name]["max_abs_err"], ms=full[name]["ms"],
                    ms_back_to_back=full[name]["ms_back_to_back"],
                    plain_ms=full[name]["plain_ms"], bound_ms=full[name]["bound_ms"],
                    bound_by=full[name]["bound_by"], library_ms=None,
                    by_shape={k: {f: r[name][f] for f in BY_SHAPE if f in r[name]}
                              | {"T": r["T"], "M": r["M"]}
                              for k, r in shapes.items()})
               for name in ("blend_fwd", "blend_bwd")]
    # binning's kernels (they replace no Pallas kernel: the JAX package bins
    # in jnp); launches by path from BIN_LAUNCHES, gn included (it bins, and
    # blends through the forward-mode route); the headline numbers are the
    # 1M window's (vga1m-map's shape), by_shape holds each path's
    head = bin_rows["onemillion"]["kernels"]
    kernels += [dict(name=name, route="cuda", source="gslam_tpu_torch/csrc/binning.cu",
                     replaces=None, launches=sum(p[name] for p in BIN_LAUNCHES.values()),
                     launches_by_path={k: p[name] for k, p in BIN_LAUNCHES.items()},
                     max_abs_err=0, ms=head[name]["ms"], ms_back_to_back=None,
                     plain_ms=head[name]["plain_ms"], bound_ms=head[name]["bound_ms"],
                     bound_by="bytes", library_ms=None,
                     by_shape={k: r["kernels"][name] | {f: r[f] for f in ("C", "N", "T", "M")}
                               for k, r in bin_rows.items()})
                for name in BIN_KERNELS]
    check(set(BIN_LAUNCHES) == set(by_path) | {"gn"} and all(
        p["bin_count"] > 0 for p in BIN_LAUNCHES.values()),
        f"binning launches by path {BIN_LAUNCHES}")
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", total_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
