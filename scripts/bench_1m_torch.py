#!/usr/bin/env python3
"""BASELINE config 3's scale point in the PyTorch port: a single-view render,
`compact_map` and `mapping_step` on a 2^20-slot map with 1,000,000 live
splats at 640x480 (the counterpart of scripts/bench_1m.py).

    python scripts/bench_1m_torch.py                 # on the CUDA card

Prints one JSON line with bench_1m.py's keys. On a card every time comes
from CUDA events: `render_ms` and `compact_ms` are a chain of calls
enqueued back to back; `mapping_iter_ms` is bench_1m.py's host loop (15
steps, then a wait for the card) and `device_mapping_iter_ms` the span from
the first step's start event to the last step's end event. On the CPU the
times are the host clock's (`"timer": "host_clock"`), not a device's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# bench_1m.py:32-69
W, H, FX = 640, 480, 560.0
CAP, N_LIVE, KF_CAP, WINDOW, N_KF = 1 << 20, 1_000_000, 16, 10, 12
KF_SPACING = 0.02  # m along x between keyframes
RENDER_REPS, COMPACT_REPS, MAX_WARMUP, ITERS = 10, 5, 6, 15


def point_arrays(cap=CAP, n_live=N_LIVE, width=W, height=H, fx=FX, n_kf=N_KF):
    """The point's numpy inputs in bench_1m.py's draw order: the map's fields
    (splats spread over the view frustum at depths 1.2-6 m, colors N(0, 1),
    logit opacity 0.5, the first `n_live` slots alive) and `n_kf` uniform
    random keyframe images."""
    rng = np.random.default_rng(0)
    z = rng.uniform(1.2, 6.0, cap).astype(np.float32)
    u = rng.uniform(0, width, cap).astype(np.float32)
    v = rng.uniform(0, height, cap).astype(np.float32)
    means = np.stack([(u - width / 2) * z / fx, (v - height / 2) * z / fx, z], -1)
    alive = np.zeros(cap, bool)
    alive[:n_live] = True
    fields = dict(
        means=means.astype(np.float32),
        quats=rng.normal(size=(cap, 4)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.002, 0.008, (cap, 3)) * z[:, None])
        .astype(np.float32),
        logit_opacities=np.full((cap,), 0.5, np.float32),
        logit_colors=rng.normal(size=(cap, 3)).astype(np.float32),
        log_uncertainties=np.zeros((cap,), np.float32),
        alive=alive,
    )
    images = [rng.random((height, width, 3)).astype(np.float32) for _ in range(n_kf)]
    return fields, images


def intrinsics(width=W, height=H, fx=FX):
    return np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32)


def keyframe_pose(slot, spacing=KF_SPACING):
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = spacing * slot
    return pose


def build_point(fields, images, width=W, height=H, fx=FX, kf_cap=KF_CAP, window=WINDOW,
                kf_spacing=KF_SPACING, render=None, device=None):
    """The point's state on `device`: (gmap, opt_state, kf, pose_opt, widx,
    wmask, K, cfg), keyframes in slots 0..len(images)-1, `kf_spacing` m
    apart in x, with zero exposure, the window of slots 2..window+1, and
    `render` (a RenderConfig; by default this point's) in the MapConfig."""
    import torch

    from gslam_tpu_torch import resolve_device
    from gslam_tpu_torch.mapping.backend_ops import MapConfig, init_pose_adam
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.mapping.keyframes import add_keyframe, empty_keyframes
    from gslam_tpu_torch.mapping.optimizer import init_adam
    from gslam_tpu_torch.ops.rasterize import RenderConfig

    dev = resolve_device(device)
    gmap = gaussian_map_from_numpy(fields, device=dev)
    if render is None:
        # 4 pairs per splat: a budget of 4M pairs a camera at 1M splats
        render = RenderConfig(tile_capacity=256, tile_chunk=60, pairs_per_gaussian=4)
    cfg = MapConfig(window_size=window, render=render)
    kf = empty_keyframes(kf_cap, height, width, device=dev)
    for slot, img in enumerate(images):
        kf = add_keyframe(kf, slot, img, keyframe_pose(slot, kf_spacing),
                          np.zeros(2, np.float32), slot)
    widx = torch.arange(window, device=dev) + 2
    wmask = torch.ones(window, dtype=torch.bool, device=dev)
    K = torch.from_numpy(intrinsics(width, height, fx)).to(dev)
    return (gmap, init_adam(gmap), kf, init_pose_adam(kf_cap, device=dev), widx, wmask, K,
            cfg)


def render_view(gmap, K, width, height, cfg, i=0):
    """bench_1m.py's single-view render, at the identity moved by i * 1e-6 m."""
    import torch

    from gslam_tpu_torch.ops.rasterize import render

    vm = torch.eye(4, device=K.device)
    vm[0, 3] += i * 1e-6
    return render(**gmap.render_kwargs(), viewmats=vm[None], Ks=K[None], width=width,
                  height=height, cfg=cfg.render, device=K.device)


class Clock:
    """Elapsed ms between `start()` and `stop()`: CUDA events on a card (the
    span of the work enqueued between them), the host clock on the CPU."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.torch = torch

    def start(self):
        if self.cuda:
            self.a = self.torch.cuda.Event(enable_timing=True)
            self.a.record()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            b = self.torch.cuda.Event(enable_timing=True)
            b.record()
            b.synchronize()
            return self.a.elapsed_time(b)
        return 1e3 * (time.perf_counter() - self.t0)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(point, width=W, height=H, iters=ITERS):
    """bench_1m.py's three measurements on `point` (build_point). Returns
    (detail, steps, state): detail holds bench_1m.py's keys and what this
    port adds (blend launches per call, peak memory); steps one record per
    mapping step (warm-up and timed) with its losses and pairs, read after
    the timed loop so that no step waits for the host; state the last
    step's [gmap, opt_state, kf, pose_opt]."""
    import torch

    from gslam_tpu_torch.mapping.backend_ops import mapping_step
    from gslam_tpu_torch.mapping.gaussians import compact_map
    from gslam_tpu_torch.ops import blend

    gmap, opt, kf, pose_opt, widx, wmask, K, cfg = point
    dev = K.device
    clock = Clock(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def launched(fn):
        before = dict(blend.launches)
        out = fn()
        return out, {k: blend.launches[k] - before[k] for k in before}

    # single-view render at 1M live splats
    out, render_launches = launched(lambda: render_view(gmap, K, width, height, cfg))
    clock.start()
    for i in range(RENDER_REPS):
        out = render_view(gmap, K, width, height, cfg, i)
    render_ms = clock.stop() / RENDER_REPS
    render_finite = bool(torch.isfinite(out.rgb).all())
    del out

    # in-place live-slot compaction at full capacity
    g2, o2 = compact_map(gmap, opt)
    clock.start()
    for _ in range(COMPACT_REPS):
        g2, o2 = compact_map(g2, o2)
    compact_ms = clock.stop() / COMPACT_REPS
    del g2, o2

    steps = []

    def step(st, warmup):
        g, o, k2, p, aux = mapping_step(*st, widx, wmask, K, width, height, cfg)
        steps.append(dict(warmup=warmup, total_loss=aux.total_loss,
                          photometric_loss=aux.photometric_loss, n_pairs=aux.n_pairs))
        return [g, o, k2, p]

    # adaptive warm-up, as bench_1m.py: until a step takes under 0.25 s
    st = [gmap, opt, kf, pose_opt]
    for _ in range(MAX_WARMUP):
        tw = time.perf_counter()
        st, step_launches = launched(lambda: step(st, True))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if time.perf_counter() - tw < 0.25:
            break
    clock.start()
    t0 = time.perf_counter()
    for _ in range(iters):
        st = step(st, False)
    device_ms = clock.stop() / iters
    map_ms = 1e3 * (time.perf_counter() - t0) / iters

    for s in steps:
        s.update(total_loss=float(s["total_loss"]), photometric_loss=float(s["photometric_loss"]),
                 max_n_pairs=int(s.pop("n_pairs").max()))
    on_card = dev.type == "cuda"
    detail = {
        "capacity": int(gmap.capacity),
        "n_live": int(gmap.n_live()),
        "render_ms": render_ms,
        "compact_ms": compact_ms,
        "mapping_iter_ms": map_ms,
        "mapping_passes_per_s": 1.0 / (iters * map_ms / 1e3),
        "device_mapping_iter_ms": device_ms if on_card else None,
        "device_mapping_passes_per_s": 1.0 / (iters * device_ms / 1e3) if on_card else None,
        "timer": "cuda_events" if on_card else "host_clock",
        "width": width, "height": height, "window": int(widx.shape[0]),
        "render_finite": render_finite,
        "blend_launches_per_render": render_launches,
        "blend_launches_per_step": step_launches,
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated()) if on_card
        else None,
    }
    return detail, steps, st


def result_line(detail, steps, width=W, height=H):
    """bench_1m.py's JSON object: the mapping step's ms as the value, the
    detail with each step's photometric loss and, on a card, its nvidia-smi
    name and power limit."""
    detail = dict(detail, photometric_loss=[s["photometric_loss"] for s in steps],
                  nvidia_smi=nvidia_smi() if detail["timer"] == "cuda_events" else None)
    return {"metric": f"1M-splat capacity: render + mapping on chip ({width}x{height})",
            "value": detail["mapping_iter_ms"], "unit": "ms/mapping-iter", "detail": detail}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises where there is none)")
    args = ap.parse_args(argv)

    from gslam_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    point = build_point(*point_arrays(), device=dev)
    detail, steps, _ = measure(point)
    result = result_line(detail, steps)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
