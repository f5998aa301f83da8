#!/usr/bin/env python3
"""The blend kernel pair built from an earlier blend.cu against the
checkout's, in one call.

    python3 bench_blend.py --old path/to/old/blend.cu [--out result.json]

Builds `--old` (e.g. the parent commit's gslam_tpu_torch/csrc/blend.cu,
written out with `git show` into a git-ignored directory) and the checkout's
csrc/blend.cu with the package's nvcc flags and -Xptxas -v. Then, on
chip_smoke.py's real rows of BASELINE config 1 (T=300 x M=512 at 320x240;
T=80 at the 160x120 pyramid level), for each shape:
  - whether the two builds' outputs agree bit for bit: blend_bwd, and
    blend_fwd at one depth segment per tile (the new build's S=1) and at
    the card's rule for S;
  - chip_smoke.py's compare_and_time for each build in turns old, new, new,
    old: each build's blend_fwd and blend_bwd held to the float64 plain
    versions and timed with chip_smoke.py's two timers (`ms`, one launch
    between two CUDA events; `ms_back_to_back`);
  - the new blend_fwd at every segment count S a 256-pixel tile allows, in
    turns 1, 2, 3, 4, 4, 3, 2, 1, each held to float64 the same way;
  - both builds' resources (registers, shared memory, spills, resident
    blocks per SM) where the build can report them, and ptxas's report.
Prints one JSON line per shape and the card's name and power limit; --out
also writes them to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs


def build(src: Path, name: str) -> tuple[ctypes.CDLL, list]:
    """nvcc `src` with the package's flags and -Xptxas -v; returns the loaded
    library and ptxas's report (registers, stack and spills per kernel)."""
    from gslam_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-Xptxas", "-v", "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    cs.check(proc.returncode == 0, f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib)), [ln.strip() for ln in proc.stderr.splitlines()
                                   if ln.strip()]


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def fwd_launcher(lib: ctypes.CDLL, segments=None):
    """A function with blend_fwd_cuda's arguments and outputs that launches
    `lib`'s blend_fwd (or, with `segments`, its blend_fwd_split)."""
    import torch

    fn = lib.blend_fwd if segments is None else lib.blend_fwd_split
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * (segments is not None) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    extra = () if segments is None else (segments,)

    def fwd(xy, con, op, feat, ts, tiles_x, alpha_cut, alpha_clamp, min_t):
        T, _, M = xy.shape
        out = torch.empty((T, ts * ts, 5), dtype=torch.float32, device=xy.device)
        tf = torch.empty((T, ts * ts), dtype=torch.float32, device=xy.device)
        touched = torch.empty((T, M), dtype=torch.int32, device=xy.device)
        err = fn(*[x.data_ptr() for x in (xy, con, op, feat, out, tf, touched)],
                 T, M, ts, tiles_x, alpha_cut, alpha_clamp, min_t, *extra, _stream())
        cs.check(err == 0, f"blend_fwd launch failed: CUDA error {err}")
        return out, tf, touched

    return fwd


def bwd_launcher(lib: ctypes.CDLL):
    """A function with blend_bwd_cuda's arguments and outputs that launches
    `lib`'s blend_bwd through csrc/blend.cu's C interface."""
    import torch

    fn = lib.blend_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def bwd(xy, con, op, feat, g_out, g_tf, ts, tiles_x, alpha_cut, alpha_clamp):
        T, _, M = xy.shape
        outs = [torch.empty((T, k, M), dtype=torch.float32, device=xy.device)
                for k in (2, 3, 1, 5)]
        err = fn(*[x.data_ptr() for x in (xy, con, op, feat, g_out, g_tf, *outs)],
                 T, M, ts, tiles_x, alpha_cut, alpha_clamp, _stream())
        cs.check(err == 0, f"blend_bwd launch failed: CUDA error {err}")
        return outs

    return bwd


def build_resources(lib, name, M, ts, S=1):
    """`lib`'s resources for kernel `name`, or None where the build has no
    query for it (builds before blend_resources had blend_bwd_resources)."""
    if hasattr(lib, "blend_resources"):
        return cs.resources(name, M, ts, S, lib=lib)
    if name != "blend_bwd" or not hasattr(lib, "blend_bwd_resources"):
        return None
    fn = lib.blend_bwd_resources
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    cs.check(fn(M, ts, out) == 0, "blend_bwd_resources failed")
    return dict(regs_per_thread=out[0], smem_bytes_per_block=out[1],
                local_bytes_per_thread=out[2], blocks_per_sm=out[3])


def _same(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path, help="the earlier blend.cu")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_blend.py needs a CUDA device", file=sys.stderr)
        return 2
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops import blend, cuda_build
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    lines = [smi]
    libs, ptxas = {}, {}
    for name, src in (("old", args.old), ("new", cuda_build.CSRC / "blend.cu")):
        libs[name], ptxas[name] = build(src, f"blend_{name}")
    fwd = {k: fwd_launcher(lib) for k, lib in libs.items()}
    bwd = {k: bwd_launcher(lib) for k, lib in libs.items()}
    n_seg = 1024 // 256
    fwd_s = {S: fwd_launcher(libs["new"], S) for S in range(1, n_seg + 1)}

    rng = np.random.default_rng(0)
    gmap = gaussian_map_from_numpy(cs.make_map_fields(cs.N_SPLATS, cs.N_SPLATS, rng),
                                   device="cuda")
    K = torch.tensor([[cs.FX, 0, cs.W / 2], [0, cs.FX, cs.H / 2], [0, 0, 1]],
                     device="cuda")
    tcfg = TrackingConfig(render=RenderConfig(tile_capacity=512, pairs_per_gaussian=8))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, ts, tiles_x, cfg in cs.kernel_shapes(gmap, K, tcfg):
        T, _, M = rows[0].shape
        cs.check(ts * ts == 256, f"the sweep assumes 256-pixel tiles, got ts={ts}")
        S_rule = blend.fwd_segments(T, M, ts)
        fargs = (*rows, ts, tiles_x, cfg.alpha_cut, cfg.alpha_clamp, cfg.visibility_min_T)
        g = [torch.randn(T, ts * ts, 5, device="cuda", generator=gen) / (cs.W * cs.H),
             torch.randn(T, ts * ts, device="cuda", generator=gen) / (cs.W * cs.H)]
        bargs = (*rows, *g, ts, tiles_x, cfg.alpha_cut, cfg.alpha_clamp)
        f_old, f_new, f_s1 = fwd["old"](*fargs), fwd["new"](*fargs), fwd_s[1](*fargs)
        b_old, b_new = bwd["old"](*bargs), bwd["new"](*bargs)
        torch.cuda.synchronize()
        bits = dict(
            blend_fwd_s1_equals_old_bitwise=_same(f_s1, f_old),
            blend_fwd_equals_old_bitwise=_same(f_new, f_old),
            blend_fwd_vs_old_max_abs=max(cs._err(a, b) for a, b in zip(f_new[:2], f_old[:2])),
            blend_fwd_touched_slots_differing=int((f_new[2] != f_old[2]).sum().item()),
            blend_bwd_equals_old_bitwise=_same(b_new, b_old),
            blend_bwd_vs_old_max_abs=max(cs._err(a, b) for a, b in zip(b_new, b_old)))
        del f_old, f_new, f_s1, b_old, b_new, g

        turns = {k: [] for k in libs}
        for k in ("old", "new", "new", "old"):
            turns[k].append(cs.compare_and_time(rows, ts, tiles_x, cfg, gen, fwd=fwd[k],
                                                bwd=bwd[k]))
        sweep = {S: [] for S in fwd_s}
        for S in [*fwd_s, *reversed(fwd_s)]:
            r = cs.compare_and_time(rows, ts, tiles_x, cfg, gen, fwd=fwd_s[S])
            sweep[S].append(r["blend_fwd"])
        res = turns["new"][0]
        fields = ("ms", "ms_back_to_back", "err_over_limit")
        line = dict(
            T=T, M=M, nvidia_smi=smi, fwd_segments_rule=S_rule, **bits,
            **{name: {k: {f: [r[name][f] for r in v] for f in fields}
                      for k, v in turns.items()} for name in ("blend_fwd", "blend_bwd")},
            blend_fwd_by_segments={S: {f: [r[f] for r in v] for f in fields}
                                   for S, v in sweep.items()},
            bound_ms={n: res[n]["bound_ms"] for n in ("blend_fwd", "blend_bwd")},
            bound_by={n: res[n]["bound_by"] for n in ("blend_fwd", "blend_bwd")},
            cull_survival={n: res[n]["cull_survival"] for n in ("blend_fwd", "blend_bwd")},
            live_share={n: res[n]["live_share"] for n in ("blend_fwd", "blend_bwd")},
            resources={k: dict(blend_fwd=build_resources(lib, "blend_fwd", M, ts, S_rule),
                               blend_fwd_s1=build_resources(lib, "blend_fwd", M, ts, 1),
                               blend_bwd=build_resources(lib, "blend_bwd", M, ts))
                       for k, lib in libs.items()})
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
    lines.append(json.dumps({"ptxas": ptxas}))
    print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
