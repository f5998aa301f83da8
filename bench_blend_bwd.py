#!/usr/bin/env python3
"""blend_bwd built from an earlier blend.cu against the checkout's, in one call.

    python3 bench_blend_bwd.py --old path/to/old/blend.cu [--out result.json]

Builds `--old` (e.g. the parent commit's gslam_tpu_torch/csrc/blend.cu,
written out with `git show` into a git-ignored directory) and the checkout's
csrc/blend.cu with the package's nvcc flags and -Xptxas -v. Then, on
chip_smoke.py's real rows of BASELINE config 1 (T=300 x M=512 at 320x240;
T=80 at the 160x120 pyramid level), runs chip_smoke.py's compare_and_time in
turns old, new, new, old. Each turn holds that build's blend_bwd to the
float64 plain version and times it with chip_smoke.py's two timers (`ms`,
one launch between two CUDA events; `ms_back_to_back`). blend_fwd, the
checkout's in every turn, is timed beside it as a control. Also reports how
far the two builds' outputs differ and what ptxas says of each build. Prints
one JSON line per shape and the card's name and power limit; --out also
writes them to a file.
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


def launcher(lib: ctypes.CDLL):
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
                 T, M, ts, tiles_x, alpha_cut, alpha_clamp,
                 torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"blend_bwd launch failed: CUDA error {err}")
        return outs

    return bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path, help="the earlier blend.cu")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_blend_bwd.py needs a CUDA device", file=sys.stderr)
        return 2
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops import cuda_build
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    lines = [smi]
    bwd, ptxas = {}, {}
    for name, src in (("old", args.old), ("new", cuda_build.CSRC / "blend.cu")):
        lib, ptxas[name] = build(src, f"blend_{name}")
        bwd[name] = launcher(lib)

    rng = np.random.default_rng(0)
    gmap = gaussian_map_from_numpy(cs.make_map_fields(cs.N_SPLATS, cs.N_SPLATS, rng),
                                   device="cuda")
    K = torch.tensor([[cs.FX, 0, cs.W / 2], [0, cs.FX, cs.H / 2], [0, 0, 1]],
                     device="cuda")
    tcfg = TrackingConfig(render=RenderConfig(tile_capacity=512, pairs_per_gaussian=8))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, ts, tiles_x, cfg in cs.kernel_shapes(gmap, K, tcfg):
        T, _, M = rows[0].shape
        g = [torch.randn(T, ts * ts, 5, device="cuda", generator=gen) / (cs.W * cs.H),
             torch.randn(T, ts * ts, device="cuda", generator=gen) / (cs.W * cs.H)]
        outs = {k: b(*rows, *g, ts, tiles_x, cfg.alpha_cut, cfg.alpha_clamp)
                for k, b in bwd.items()}
        diff = max(cs._err(a, b) for a, b in zip(outs["new"], outs["old"]))
        bitwise = all(torch.equal(a, b) for a, b in zip(outs["new"], outs["old"]))
        del outs, g
        turns = {k: [] for k in bwd}
        for k in ("old", "new", "new", "old"):
            turns[k].append(cs.compare_and_time(rows, ts, tiles_x, cfg, gen, bwd=bwd[k]))
        res = turns["new"][0]
        line = dict(
            T=T, M=M, nvidia_smi=smi,
            blend_bwd={k: {f: [r["blend_bwd"][f] for r in v]
                           for f in ("ms", "ms_back_to_back", "err_over_limit")}
                       for k, v in turns.items()},
            blend_fwd_control={k: [r["blend_fwd"]["ms"] for r in v]
                               for k, v in turns.items()},
            bound_ms=res["blend_bwd"]["bound_ms"], bound_by=res["blend_bwd"]["bound_by"],
            new_vs_old_max_abs=diff, new_equals_old_bitwise=bitwise,
            cull_survival=res["blend_bwd"]["cull_survival"],
            live_share=res["blend_bwd"]["live_share"],
            new_resources=res["blend_bwd"]["resources"])
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
