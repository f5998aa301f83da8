#!/usr/bin/env python3
"""Binning of C cameras in plain torch ops with no host sync, and a run of a
benchmark cell with it in place of the binning kernels.

    python3 bench_binning.py --binning torch|kernels --workload <cell> --seed <n> \\
        --seconds <s> [--trace 0|1]

`bin_cameras_torch` is the algorithm of gslam_tpu_torch/csrc/binning.cu in
torch ops, one fixed-size pass over C cameras: each splat's tile rectangle
and pair count (`count_torch`, the plain `bin_gaussians`'s arithmetic over
[C, N]), an inclusive cumsum of the counts along N, the C x max_pairs slots
(`emit_torch`: each slot's splat by torch.searchsorted over its camera's
offsets, its key `(c (T + 1) + tile) << 32 | ordered(depth)` and id, the
sentinel after the camera's pairs), one stable 64-bit torch.sort
(`sort_torch`) and the tile ranges by searchsorted and the gather of the lists
(`lists_torch`). It has no [N, max_span^2] tensor and no boolean select, so
no host sync, and gives the kernels' lists bit for bit; it counts none of
the pair counters. chip_smoke.py times each stage as the plain version of
the kernel that does it.

The command runs benchmark/run.py's cell once in this process (the same
arguments, the same result line), with `--binning torch` making every
`_bin_cameras` call go through `bin_cameras_torch` on the card; `kernels`
leaves the program as it is, for a comparison in one call.
"""

from __future__ import annotations

import argparse
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def count_torch(means2d, radii, valid, tile_size, tiles_x, tiles_y, max_span):
    """[C, N] splats -> (tx0, ty0, span_x, span_y, counts int64), operation for
    operation as `bin_gaussians` computes them."""
    import torch

    x, y, r = means2d[..., 0], means2d[..., 1], radii

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / tile_size), 0, hi - 1).to(torch.int32)

    tx0, tx1 = tile_of(x - r, tiles_x), tile_of(x + r, tiles_x)
    ty0, ty1 = tile_of(y - r, tiles_y), tile_of(y + r, tiles_y)
    tcx, tcy = tile_of(x, tiles_x), tile_of(y, tiles_y)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    big_x = span_x > max_span
    big_y = span_y > max_span
    tx0 = torch.where(big_x, torch.clamp(tcx - max_span // 2, 0, tiles_x - max_span), tx0)
    ty0 = torch.where(big_y, torch.clamp(tcy - max_span // 2, 0, tiles_y - max_span), ty0)
    span_x = torch.where(big_x, max_span, span_x)
    span_y = torch.where(big_y, max_span, span_y)
    counts = torch.where(valid, span_x * span_y, 0).to(torch.int64)
    return tx0, ty0, span_x, span_y, counts


def emit_torch(incl, counts, tx0, ty0, span_x, span_y, depths, max_pairs, num_tiles,
               tiles_x):
    """The [C, max_pairs] slots' keys (int64) and ids (int32) from the
    inclusive offsets incl [C, N]: slot s < min(wanted, max_pairs) holds pair
    j = s - excl[i] of splat i, every later slot the sentinel (tile T, +inf,
    id 0)."""
    import torch

    from gslam_tpu_torch.ops.binning import _ordered_float_bits

    C, N = incl.shape
    dev = incl.device
    s = torch.arange(max_pairs, device=dev).expand(C, max_pairs).contiguous()
    live = s < incl[:, -1:]
    i = torch.clamp(torch.searchsorted(incl, s, right=True), max=N - 1)
    j = s - (incl.gather(1, i) - counts.gather(1, i))
    sx = torch.clamp(span_x.gather(1, i), min=1).to(torch.int64)  # a dead slot may read 0
    tile = ((ty0.gather(1, i) + j // sx) * tiles_x + tx0.gather(1, i) + j % sx)
    cam = torch.arange(C, device=dev)[:, None] * (num_tiles + 1)
    tile_key = cam + torch.where(live, tile, num_tiles)
    depth = torch.where(live, depths.gather(1, i), float("inf"))
    key = (tile_key << 32) | _ordered_float_bits(depth)
    return key, torch.where(live, i, 0).to(torch.int32)


def sort_torch(key, vals):
    """One stable sort of the C max_pairs pairs by key."""
    import torch

    order = torch.sort(key.reshape(-1), stable=True).indices
    return key.reshape(-1)[order], vals.reshape(-1)[order]


def lists_torch(sorted_key, sorted_vals, wanted, C, max_pairs, num_tiles, capacity):
    """Each (camera, tile)'s range in the sorted pairs, its first `capacity`
    ids (slots past the count take the camera's first sorted id, as the
    plain gather of index 0 does), mask and count, and the wanted pairs."""
    import torch

    from gslam_tpu_torch.ops.binning import TileBins

    dev = sorted_key.device
    want = (torch.arange(C, device=dev)[:, None] * (num_tiles + 1)
            + torch.arange(num_tiles + 1, device=dev)[None, :])
    bounds = torch.searchsorted(sorted_key >> 32, want)  # [C, T + 1]
    starts = bounds[:, :-1]
    tile_counts = bounds[:, 1:] - starts
    slot = torch.arange(capacity, device=dev)
    tile_mask = slot < tile_counts[..., None]
    first = torch.arange(C, device=dev)[:, None, None] * max_pairs
    gather_idx = torch.where(tile_mask, starts[..., None] + slot, first)
    return TileBins(tile_gauss=sorted_vals[gather_idx], tile_mask=tile_mask,
                    tile_counts=tile_counts.to(torch.int32),
                    n_pairs=wanted.to(torch.int32))


def bin_cameras_torch(means2d, radii, depths, valid, tile_size, tiles_x, tiles_y,
                      max_pairs, capacity, max_span=16):
    """`ops.binning.bin_cameras`'s result for [C, N] inputs, in torch ops."""
    import torch

    C = valid.shape[0]
    T = tiles_x * tiles_y
    tx0, ty0, span_x, span_y, counts = count_torch(means2d, radii, valid, tile_size,
                                                   tiles_x, tiles_y, max_span)
    incl = torch.cumsum(counts, 1)
    key, vals = emit_torch(incl, counts, tx0, ty0, span_x, span_y, depths, max_pairs, T,
                           tiles_x)
    sorted_key, sorted_vals = sort_torch(key, vals)
    return lists_torch(sorted_key, sorted_vals, incl[:, -1], C, max_pairs, T, capacity)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--binning", choices=("torch", "kernels"), required=True)
    args, rest = ap.parse_known_args(argv)
    sys.path.insert(0, str(ROOT))
    from gslam_tpu_torch.ops import rasterize

    if args.binning == "torch":
        rasterize.bin_cameras = bin_cameras_torch
    sys.argv = [str(ROOT / "benchmark" / "run.py"), *rest]
    runpy.run_path(sys.argv[0], run_name="__main__")  # exits with the harness's code
    return 0


if __name__ == "__main__":
    sys.exit(main())
