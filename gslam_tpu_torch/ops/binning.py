"""Tile binning for the rasterizer, in plain torch ops.

Counterpart of gslam_tpu/ops/binning.py, with the same static semantics:

  1. each projected splat covers a tile rectangle, clamped to a
     `max_span x max_span` window centered on the splat;
  2. pair slots come from an exclusive cumsum of per-splat tile counts;
     a pair whose slot is >= `max_pairs` (an invalid pair, or overflow of
     the pair budget) is dropped, as the JAX scatter's mode="drop" does;
  3. pairs are ordered by (tile, depth) with one int64 key
     `tile << 32 | ordered_bits(depth)` and a stable sort (torch has no
     multi-key sort);
  4. each tile keeps its first `capacity` (nearest) splats.

While a profiler records (runtime/trace.py), four counters say what the
truncations drop, on the device: `pairs.wanted` (pairs requested),
`pairs.over_budget` (beyond `max_pairs`), `pairs.over_capacity` (beyond a
tile's `capacity`) and `tiles.over_capacity` (tiles holding more pairs than
`capacity`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gslam_tpu_torch.runtime import trace


class TileBins(NamedTuple):
    tile_gauss: torch.Tensor  # [T, capacity] int32 splat ids, front-to-back
    tile_mask: torch.Tensor  # [T, capacity] bool validity
    tile_counts: torch.Tensor  # [T] int32 splats per tile (pre-truncation)
    n_pairs: torch.Tensor  # [] int32 pairs requested (monitor vs budget)


def _ordered_float_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) whose integer order is the float order."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    u = bits & 0xFFFFFFFF
    return torch.where(bits < 0, 0xFFFFFFFF - u, u + 0x80000000)


def bin_gaussians(
    means2d: torch.Tensor,  # [N, 2]
    radii: torch.Tensor,  # [N] (0 = culled)
    depths: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N] bool
    tile_size: int,
    tiles_x: int,
    tiles_y: int,
    max_pairs: int,
    capacity: int,
    max_span: int = 16,
) -> TileBins:
    dev = means2d.device
    num_tiles = tiles_x * tiles_y
    x, y, r = means2d[:, 0], means2d[:, 1], radii

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / tile_size), 0, hi - 1).to(torch.int32)

    tx0, tx1 = tile_of(x - r, tiles_x), tile_of(x + r, tiles_x)
    ty0, ty1 = tile_of(y - r, tiles_y), tile_of(y + r, tiles_y)

    # clamp oversized footprints to a max_span window centered on the splat
    tcx, tcy = tile_of(x, tiles_x), tile_of(y, tiles_y)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    big_x = span_x > max_span
    big_y = span_y > max_span
    tx0 = torch.where(
        big_x, torch.clamp(tcx - max_span // 2, 0, tiles_x - max_span), tx0)
    ty0 = torch.where(
        big_y, torch.clamp(tcy - max_span // 2, 0, tiles_y - max_span), ty0)
    span_x = torch.where(big_x, max_span, span_x)
    span_y = torch.where(big_y, max_span, span_y)

    counts = torch.where(valid, span_x * span_y, 0).to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts  # exclusive
    wanted = torch.sum(counts)
    n_pairs = wanted.to(torch.int32)

    # a fixed local grid per splat, as wide as a footprint can be: max_span,
    # or the image's tile count where that is smaller (span_x <= tiles_x);
    # the compact pair index j = dy * span_x + dx packs each splat's pairs
    # at offsets[i]
    gx, gy = min(max_span, tiles_x), min(max_span, tiles_y)
    k = torch.arange(gx * gy, device=dev)
    dy = (k // gx)[None, :]
    dx = (k % gx)[None, :]
    pair_ok = (dx < span_x[:, None]) & (dy < span_y[:, None]) & valid[:, None]
    idx = offsets[:, None] + dy * span_x[:, None] + dx  # [N, K] int64
    tile = (ty0[:, None] + dy) * tiles_x + (tx0[:, None] + dx)
    # mode="drop": invalid pairs and pairs beyond the budget are discarded
    keep = pair_ok & (idx < max_pairs)
    slots = idx[keep]

    pair_tile = torch.full((max_pairs,), num_tiles, dtype=torch.int64, device=dev)
    pair_depth = torch.full((max_pairs,), float("inf"), dtype=torch.float32,
                            device=dev)
    pair_id = torch.zeros((max_pairs,), dtype=torch.int32, device=dev)
    pair_tile[slots] = tile.expand(keep.shape)[keep].to(torch.int64)
    pair_depth[slots] = depths[:, None].expand(keep.shape)[keep].to(torch.float32)
    gid = torch.arange(means2d.shape[0], dtype=torch.int32, device=dev)
    pair_id[slots] = gid[:, None].expand(keep.shape)[keep]

    key = (pair_tile << 32) | _ordered_float_bits(pair_depth)
    order = torch.sort(key, stable=True).indices
    sorted_tile = pair_tile[order]
    sorted_id = pair_id[order]

    tile_range = torch.arange(num_tiles, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_tile, tile_range, side="left")
    ends = torch.searchsorted(sorted_tile, tile_range, side="right")
    tile_counts = ends - starts

    if trace.enabled():
        over = torch.clamp(tile_counts - capacity, min=0)
        trace.count("pairs.wanted", wanted)
        trace.count("pairs.over_budget", torch.clamp(wanted - max_pairs, min=0))
        trace.count("pairs.over_capacity", torch.sum(over))
        trace.count("tiles.over_capacity", torch.sum(over > 0))

    slot = torch.arange(capacity, device=dev)[None, :]
    tile_mask = slot < tile_counts[:, None]
    gather_idx = torch.where(tile_mask, starts[:, None] + slot, 0)
    return TileBins(
        tile_gauss=sorted_id[gather_idx],
        tile_mask=tile_mask,
        tile_counts=tile_counts.to(torch.int32),
        n_pairs=n_pairs,
    )
