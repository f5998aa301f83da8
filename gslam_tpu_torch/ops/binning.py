"""Tile binning for the rasterizer: plain torch ops, and CUDA kernels.

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

`bin_gaussians` bins one camera in plain torch ops: an [N, max_span^2]
pair grid, boolean selects (a host sync each) and a 64-bit torch.sort.
`bin_cameras` bins C cameras: camera by camera through `bin_gaussians` for
CPU tensors, and for CUDA tensors in one pass through the kernels of
csrc/binning.cu (count, scan, emit, one stable radix sort, tile lists), which
give the same lists bit for bit with no host sync and no [N, K] tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gslam_tpu_torch.ops import cuda_build
from gslam_tpu_torch.runtime import trace

# Launches of each entry point in this process (the wrapper adds one per call;
# cub's scan and sort launch several kernels a call).
launches = {"bin_count": 0, "bin_scan": 0, "bin_emit": 0, "bin_sort": 0,
            "bin_tile_lists": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


# ---------------------------------------------------------------- CUDA kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_Z = ctypes.c_size_t
_SIGNATURES = {
    "bin_temp_bytes": [_I, _I, _I, ctypes.POINTER(_Z)],
    "bin_count": [_P] * 5 + [_L] + [_I] * 4 + [_P],
    "bin_scan": [_P, _P, _I, _P, _Z, _P],
    "bin_emit": [_P] * 5 + [_I, _I, _L, _I, _I, _P],
    "bin_sort": [_P] * 4 + [_I, _I, _P, _Z, ctypes.POINTER(_I), _P],
    "bin_tile_lists": [_P] * 7 + [_I, _I, _L, _I, _I, _P],
}


def _call(fn_name: str, *args):
    """Call csrc/binning.cu's entry point fn_name; raise on a CUDA error.
    Each call of an entry point in `launches` counts one launch."""
    fn = cuda_build.function("binning", fn_name, _SIGNATURES[fn_name])
    cuda_build.check(fn(*args), fn_name)
    if fn_name in launches:
        launches[fn_name] += 1


def _bin_cameras_cuda(means2d, radii, depths, valid, tile_size, tiles_x, tiles_y,
                      max_pairs, capacity, max_span) -> TileBins:
    C, N = valid.shape
    dev = means2d.device
    T = tiles_x * tiles_y
    n = C * max_pairs
    if N == 0 or max_pairs < 1:
        raise ValueError(f"binning needs splats and pair slots, got N={N}, "
                         f"max_pairs={max_pairs}")
    if max(n, C * N) >= 2**31:
        raise ValueError(f"{C} cameras of {N} splats and {max_pairs} pair slots: the "
                         "scan and the sort take fewer than 2^31 items")
    for name, x in (("means2d", means2d), ("radii", radii), ("depths", depths)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected torch.float32")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid has dtype {valid.dtype}, expected torch.bool")
    means2d, radii, depths, valid = (x.contiguous() for x in (means2d, radii, depths, valid))

    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    geom = torch.empty((C, N, 4), **i32)
    counts = torch.empty((C, N), **i64)
    incl = torch.empty((C, N), **i64)  # inclusive sums over all C N counts
    keys = torch.empty((2, n), **i64)  # uint64 bits
    vals = torch.empty((2, n), **i32)
    tile_gauss = torch.empty((C, T, capacity), **i32)
    tile_mask = torch.empty((C, T, capacity), dtype=torch.bool, device=dev)
    tile_counts = torch.empty((C, T), **i32)
    n_pairs = torch.empty((C,), **i32)
    # the key's bits: 32 of depth under the camera-and-tile index c (T + 1) + tile
    end_bit = 32 + (C * (T + 1) - 1).bit_length()
    temp_bytes, selector = _Z(0), _I(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the C interface works on the current card: make it the tensors'
    with torch.cuda.device(dev):
        _call("bin_temp_bytes", C * N, n, end_bit, ctypes.byref(temp_bytes))
        temp = torch.empty((max(temp_bytes.value, 1),), dtype=torch.uint8, device=dev)
        _call("bin_count", means2d.data_ptr(), radii.data_ptr(), valid.data_ptr(),
              geom.data_ptr(), counts.data_ptr(), C * N, tile_size, tiles_x, tiles_y,
              max_span, stream)
        _call("bin_scan", counts.data_ptr(), incl.data_ptr(), C * N, temp.data_ptr(),
              temp_bytes, stream)
        _call("bin_emit", incl.data_ptr(), geom.data_ptr(), depths.data_ptr(),
              keys[0].data_ptr(), vals[0].data_ptr(), C, N, max_pairs, T, tiles_x, stream)
        _call("bin_sort", keys[0].data_ptr(), keys[1].data_ptr(), vals[0].data_ptr(),
              vals[1].data_ptr(), n, end_bit, temp.data_ptr(), temp_bytes,
              ctypes.byref(selector), stream)
        k = selector.value  # the buffers that hold the sorted pairs
        _call("bin_tile_lists", keys[k].data_ptr(), vals[k].data_ptr(), incl.data_ptr(),
              tile_gauss.data_ptr(), tile_mask.data_ptr(), tile_counts.data_ptr(),
              n_pairs.data_ptr(), C, N, max_pairs, T, capacity, stream)

    if trace.enabled():
        ends = incl[:, -1]
        wanted = torch.diff(ends, prepend=torch.zeros_like(ends[:1]))
        over = torch.clamp(tile_counts.to(torch.int64) - capacity, min=0)
        trace.count("pairs.wanted", wanted.sum())
        trace.count("pairs.over_budget", torch.clamp(wanted - max_pairs, min=0).sum())
        trace.count("pairs.over_capacity", over.sum())
        trace.count("tiles.over_capacity", (over > 0).sum())
    return TileBins(tile_gauss=tile_gauss, tile_mask=tile_mask, tile_counts=tile_counts,
                    n_pairs=n_pairs)


# ---------------------------------------------------------------- dispatch


def bin_cameras(
    means2d: torch.Tensor,  # [C, N, 2]
    radii: torch.Tensor,  # [C, N] (0 = culled)
    depths: torch.Tensor,  # [C, N]
    valid: torch.Tensor,  # [C, N] bool
    tile_size: int,
    tiles_x: int,
    tiles_y: int,
    max_pairs: int,  # pair budget of each camera
    capacity: int,
    max_span: int = 16,
) -> TileBins:
    """`bin_gaussians` for each of C cameras: every field gains a leading [C]
    axis. CPU tensors go through `bin_gaussians` camera by camera; CUDA
    tensors through the kernels, which give the same lists, bit for bit, and
    the same counter totals."""
    args = (tile_size, tiles_x, tiles_y, max_pairs, capacity, max_span)
    if means2d.device.type == "cpu":
        per_camera = [bin_gaussians(means2d[c], radii[c], depths[c], valid[c], *args)
                      for c in range(means2d.shape[0])]
        return TileBins(*(torch.stack(x) for x in zip(*per_camera)))
    if means2d.device.type == "cuda":
        return _bin_cameras_cuda(means2d, radii, depths, valid, *args)
    raise ValueError(f"binning: unsupported device {means2d.device}")
