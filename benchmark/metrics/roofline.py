"""The yardstick of the kernel and whole-step shares: the card's peaks and
the frozen counts of operations and bytes.

The blend counts are chip_smoke.py's (chip_smoke.py:179-190), frozen here:
16 operations per (pixel, splat) pair and 16 more per pair that passes the
alpha test forward, 32 and 50 backward (one per add, multiply, compare,
select or transcendental, counted from csrc/blend.cu), and bytes of every
input read once and every output written once. The pairs are counted from
the benchmark's own binning of the inputs (reference/splats.py), listed
entries only, so a share reads the same work whatever implements it. The
projection count is an estimate per splat per pass, from the operations of
the EWA projection (camera point, covariance, Jacobian, conic, radius).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores, HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

FWD_OPS_PAIR, FWD_OPS_OK = 16, 16
BWD_OPS_PAIR, BWD_OPS_OK = 32, 50
PROJ_OPS_FWD, PROJ_OPS_BWD = 250, 500  # per projected splat

ROW_FLOATS = 11  # xy 2, conic 3, opacity 1, rgb 3, depth 1, beta 1
OUT_FLOATS = 5  # rgb 3, depth 1, beta 1


def blend_fwd_work(tiles: int, capacity: int, pixels: int, pairs: int, ok_pairs: int):
    """(operations, bytes) of one forward blend over `tiles` rows of
    `capacity` slots: rows in; out, t_final and n_touched out."""
    ops = FWD_OPS_PAIR * pairs + FWD_OPS_OK * ok_pairs
    nbytes = 4 * (tiles * capacity * ROW_FLOATS + tiles * pixels * (OUT_FLOATS + 1)
                  + tiles * capacity)
    return ops, nbytes


def blend_bwd_work(tiles: int, capacity: int, pixels: int, pairs: int, ok_pairs: int):
    """(operations, bytes) of one backward blend: rows, output and
    t_final cotangents in; the rows' cotangents out."""
    ops = BWD_OPS_PAIR * pairs + BWD_OPS_OK * ok_pairs
    nbytes = 4 * (2 * tiles * capacity * ROW_FLOATS + tiles * pixels * (OUT_FLOATS + 1))
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operation and
    the byte bound."""
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def share_pct(calls: list, kernel_s: float):
    """A kernel's share of its roofline in percent: the summed bounds of
    its calls [(ops, bytes)] over its device seconds in the trace; None
    where the trace holds no such kernel or there were no calls."""
    if not calls or kernel_s <= 0:
        return None
    return 100.0 * sum(bound_s(o, b) for o, b in calls) / kernel_s


def mfu_pct(ops: float, wall_s: float):
    """Operations over the traced wall time, as a share of the float32 peak."""
    if ops <= 0 or wall_s <= 0:
        return None
    return 100.0 * ops / (wall_s * PEAK_F32_OPS)
