"""The percentile and per-window arithmetic, the roofline and
step-share counts against hand counts, and the trace reduction on a
synthetic event list."""

import math
from types import SimpleNamespace

import pytest

from benchmark import manifest, stats
from benchmark.metrics import roofline
from benchmark.metrics.trace_summary import Event, kernel_seconds, summarize


def test_percentile_interpolates_like_numpy():
    xs = list(range(1, 21))
    assert stats.percentile(xs, 95) == pytest.approx(19.05)
    assert stats.percentile(xs, 50) == pytest.approx(10.5)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 100) == 5


def _reader(name):
    cell = manifest.Cell(manifest.load(), "qvga50k-track-igs")
    return cell.reader(name)


def test_window_readers():
    ctx = SimpleNamespace(window={"setup_s": 12.5, "window_s": 10.0, "units": 4,
                                  "unit_s": [2.0, 2.5, 2.5, 3.0], "peak_bytes": 3 * 2**30},
                          counters={"evals": [211, 211, 200, 190]}, trace=None, work={})
    assert _reader("setup_s")(ctx) == 12.5
    assert _reader("track_ms")(ctx) == 2500.0
    assert _reader("map_step_ms")(ctx) == 2500.0
    assert _reader("track_p95_ms")(ctx) == pytest.approx(1e3 * (2.5 + 0.85 * 0.5))
    assert _reader("peak_mem_gib")(ctx) == 3.0
    assert _reader("track_evals_per_frame")(ctx) == pytest.approx(203.0)
    for name in ("mfu.track", "device_idle.track", "blend_fwd_roofline.track",
                 "launches_per_eval.track"):
        assert _reader(name)(ctx) is None  # nothing traced, nothing read


def test_blend_counts_by_hand():
    # one tile of 2x2 pixels, 2 slots: 8 pairs, 5 passing the alpha test
    ops, nbytes = roofline.blend_fwd_work(tiles=1, capacity=2, pixels=4, pairs=8, ok_pairs=5)
    assert ops == 16 * 8 + 16 * 5
    assert nbytes == 4 * (1 * 2 * 11 + 1 * 4 * 6 + 1 * 2)
    ops, nbytes = roofline.blend_bwd_work(tiles=1, capacity=2, pixels=4, pairs=8, ok_pairs=5)
    assert ops == 32 * 8 + 50 * 5
    assert nbytes == 4 * (2 * 1 * 2 * 11 + 1 * 4 * 6)
    # operation-bound: 208 ops / 67e12 against 192 B / 3.35e12
    assert roofline.bound_s(208, 192) == pytest.approx(max(208 / 67e12, 192 / 3.35e12))
    calls = [(208, 192)] * 3
    assert roofline.share_pct(calls, 3 * roofline.bound_s(208, 192) * 4) == pytest.approx(25.0)
    assert roofline.share_pct([], 1.0) is None and roofline.share_pct(calls, 0.0) is None
    assert roofline.mfu_pct(67e12 * 0.5, 1.0) == pytest.approx(50.0)


def test_reference_counts_a_tiny_tile_list():
    """The pairs and alpha-test passes the reference counts, by hand: a 2x2
    tile, one sharp splat at pixel (0, 0) and one wide one over the tile."""
    torch = pytest.importorskip("torch")
    from benchmark.reference import splats

    spec = splats.RenderSpec(tile_size=2, tile_capacity=2)
    xy = torch.tensor([[[0.0, 0.0], [0.5, 0.5]]])
    con = torch.tensor([[[100.0, 0.0, 100.0], [0.1, 0.0, 0.1]]])
    op = torch.tensor([[0.9, 0.5]])
    feat = torch.ones((1, 2, 5))
    out, t_final, ok = splats._composite(xy, con, op, feat, 0, 1, spec)
    assert ok == 1 + 4  # the sharp splat passes at its own pixel only
    a0 = 0.9
    a1 = 0.5 * math.exp(-0.5 * 0.1 * 0.5)  # every pixel is 0.5 px from the wide splat
    assert float(t_final[0, 0]) == pytest.approx((1 - a0) * (1 - a1), rel=1e-6)
    assert float(out[0, 0, 0]) == pytest.approx(a0 + (1 - a0) * a1, rel=1e-6)


def test_trace_summary_on_synthetic_events():
    ms = 1_000_000
    events = [
        Event("step", 0, 100 * ms, False, False),  # host range, outermost
        Event("aten::mul", 5 * ms, 10 * ms, False, False),
        Event("aten::sort", 40 * ms, 30 * ms, False, False),
        Event("binning", 40 * ms, 30 * ms, False, False),
        Event("blend_fwd_kernel(float const*)", 10 * ms, 10 * ms, True, False),
        Event("elementwise_kernel", 15 * ms, 10 * ms, True, False),  # overlaps: union
        Event("blend_fwd_kernel(float const*)", 50 * ms, 5 * ms, True, False),
        Event("binning", 40 * ms, 30 * ms, True, True),  # the range's device annotation
        Event("binning", 45 * ms, 10 * ms, True, True),  # nested in one of its name: once
        Event("track_level", 0, 100 * ms, True, True),  # a range not asked for
        Event("cudaLaunchKernel", 80 * ms, 1 * ms, False, False),
        Event("blend_bwd_kernel", 90 * ms, 10 * ms, True, False),
    ]
    s = summarize(events, wall_s=0.1, ranges=("binning",))
    assert s["kernels"] == 4
    assert s["busy_s"] == pytest.approx(0.015 + 0.005 + 0.010)
    assert s["idle_share"] == pytest.approx(1 - 0.030 / 0.1)
    assert kernel_seconds(s, "blend_fwd_kernel") == pytest.approx(0.015)
    assert s["device_range_s"] == {"binning": pytest.approx(0.030)}
    # gaps: 25-50 ms (mid 37.5: inside "step" only), 55-90 ms (mid 72.5: "step";
    # aten::sort ended at 70)
    assert dict(s["idle_gaps"]) == {"step": pytest.approx(0.060)}
    assert s["device_ops"][0][0].startswith("blend_fwd_kernel")


def test_binning_reads_the_device_side_and_fails_without_it():
    read = manifest.Cell(manifest.load(), "vga1m-map").reader("binning_ms.map")
    assert read(SimpleNamespace(trace={"device_range_s": {"binning": 0.6}},
                                work={"units": 3})) == pytest.approx(200.0)
    assert read(SimpleNamespace(trace=None, work={})) is None  # nothing traced
    with pytest.raises(RuntimeError, match="binning"):
        read(SimpleNamespace(trace={"device_range_s": {}}, work={"units": 3}))
