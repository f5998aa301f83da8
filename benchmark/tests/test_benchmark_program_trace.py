"""The per-layer metrics that read the program's own recorder
(metrics/program_trace.py and the readers beside it): each on a synthetic
session with its divisor, on a traced run without a session (an error),
on a program without the recorder and on an untraced run (nothing to
read), and on the session a cut-size frame of the real program leaves;
their manifest entries; and binning_ms.map, which reads the same device
time from the program's `binning` range alone as from it and the
benchmark's coinciding wrapper together."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import manifest
from benchmark.metrics.trace_summary import Event, summarize
from benchmark.tests import test_benchmark_manifest

torch = pytest.importorskip("torch")

NEW = {
    "eval_ms.track": ("program_span", "track_ms", ["qvga50k-track-igs"]),
    "optimizer_host_ms.track": ("program_span", "track_ms",
                                ["qvga50k-track-igs", "qvga50k-track-gn"]),
    "linearize_ms.track": ("program_span", "track_ms", ["qvga50k-track-gn"]),
    "syncs_per_eval.track": ("program_counter", "track_ms",
                             ["qvga50k-track-igs", "qvga50k-track-gn"]),
    "binning_syncs_per_step.map": ("program_counter", "map_step_ms", ["vga1m-map"]),
    "pairs_dropped_share.map": ("program_counter", "map_step_ms", ["vga1m-map"]),
    "pairs_dropped_share.track": ("program_counter", "track_ms",
                                  ["qvga50k-track-igs", "qvga50k-track-gn"]),
}
MS = 1_000_000


def reader(name):
    return manifest.load_file(manifest.ROOT / "benchmark" / "metrics" / f"{name}.py",
                              "test_metric_" + name.replace(".", "_")).read


def sp(name, parent, start, end, self_ns=None, syncs=0):
    return {"name": name, "parent": parent, "thread": 1, "start_ns": start, "end_ns": end,
            "self_ns": end - start if self_ns is None else self_ns, "syncs": syncs}


# Two tracked frames: frame 0 with two evaluations and one linearization,
# frame 1 with one evaluation; and two mapping steps, each binning once.
SESSION = {
    "open": False, "syncs_outside": 3,
    "spans": [
        sp("track.frame", None, 0, 100 * MS, 1 * MS),                       # 0
        sp("track.optimizer", 0, 0, 90 * MS, 40 * MS, syncs=1),             # 1
        sp("track.eval", 1, 0, 20 * MS, 0, syncs=2),                        # 2
        sp("track.eval", 1, 20 * MS, 40 * MS, 0, syncs=2),                  # 3
        sp("track.linearize", 1, 40 * MS, 50 * MS, syncs=0),                # 4
        sp("binning", 0, 95 * MS, 99 * MS, syncs=4),                        # 5
        sp("track.frame", None, 200 * MS, 260 * MS, 0),                     # 6
        sp("track.optimizer", 6, 200 * MS, 260 * MS, 30 * MS),              # 7
        sp("track.eval", 7, 200 * MS, 230 * MS, 0, syncs=5),                # 8
        sp("map.step", None, 300 * MS, 400 * MS, 0),                        # 9
        sp("binning", 9, 300 * MS, 350 * MS, syncs=40),                     # 10
        sp("map.step", None, 400 * MS, 500 * MS, 0),                        # 11
        sp("binning", 11, 400 * MS, 450 * MS, syncs=38),                    # 12
    ],
    "counters": {"track.evals": 4, "pairs.wanted": 1000, "pairs.over_budget": 250,
                 "pairs.over_capacity": 500, "tiles.over_capacity": 7},
}
EXPECTED = {
    "eval_ms.track": (20 + 20 + 30) / 3,
    "optimizer_host_ms.track": (40 + 30) / 2,  # self time a frame
    "linearize_ms.track": 10.0,
    "syncs_per_eval.track": (1 + 2 + 2 + 0 + 4 + 2 * 0 + 5) / 4,  # under the frames
    "binning_syncs_per_step.map": (4 + 40 + 38) / 2,
    "pairs_dropped_share.map": 75.0,
    "pairs_dropped_share.track": 75.0,
}
TRACED = SimpleNamespace(trace={"busy_s": 1.0}, work={}, counters={}, window={})
UNTRACED = SimpleNamespace(trace=None, work={}, counters={}, window={})


@pytest.fixture
def recorder(monkeypatch):
    from gslam_tpu_torch.runtime import trace

    def use(session):
        monkeypatch.setattr(trace, "snapshot",
                            lambda: {"spans": {}, "counters": {}, "session": session})
    return use


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_on_a_synthetic_session(recorder, name):
    recorder(SESSION)
    assert reader(name)(TRACED) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_raises_on_a_traced_run_without_a_session(recorder, name):
    recorder(None)
    with pytest.raises(RuntimeError, match="no session"):
        reader(name)(TRACED)
    recorder(dict(SESSION, spans=[]))
    with pytest.raises(RuntimeError, match="no session"):
        reader(name)(TRACED)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_reads_nothing_untraced_or_without_the_recorder(recorder, monkeypatch, name):
    recorder(SESSION)
    assert reader(name)(UNTRACED) is None
    monkeypatch.setitem(sys.modules, "gslam_tpu_torch.runtime.trace", None)  # not importable
    assert reader(name)(TRACED) is None


def test_readers_raise_where_their_spans_are_missing(recorder):
    tracking_only = dict(SESSION, spans=SESSION["spans"][:9])
    recorder(tracking_only)
    with pytest.raises(RuntimeError, match="map.step"):
        reader("binning_syncs_per_step.map")(TRACED)
    recorder(dict(SESSION, counters={}))
    with pytest.raises(RuntimeError, match="pairs.wanted"):
        reader("pairs_dropped_share.map")(TRACED)
    with pytest.raises(RuntimeError, match="track.evals"):
        reader("syncs_per_eval.track")(TRACED)


def test_new_entries_keep_the_contract():
    bench = manifest.load()
    test_benchmark_manifest.test_contract_shape(bench)
    test_benchmark_manifest.test_every_cell_resolves(bench)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    assert list(per_layer)[-len(NEW):] == list(NEW)  # appended, in this order
    layers = {m["layer"] for m in bench["per_layer"][:-len(NEW)]}
    for name, (source, moves, cells) in NEW.items():
        m = per_layer[name]
        assert (m["source"], m["moves"], m["workloads"]) == (source, moves, cells)
        assert m["layer"] in layers  # a layer the benchmark already names
        for cell in cells:
            assert name in {x["name"] for x in manifest.Cell(bench, cell).per_layer}


def _ranges(events, wall_s=1.0):
    return summarize(events, wall_s, ("binning", "track_level"))


def test_binning_ms_reads_the_program_range_as_the_union():
    """The device side of the program's `binning` range, alone and with
    the benchmark's wrapper range around the same kernels: the same device
    seconds, so binning_ms.map reads the same value."""
    kernels = [Event("k", 1000 + 100 * i, 50, True, False) for i in range(6)]
    program = [Event("binning", 1000, 250, True, True), Event("binning", 1300, 250, True, True)]
    wrapper = [Event("binning", 1000, 250, True, True), Event("binning", 1300, 250, True, True)]
    host = [Event("binning", 990, 300, False, True)]
    alone = _ranges(kernels + program + host)
    both = _ranges(kernels + program + wrapper + host)
    assert alone["device_range_s"] == both["device_range_s"] == {"binning": 500e-9}
    read = reader("binning_ms.map")
    work = {"units": 2}
    assert read(SimpleNamespace(work=work, trace=alone)) == read(
        SimpleNamespace(work=work, trace=both)) == pytest.approx(1e3 * 500e-9 / 2)


@pytest.mark.parametrize("method", ["igs", "gn"])
def test_readers_on_a_real_session(method):
    """The readers of the tracking cells on the session a cut-size frame of
    the program leaves under the CPU profiler: finite numbers (no CUDA
    here, so no syncs)."""
    from torch.profiler import ProfilerActivity, profile

    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig, track_frame

    ds = SyntheticDataset(seq_len=2, width=64, height=48, n_splats=300, seed=2,
                          motion_scale=0.01, device="cpu")
    gmap = gaussian_map_from_numpy(ds.gt_map_fields, device="cpu")
    cfg = TrackingConfig(method=method, warmup_steps=2, lbfgs_max_iter=6, lbfgs_max_eval=8,
                         gn_iters=2, render=RenderConfig(tile_capacity=64))
    with profile(activities=[ProfilerActivity.CPU]):
        r = track_frame(gmap, ds.poses[0], torch.zeros(2), torch.from_numpy(ds.images[1]),
                        ds.camera.K, 64, 48, cfg, device="cpu")
    cell = "qvga50k-track-gn" if method == "gn" else "qvga50k-track-igs"
    values = {m: reader(m)(TRACED) for m, (_, _, cells) in NEW.items() if cell in cells}
    assert values["syncs_per_eval.track"] == 0.0
    assert 0.0 <= values["pairs_dropped_share.track"] < 100.0
    assert all(v > 0 for k, v in values.items() if k.endswith("_ms.track")), values
    key = "linearize_ms.track" if method == "gn" else "eval_ms.track"
    assert key in values and r.n_evals > 0
