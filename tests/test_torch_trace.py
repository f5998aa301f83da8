"""The port's recorder (gslam_tpu_torch/runtime/trace.py): span aggregates and
self time, stacks per thread, sessions that follow torch.profiler, the
profiler's ranges beside the session's spans, the span trees of a tracked
frame and a mapping step, and binning's pair counters against a hand count.
The host-sync counter needs CUDA's sync debug mode: its test is marked
`cuda` (run on the card with `pytest --noconftest -m cuda tests/`). No JAX
here: the card's host has none."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gslam_tpu_torch.runtime import trace  # noqa: E402

CPU = [ProfilerActivity.CPU]


def session():
    return trace.snapshot()["session"]


def tree(s):
    """{span name: the set of its parents' names} over a session."""
    out = {}
    for sp in s["spans"]:
        parent = None if sp["parent"] is None else s["spans"][sp["parent"]]["name"]
        out.setdefault(sp["name"], set()).add(parent)
    return out


def names(s, name):
    return [sp for sp in s["spans"] if sp["name"] == name]


def test_nesting_and_self_time():
    rec = trace.Recorder()
    with rec.span("outer"):
        for _ in range(2):
            with rec.span("inner"):
                time.sleep(0.01)
        time.sleep(0.005)
    spans = rec.snapshot()["spans"]
    assert spans["inner"]["calls"] == 2 and spans["outer"]["calls"] == 1
    assert spans["inner"]["total_s"] >= 0.02 and spans["inner"]["self_s"] == spans["inner"]["total_s"]
    outer = spans["outer"]
    assert outer["self_s"] == pytest.approx(outer["total_s"] - spans["inner"]["total_s"], abs=1e-9)
    assert 0.005 <= outer["self_s"] < outer["total_s"]
    rec.count("n", 2)
    rec.count("n")
    assert rec.snapshot()["counters"] == {"n": 3}
    rec.reset()
    assert rec.snapshot() == {"spans": {}, "counters": {}, "session": None}


def test_thread_local_stacks():
    """Spans of two threads nest on their own stacks: a span another thread
    holds open is no parent. The profiler records the thread that started
    it, so the session holds that thread's spans alone, and the other
    thread's spans neither enter it nor end it."""
    rec = trace.Recorder()
    inside = threading.Event()

    def work():
        inside.wait(timeout=30)
        for _ in range(50):
            with rec.span("worker.outer"):
                with rec.span("worker.inner"):
                    time.sleep(0.0002)

    worker = threading.Thread(target=work)
    worker.start()
    with profile(activities=CPU):
        with rec.span("main"):
            inside.set()
            worker.join(timeout=60)
            with rec.span("main.after"):
                pass
    assert not worker.is_alive()
    snap = rec.snapshot()
    spans = snap["spans"]
    assert spans["worker.outer"]["calls"] == spans["worker.inner"]["calls"] == 50
    assert spans["worker.inner"]["self_s"] == spans["worker.inner"]["total_s"]
    main = spans["main"]
    assert main["self_s"] == pytest.approx(main["total_s"] - spans["main.after"]["total_s"],
                                           abs=1e-9)
    assert main["self_s"] >= spans["worker.outer"]["total_s"]
    s = snap["session"]
    assert tree(s) == {"main": {None}, "main.after": {"main"}}
    assert {sp["thread"] for sp in s["spans"]} == {threading.get_ident()}


def test_aggregates_lose_no_update_across_threads():
    """More threads than cores, switching every microsecond: no lost update."""
    rec = trace.Recorder()
    n_threads, n_spans = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with rec.span("t"):
                    rec.count("c")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = rec.snapshot()
    assert snap["spans"]["t"]["calls"] == n_threads * n_spans
    assert snap["counters"]["c"] == n_threads * n_spans


def test_session_follows_the_profiler():
    """A session begins when a profiler starts recording and ends at the
    first span after it stops; nothing is recorded in it while the
    profiler is off, though the aggregates count every span."""
    rec = trace.Recorder()
    with rec.span("before"):
        rec.count("n")
    assert rec.snapshot()["session"] is None and not trace.enabled()
    with profile(activities=CPU):
        assert trace.enabled()
        with rec.span("during"):
            rec.count("n", 2)
        assert rec.snapshot()["session"]["open"]
    with rec.span("after"):
        rec.count("n", 4)
    snap = rec.snapshot()
    s = snap["session"]
    assert not s["open"]
    assert [sp["name"] for sp in s["spans"]] == ["during"] and s["counters"] == {"n": 2}
    assert snap["counters"] == {"n": 7}
    assert {k: v["calls"] for k, v in snap["spans"].items()} == {"before": 1, "during": 1,
                                                                "after": 1}
    with profile(activities=CPU):
        with rec.span("second"):
            pass
    assert [sp["name"] for sp in rec.snapshot()["session"]["spans"]] == ["second"]


def test_session_ends_at_snapshot():
    rec = trace.Recorder()
    with profile(activities=CPU):
        with rec.span("x"):
            pass
    s = rec.snapshot()["session"]
    assert not s["open"] and s["syncs_outside"] == 0 and s["spans"][0]["syncs"] == 0


def test_sync_warnings_count_against_the_innermost_span(recwarn):
    """CUDA's sync debug mode reports a sync as a warning; here the
    warnings are raised by hand. Each is counted against the innermost open
    span of the session (repeats from one line each count), or as outside,
    and none is shown; once the profiler has stopped, a sync ends the
    session uncounted. Other warnings pass through."""
    import warnings

    rec = trace.Recorder()

    def sync():
        warnings.warn(trace.SYNC_MESSAGE + " (raised by the test)")

    with profile(activities=CPU):
        sync()  # before any span: no session yet
        with rec.span("outer"):
            sync()
            with rec.span("inner"):
                for _ in range(3):
                    sync()
        with rec.span("other"):
            warnings.warn("an unrelated warning")
        rec.count("n")  # the session is open: a sync now is outside every span
        sync()
    sync()
    s = rec.snapshot()["session"]
    assert {sp["name"]: sp["syncs"] for sp in s["spans"]} == {"outer": 1, "inner": 3,
                                                             "other": 0}
    assert s["syncs_outside"] == 1
    shown = [str(w.message) for w in recwarn]
    assert "an unrelated warning" in shown
    # shown: the one before the session began; the one after the profiler
    # stopped ended the session, which had set the sync debug mode
    assert shown.count(trace.SYNC_MESSAGE + " (raised by the test)") == 1
    assert not rec.snapshot()["session"]["open"]


def _annotations(prof):
    return sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.is_user_annotation()), key=lambda a: (a[1], -a[2]))


def _innermost_parents(intervals):
    """Each interval's innermost enclosing interval (index or None); the
    intervals sorted by start, longer first at a tie."""
    parents, stack = [], []
    for i, (_, s, e) in enumerate(intervals):
        while stack and intervals[stack[-1]][2] < e:
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return parents


def test_profiler_ranges_match_the_spans():
    """Each span is a range on the profiler's timeline: same names, same
    nesting, and the session's start within 50 us of the profiler's. A
    thread preempted between the two stamps of a span moves its middle, so
    the clocks are compared over up to three sessions and the best holds."""
    rec = trace.Recorder()
    with profile(activities=CPU):  # the first ranges of a process cost more
        with rec.span("warm"):
            pass
    assert [sp["name"] for sp in rec.snapshot()["session"]["spans"]] == ["warm"]
    worst = []
    for _ in range(3):
        with profile(activities=CPU) as prof:
            for _ in range(3):
                with rec.span("a"):
                    with rec.span("b"):
                        torch.ones(64).sum()
                    with rec.span("c"):
                        with rec.span("d"):
                            time.sleep(0.001)
        s = rec.snapshot()["session"]
        ann = _annotations(prof)
        spans = sorted(s["spans"], key=lambda sp: sp["start_ns"])
        assert [a[0] for a in ann] == [sp["name"] for sp in spans]
        assert len(spans) == 12
        ann_parents = [None if p is None else ann[p][0] for p in _innermost_parents(ann)]
        assert ann_parents == [None if sp["parent"] is None
                               else s["spans"][sp["parent"]]["name"] for sp in spans]
        worst.append(max(abs(a[1] - sp["start_ns"]) for a, sp in zip(ann, spans)))
        if worst[-1] < 50_000:
            break
    assert min(worst) < 50_000, worst


# ------------------------------------------------------- the program's spans

W, H = 64, 48


@pytest.fixture(scope="module")
def scene():
    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy

    torch.manual_seed(0)
    ds = SyntheticDataset(seq_len=3, width=W, height=H, n_splats=300, seed=2,
                          motion_scale=0.01, device="cpu")
    return ds, gaussian_map_from_numpy(ds.gt_map_fields, device="cpu")


IGS_TREE = {"track.frame": {None}, "track.level": {"track.frame"},
            "track.bins": {"track.level"}, "binning": {"track.bins"},
            "track.optimizer": {"track.level"}, "track.eval": {"track.optimizer"},
            "track.render": {"track.eval"}, "track.loss": {"track.eval"},
            "track.backward": {"track.eval"}, "track.readback": {"track.eval"}}
GN_TREE = {"track.frame": {None}, "track.level": {"track.frame"},
           "track.bins": {"track.level"}, "binning": {"track.bins"},
           "track.optimizer": {"track.level"}, "track.eval": {"track.optimizer"},
           "track.render": {"track.eval"}, "track.loss": {"track.eval"},
           "track.linearize": {"track.optimizer"}, "track.solve": {"track.optimizer"},
           "track.readback": {"track.optimizer"}}


@pytest.mark.parametrize("method", ["igs", "gn"])
def test_track_frame_spans(scene, method):
    """A cut-size frame under the CPU profiler: the span tree of the
    method, one `track.eval` an evaluation (GN: each linearization is one
    too, as TrackResult.n_evals counts it), and the counter `track.evals`."""
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig, track_frame

    ds, gmap = scene
    cfg = TrackingConfig(method=method, warmup_steps=2, lbfgs_max_iter=8, lbfgs_max_eval=10,
                         gn_iters=3, pyramid_levels=2 if method == "gn" else 1,
                         pyramid_evals=(6, 6), render=RenderConfig(tile_capacity=64))
    args = (gmap, ds.poses[0], torch.zeros(2), torch.from_numpy(ds.images[1]), ds.camera.K,
            W, H, cfg)
    with profile(activities=CPU):
        r = track_frame(*args, device="cpu")
    s = session()
    assert tree(s) == (GN_TREE if method == "gn" else IGS_TREE)
    evals = len(names(s, "track.eval"))
    if method == "gn":
        evals += len(names(s, "track.linearize"))
        assert len(names(s, "track.level")) == 2
    assert evals == r.n_evals > 0
    assert s["counters"]["track.evals"] == r.n_evals
    assert len(names(s, "track.frame")) == 1 and s["syncs_outside"] == 0


def test_mapping_step_spans(scene):
    from gslam_tpu_torch.mapping.backend_ops import MapConfig, init_pose_adam, mapping_step
    from gslam_tpu_torch.mapping.keyframes import add_keyframe, empty_keyframes
    from gslam_tpu_torch.mapping.optimizer import init_adam
    from gslam_tpu_torch.ops.rasterize import RenderConfig

    ds, gmap = scene
    kf = empty_keyframes(4, H, W, device="cpu")
    for i in range(3):
        kf = add_keyframe(kf, i, torch.from_numpy(ds.images[i]), torch.from_numpy(ds.poses[i]),
                          torch.zeros(2), i)
    cfg = MapConfig(window_size=3, render=RenderConfig(tile_capacity=64))
    window = torch.arange(3)
    with profile(activities=CPU):
        mapping_step(gmap, init_adam(gmap), kf, init_pose_adam(4, device="cpu"), window,
                     torch.ones(3, dtype=torch.bool), ds.camera.K, W, H, cfg)
    s = session()
    assert tree(s) == {"map.step": {None}, "map.render": {"map.step"},
                       "binning": {"map.render"}, "map.loss": {"map.step"},
                       "map.backward": {"map.step"}, "map.adam": {"map.step"}}
    assert len(names(s, "map.step")) == 1
    c = s["counters"]
    assert c["pairs.wanted"] > 0 and set(c) == {"pairs.wanted", "pairs.over_budget",
                                                 "pairs.over_capacity", "tiles.over_capacity"}


def test_pair_counters_match_a_hand_count():
    """A 4 x 2 tile grid, capacity 3, a budget of 18 pairs:
      * 6 splats inside tile 0 (1 pair each),
      * 2 splats over tiles {1, 2} x rows {0, 1} (4 pairs each),
      * 1 splat over the whole grid (8 pairs), of which the budget keeps
        its first row (tiles 0-3),
      * 1 invalid splat.
    Wanted 6 + 8 + 8 = 22; over budget 22 - 18 = 4. Kept per tile: tile 0
    6 + 1 = 7, tiles 1 and 2 2 + 1 = 3, tile 3 1, tiles 5 and 6 2: tile 0
    alone is over capacity, by 7 - 3 = 4 pairs."""
    from gslam_tpu_torch.ops.binning import bin_gaussians

    means = [(8.0, 8.0)] * 6 + [(32.0, 16.0)] * 3 + [(8.0, 8.0)]
    radii = [2.0] * 6 + [4.0, 4.0, 40.0, 2.0]
    valid = [True] * 9 + [False]
    args = (torch.tensor(means), torch.tensor(radii), torch.arange(10.0) + 1.0,
            torch.tensor(valid), 16, 4, 2, 18, 3)
    with profile(activities=CPU):
        bins = bin_gaussians(*args)
    c = session()["counters"]
    assert c == {"pairs.wanted": 22, "pairs.over_budget": 4, "pairs.over_capacity": 4,
                 "tiles.over_capacity": 1}
    assert bins.tile_counts.tolist() == [7, 3, 3, 1, 0, 2, 2, 0]
    plain = bin_gaussians(*args)  # no profiler: the same lists, no counts
    assert all(torch.equal(a, b) for a, b in zip(bins, plain))
    assert session()["counters"] == c


# --------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_sync_counter_on_card():
    """One sync for each of .item(), .tolist(), .cpu(), nonzero and boolean
    indexing, counted against its span; over a profiled cut-size frame, the
    syncs counted equal the profiler's cudaStreamSynchronize calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync debug mode counts CUDA syncs only")
    from gslam_tpu_torch.io.synthetic import SyntheticDataset
    from gslam_tpu_torch.mapping.gaussians import gaussian_map_from_numpy
    from gslam_tpu_torch.ops.rasterize import RenderConfig
    from gslam_tpu_torch.tracking.track import TrackingConfig, track_frame

    x = torch.arange(16.0, device="cuda")
    cases = {"item": lambda: x.sum().item(), "tolist": lambda: x[:3].tolist(),
             "cpu": lambda: x.cpu(), "nonzero": lambda: torch.nonzero(x > 4),
             "mask": lambda: x[x > 4]}
    for fn in cases.values():
        fn()
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            for name, fn in cases.items():
                with trace.span(name):
                    fn()
    s = session()
    assert torch.cuda.get_sync_debug_mode() == mode
    for name in cases:
        assert [sp["syncs"] for sp in names(s, name)] == [1, 1], name

    ds = SyntheticDataset(seq_len=2, width=W, height=H, n_splats=300, seed=2,
                          motion_scale=0.01, device="cuda")
    gmap = gaussian_map_from_numpy(ds.gt_map_fields, device="cuda")
    cfg = TrackingConfig(warmup_steps=2, lbfgs_max_iter=8, lbfgs_max_eval=10,
                         render=RenderConfig(tile_capacity=64))
    args = (gmap, ds.poses[0], torch.zeros(2), torch.from_numpy(ds.images[1]), ds.camera.K,
            W, H, cfg)
    track_frame(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = track_frame(*args)
    s = session()
    counted = sum(sp["syncs"] for sp in s["spans"]) + s["syncs_outside"]
    calls = sum(ev.name() == "cudaStreamSynchronize"
                for ev in prof.profiler.kineto_results.events())
    assert counted == calls > r.n_evals
    frame = names(s, "track.frame")[0]
    assert sum(sp["syncs"] for sp in s["spans"]) == counted and frame["end_ns"] is not None
    assert np.isfinite(float(r.loss))
