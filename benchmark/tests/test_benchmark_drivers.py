"""Each cell's driver runs through the harness's whole control flow on the
CPU at a cut size: set-up, a window, the check against the reference and
the metric readers. A CPU run writes no device metric."""

import time

import pytest

from benchmark import harness, manifest

torch = pytest.importorskip("torch")


def cut(name, frames=4):
    """The cell at a cut size: the mapping cell at 64x48 over 4,000 splats,
    a tracking cell at 128x96 over 2,000 splats with 60 evaluations (or 4
    LM iterations a level), where tracking recovers the pose to under a
    millimetre as at the cell's own size."""
    cell = manifest.Cell(manifest.load(), name)
    c = cell.config
    if "mapping" in c:
        c["camera"] = {"width": 64, "height": 48, "fx": 56.0}
        c["map"].update(capacity=4096, n_live=4000)
        c["render"]["tile_capacity"] = 64
    else:
        c["camera"] = {"width": 128, "height": 96, "fx": 112.0}
        c["map"].update(capacity=2000, n_live=2000)
        c["render"]["tile_capacity"] = 128
        c["tracking"].update(lbfgs_max_eval=60, lbfgs_max_iter=50)
        cell.traffic["frames"] = frames
        if "gn_iters" in cell.traffic["tracking"]:
            cell.traffic["tracking"] = dict(cell.traffic["tracking"], gn_iters=4)
    return cell


def run(cell, seed=2**31 + 11, seconds=0.5, trace=False, control=False):
    torch.set_num_threads(2)
    return harness.execute(cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), log=lambda s: None, control=control)


@pytest.mark.parametrize("name", ["qvga50k-track-igs", "vga1m-map", "qvga50k-track-gn"])
def test_cell_runs_on_the_cpu(name):
    cell = cut(name)
    res = run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == e2e - {"peak_mem_gib"}  # no device metric off the card
    assert set(res["checks"]) == set(cell.limits())
    assert res["checks"]["loss_gap"]["value"] < 1e-5  # the program's objective, recomputed


def test_traced_run_on_the_cpu_reads_counters_only():
    cell = cut("qvga50k-track-igs")
    res = run(cell, trace=True)
    assert set(res["metrics"]) == {"track_evals_per_frame"}
    assert "breakdown" not in res and "busy_s" not in res["device"]


@pytest.mark.parametrize("name", ["qvga50k-track-igs", "vga1m-map", "qvga50k-track-gn"])
def test_sound_cut_runs_are_correct(name):
    res = run(cut(name))
    assert res["correct"], res["checks"]
