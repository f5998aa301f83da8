"""BENCHMARK.json loads, every name in it resolves to a file, it keeps the
contract's shape, and a cell, configuration, traffic mix and metric are
added by adding files alone."""

import json
import re
import shutil

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = manifest.Cell(bench, w["name"])
        assert cell.driver_path.is_file() and cell.traffic_path.is_file()
        assert cell.config["name"] == w["config"]
        assert set(cell.limits()) and all(v > 0 for v in cell.limits().values())
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
        assert hasattr(cell.driver(), "Driver")


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    reported = {c: {m["name"] for m in bench["end_to_end"]
                    if c in m.get("workloads", cells)} for c in cells}
    for m in bench["per_layer"]:
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for c in m["workloads"]:
            assert m["moves"] in reported[c], (m["name"], c)
    for c in cells:  # set-up, one more end-to-end metric, one per-layer metric
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
        assert any(c in m["workloads"] for m in bench["per_layer"])


def test_cell_added_by_files_alone(tmp_path, bench):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and two cells, one on the new mix and one on a mix that is
    there, each with its limits: new files and new manifest entries only."""
    shutil.copytree(manifest.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((manifest.ROOT / "benchmark/configs/tum-qvga-50k.json").read_text())
    cfg["name"] = "tum-qvga-20k"
    cfg["map"].update(capacity=20000, n_live=20000)
    (tmp_path / "benchmark/configs/tum-qvga-20k.json").write_text(json.dumps(cfg))
    traffic = json.loads((manifest.ROOT / "benchmark/traffic/track-chain-igs.json").read_text())
    traffic["motion_sigma"] = 0.002
    (tmp_path / "benchmark/traffic/track-chain-slow.json").write_text(json.dumps(traffic))
    limits = {"loss_gap": 1e-3, "trans_err_m": 0.02, "rot_err_rad": 0.02}
    for cell in ("qvga20k-track-slow", "qvga20k-track"):
        (tmp_path / f"benchmark/limits/{cell}.json").write_text(json.dumps(limits))
    (tmp_path / "benchmark/metrics/frames.track.py").write_text(
        "def read(ctx):\n    return ctx.window['units']\n")
    ext = json.loads(json.dumps(bench))
    ext["configs"].append(dict(bench["configs"][0], name="tum-qvga-20k",
                               file="benchmark/configs/tum-qvga-20k.json"))
    new = {"qvga20k-track-slow": "track-chain-slow", "qvga20k-track": "track-chain-igs"}
    for name, mix in new.items():
        ext["workloads"].append({"name": name, "config": "tum-qvga-20k", "traffic": mix,
                                 "chips": 1, "why": "a test"})
    for m in ext["end_to_end"]:
        if "workloads" in m and "qvga50k-track-igs" in m["workloads"]:
            m["workloads"] += list(new)
    ext["per_layer"].append({"name": "frames.track", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "device",
                             "moves": "track_ms", "workloads": list(new)})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(ext))

    for name, mix in new.items():
        cell = manifest.Cell(manifest.load(tmp_path), name, root=tmp_path)
        assert cell.config["map"]["capacity"] == 20000
        assert cell.traffic_path.name == f"{mix}.json"
        assert cell.limits() == limits
        assert "frames.track" in [m["name"] for m in cell.per_layer]
        assert cell.reader("frames.track")(type("Ctx", (), {"window": {"units": 7}})) == 7
        assert {m["name"] for m in cell.end_to_end} == {"setup_s", "track_ms",
                                                       "track_p95_ms", "peak_mem_gib"}
    assert manifest.Cell(manifest.load(tmp_path), "qvga20k-track-slow",
                         root=tmp_path).traffic["motion_sigma"] == 0.002
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
