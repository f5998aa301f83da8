"""BENCHMARK.json and the files its names resolve to.

Everything that belongs to one configuration, traffic mix, entry point or
metric sits in a file of its own, found by name:
  configs: the `file` each configuration names;
  traffic: benchmark/traffic/<traffic>.json, which names its driver;
  limits: benchmark/limits/<cell>.json, the limit of each number the
    cell's check compares;
  drivers: benchmark/drivers/<driver>.py;
  metrics: benchmark/metrics/<metric>.py, one `read(ctx)` per metric.
So a cell, a configuration, a traffic mix or a metric is added by adding
files and entries, without editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Cell:
    """One workload of the manifest with everything it resolves to."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        self.bench = root / "benchmark"
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.traffic_path = self.bench / "traffic" / f"{self.entry['traffic']}.json"
        self.traffic = json.loads(self.traffic_path.read_text())
        self.driver_path = self.bench / "drivers" / f"{self.traffic['driver']}.py"
        self.limits_path = self.bench / "limits" / f"{name}.json"
        for path in (self.driver_path, self.limits_path):
            if not path.is_file():
                raise FileNotFoundError(path)
        self.end_to_end = [m for m in manifest["end_to_end"] if _applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        for m in self.end_to_end + self.per_layer:
            if not self.metric_path(m["name"]).is_file():
                raise FileNotFoundError(self.metric_path(m["name"]))

    def limits(self) -> dict:
        """The limits of the numbers this cell's check compares."""
        return json.loads(self.limits_path.read_text())

    def metric_path(self, name: str) -> Path:
        return self.bench / "metrics" / f"{name}.py"

    def reader(self, name: str):
        """The read(ctx) of metrics/<name>.py."""
        return load_file(self.metric_path(name),
                         "benchmark_metric_" + name.replace(".", "_")).read

    def driver(self):
        """The module of drivers/<driver>.py."""
        return load_file(self.driver_path, "benchmark_driver_" + self.traffic["driver"])


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_file(path: Path, name: str):
    """A module loaded from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
