"""One run of one cell of the benchmark (see benchmark/run.py for the
command). The run:

  1. makes the cell's inputs from the seed and builds the program's state
     (the cell's driver, drivers/<driver>.py), warms up its shapes and runs
     whatever set-up steps the check needs: `setup_s` ends here;
  2. runs the window: the driver's unit (one tracked frame, one mapping
     step) back to back until --seconds have passed, the last unit
     finished and synchronized; with --trace 1 the first `trace_units`
     units run under torch.profiler;
  3. reads the peak memory, frees the program's state, and checks what the
     window produced against the plain reference (reference/splats.py):
     each compared number beside its limit, on standard error and last in
     the result line;
  4. refuses to print a result if jax, jaxlib, flax or gslam_tpu (whole
     top-level module names) were loaded;
  5. prints one JSON line: correct, attempted, failed, metrics (the cell's
     end-to-end metrics, or with --trace 1 its per-layer metrics, each
     read by metrics/<name>.py), device, breakdown (traced) and checks.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

from benchmark import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "gslam_tpu")
TRACE_RANGES = ("binning", "track_level")
NAME_CHARS = 160  # of a kernel's or host event's name in the breakdown


def process_start() -> float:
    """The process's start on the perf_counter clock (Linux /proc; the
    interpreter's start is lost where /proc is missing)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def host_seconds() -> tuple[float, float]:
    """(this process's CPU seconds, the host's stolen CPU seconds summed
    over its CPUs from /proc/stat; 0 where that is missing): what the
    window's log line sets beside its wall time, to tell a host that ran
    the process slower from one that ran it less."""
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.process_time(), steal


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _nvidia_smi():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def execute(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=print, control: bool = False) -> dict:
    """Run `cell` once on `device` and return the result object (without
    printing it). On a CPU device nothing is traced and no memory is read:
    that is the rehearsal of the control flow, and its times are no
    device's. control=True puts the reference in TF32 in the program's
    place in the check (benchmark/tests/test_benchmark_control.py)."""
    import torch

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    run = SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=seed, device=device,
                          log=log)

    def program_start():
        """Set-up of the program begins: the peak counts from here."""
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

    run.program_start = program_start
    drv = cell.driver().Driver(run)
    drv.setup()
    sync()
    setup_s = time.perf_counter() - t_start

    n_traced = int(cell.traffic.get("trace_units", 1)) if trace and cuda else 0
    prof, traced_s = None, None
    unit_s, k = [], 0
    host0 = host_seconds()
    w0 = time.perf_counter()
    while True:
        if k == 0 and n_traced:
            from torch.profiler import ProfilerActivity, profile

            drv.install_ranges()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            t_trace = time.perf_counter()
        a = time.perf_counter()
        drv.unit(k)
        if drv.sync_each_unit:
            sync()
        b = time.perf_counter()
        unit_s.append(b - a)
        k += 1
        if n_traced and k == n_traced:
            sync()
            traced_s = time.perf_counter() - t_trace
            prof.stop()
            drv.remove_ranges()
        if b - w0 >= seconds and k >= n_traced:
            break
    sync()
    window_s = time.perf_counter() - w0
    cpu_s, steal_s = (b - a for a, b in zip(host0, host_seconds()))
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    drv.close_window()
    drv.control = control
    checks, failed = drv.check(n_traced)
    limits = cell.limits()
    bad = [n for n in checks if not (checks[n] <= limits[n])]  # NaN fails too
    correct = failed == 0 and not bad

    summary = None
    if prof is not None:
        from benchmark.metrics.trace_summary import kineto_events, summarize

        summary = summarize(kineto_events(prof), traced_s, TRACE_RANGES)
        del prof
    ctx = SimpleNamespace(
        window={"setup_s": setup_s, "window_s": window_s, "units": k, "unit_s": unit_s,
                "peak_bytes": peak if cuda else None},
        trace=summary, work=drv.work(), counters=drv.counters())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}

    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else str(device),
                "count": int(cell.entry.get("chips", 1)), "memory_peak_bytes": peak}
    if cuda:
        dev_info["nvidia_smi"] = _nvidia_smi()
    result = {"correct": bool(correct), "attempted": k, "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = {k: [[name[:NAME_CHARS], sec] for name, sec in summary[k]]
                               for k in ("device_ops", "idle_gaps")}
    log(f"host in the window: process CPU {cpu_s:.3f} s, stolen from the host's CPUs "
        f"{steal_s:.3f} s, load average {os.getloadavg()[0]:.2f}, "
        f"unit seconds {[round(t, 4) for t in unit_s]}")
    log(f"units in the window: {k} ({window_s:.3f} s), failed {failed}, "
        f"samples for the tail: {len(unit_s)}")
    for name, value in checks.items():
        log(f"check {name}: {value!r} <= {limits[name]!r} "
            f"{'ok' if name not in bad else 'FAILED'}")
    result["checks"] = {n: {"value": _finite(float(v)), "limit": limits[n]}
                        for n, v in checks.items()}
    return result


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = manifest.Cell(manifest.load(), args.workload)
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.set_num_threads(1)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                     t_start, log)
    bad = forbidden_modules()
    if bad:
        log(f"refused: modules {bad} were loaded in this process")
        return 3
    print(json.dumps(result), flush=True)
    return 0
