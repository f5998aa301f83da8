"""What the per-layer metrics of source program_span and program_counter
read: the program's own recorder (gslam_tpu_torch/runtime/trace.py), its
last session. A traced run opens that session with the profiler over the
traced units, so it holds their spans and counters and nothing of the
set-up or of the check.

`session` gives None where there is nothing to read: a run not traced on
the card, or a program that has no recorder (an older commit). A traced
run on the card whose session is missing or empty is an error: the
program's spans are gone."""

from __future__ import annotations

import importlib

RECORDER = "gslam_tpu_torch.runtime.trace"


def session(ctx, metric: str):
    if ctx.trace is None:
        return None
    try:
        trace = importlib.import_module(RECORDER)
    except ModuleNotFoundError as e:
        if e.name not in (RECORDER, RECORDER.rsplit(".", 1)[0]):
            raise
        return None
    s = trace.snapshot()["session"]
    if s is None or not s["spans"]:
        raise RuntimeError(f"{metric}: the traced run holds no session of the program's "
                           f"recorder ({RECORDER})")
    return s


def spans(s, name: str) -> list:
    return [sp for sp in s["spans"] if sp["name"] == name]


def calls(s, name: str, metric: str) -> int:
    """The session's spans called `name`; an error where there are none."""
    n = len(spans(s, name))
    if not n:
        raise RuntimeError(f"{metric}: the traced run holds no {name!r} span")
    return n


def total_ms(s, name: str) -> float:
    return sum(sp["end_ns"] - sp["start_ns"] for sp in spans(s, name)) / 1e6


def self_ms(s, name: str) -> float:
    return sum(sp["self_ns"] for sp in spans(s, name)) / 1e6


def syncs_under(s, name: str) -> int:
    """Host syncs held by the spans called `name` and by every span inside
    them (a span's parent comes before it in the list)."""
    inside = []
    for sp in s["spans"]:
        p = sp["parent"]
        inside.append(sp["name"] == name or (p is not None and inside[p]))
    return sum(sp["syncs"] for sp, ok in zip(s["spans"], inside) if ok)


def counter(s, name: str, metric: str):
    value = s["counters"].get(name)
    if not value:
        raise RuntimeError(f"{metric}: the traced run's counter {name!r} is {value!r}")
    return value


def dropped_share(s, metric: str) -> float:
    """Binning's pairs dropped over the budget and over the tiles'
    capacity, in percent of the pairs it was asked for."""
    c = s["counters"]
    wanted = counter(s, "pairs.wanted", metric)
    return 100.0 * (c.get("pairs.over_budget", 0) + c.get("pairs.over_capacity", 0)) / wanted
