"""The port's one tracing system: named spans and counters.

    from gslam_tpu_torch.runtime import trace

    with trace.span("track.eval"):
        ...
    trace.count("track.evals", n)
    if trace.enabled():  # device arithmetic only while a profiler records
        trace.count("pairs.wanted", counts.sum())

Always on, cheap. Every span adds to its name's aggregate: calls, total
host seconds and self seconds (total minus the child spans it holds on its
own thread), timed with time.perf_counter_ns; every count adds to its
counter. No torch call and no device work happen on this path.

While a torch.profiler records, and only then (`enabled()`: on the threads
it records, which are the thread that started it and the autograd threads
working for it), the recorder also keeps a session:
  * each span enters torch.profiler.record_function(name) as well, so the
    program's layers lie on the profiler's timeline beside the device
    operations;
  * every span's name, parent, thread, start and end, on the profiler's
    clock (Unix nanoseconds: perf_counter plus an offset measured once per
    session), its self time and the host syncs it held;
  * host syncs: CUDA's sync debug mode is "warn" for the session, and each
    "called a synchronizing CUDA operation" warning is counted against the
    innermost open span of the thread that synced (`syncs_outside` where
    that thread holds no span of the session) instead of being shown;
  * the counts made during it; a device tensor is kept on the device as
    counted and summed there in batches, so a count launches nothing, and
    `snapshot()` reads the sum.
A session begins at the first span or count after the profiler starts. It
ends, and the previous sync debug mode is put back, at the first span,
count or sync after the profiler has stopped, or at `snapshot()` (a
profiler started again before any of these has seen it stop continues the
session).
The last session stays readable until the next one begins or `reset()`.

Parents come from a stack per thread, so spans of the backend's thread and
of the frontend's nest apart.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

SYNC_MESSAGE = "called a synchronizing CUDA operation"

# whether the profiler records this thread
_profiler_enabled = torch.autograd._profiler_enabled


def _profiler_running() -> bool:
    """Whether a profiler runs in any thread of the process."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False) or _profiler_enabled()


class _Span:
    """One open span; the recorder's `span(name)`."""

    __slots__ = ("rec", "name", "start", "child", "session", "record", "rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.child = 0
        session = rec._current()
        if session is not None:
            parent = stack[-1].record if stack and stack[-1].session is session else None
            self.session = session
            self.record = [self.name, parent, threading.get_ident(), 0, None, None, 0]
            with rec._lock:
                session["spans"].append(self.record)
            # the profiler stamps the range inside its enter and exit: each
            # end of the span is the middle of the call that marks it
            a = time.perf_counter_ns()
            self.rf = record_function(self.name)
            self.rf.__enter__()
            self.start = self.record[3] = (a + time.perf_counter_ns()) // 2
        else:
            self.session = self.record = self.rf = None
            self.start = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            end = (end + time.perf_counter_ns()) // 2
        rec = self.rec
        stack = rec._stack()
        stack.pop()
        total = end - self.start
        self_ns = total - self.child
        if stack:
            stack[-1].child += total
        if self.record is not None:
            self.record[4], self.record[5] = end, self_ns
        with rec._lock:
            agg = rec._aggs.get(self.name)
            if agg is None:
                rec._aggs[self.name] = [1, total, self_ns]
            else:
                agg[0] += 1
                agg[1] += total
                agg[2] += self_ns
        return False


class Recorder:
    """Span aggregates, counters and the last profiler session of one
    process. The module's functions act on its one instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._aggs: dict[str, list[int]] = {}  # name -> [calls, total_ns, self_ns]
        self._counters: dict[str, _Tally] = {}
        self._session: dict | None = None
        self._restore = None  # (sync debug mode, showwarning, filter) while a session is open

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    # ----------------------------------------------------------- session

    def _current(self) -> dict | None:
        """The open session where the profiler records this thread (begun
        now if need be); None elsewhere, after ending a session whose
        profiler has stopped."""
        if _profiler_enabled():
            return self._session_on()
        s = self._session
        if s is not None and s["open"] and not _profiler_running():
            self._session_off()
        return None

    def _session_on(self) -> dict:
        """The open session, begun now where the last one has ended."""
        s = self._session
        if s is not None and s["open"]:
            return s
        with self._lock:
            s = self._session
            if s is not None and s["open"]:
                return s
            offset = min(((b - a, u - (a + b) // 2) for a, u, b in
                          ((time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns())
                           for _ in range(3))))[1]
            self._session = s = {"open": True, "offset_ns": offset, "spans": [],
                                 "counters": {}, "syncs_outside": 0}
            self._watch_syncs()
            return s

    def _session_off(self):
        with self._lock:
            if self._session is not None and self._session["open"]:
                self._session["open"] = False
                self._unwatch_syncs()

    def _watch_syncs(self):
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        shown = warnings.showwarning
        warnings.showwarning = self._showwarning
        # "always": repeats from one source line are each shown, so counted
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        self._restore = (mode, shown, warnings.filters[0])

    def _unwatch_syncs(self):
        mode, shown, entry = self._restore
        self._restore = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        if warnings.showwarning == self._showwarning:
            warnings.showwarning = shown
        try:
            warnings.filters.remove(entry)
        except ValueError:  # the caller's warnings context already dropped it
            pass

    def _showwarning(self, message, category, filename, lineno, file=None, line=None):
        restore = self._restore
        if restore is None or not str(message).startswith(SYNC_MESSAGE):
            shown = restore[1] if restore is not None else warnings._showwarning_orig
            return shown(message, category, filename, lineno, file, line)
        if not _profiler_running():  # a sync after the profiler stopped ends the session
            self._session_off()
            return None
        stack = self._stack()
        session = self._session
        if stack and session is not None and stack[-1].session is session:
            stack[-1].record[6] += 1
        elif session is not None:
            with self._lock:
                session["syncs_outside"] += 1

    # --------------------------------------------------------------- API

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n=1):
        """Add n (an int, or a tensor that stays on its device) to the
        counter `name`, and to the session's while one is open."""
        session = self._current()
        with self._lock:
            self._counters.setdefault(name, _Tally()).add(n)
            if session is not None:
                session["counters"].setdefault(name, _Tally()).add(n)

    def snapshot(self) -> dict:
        """A plain dict: `spans` (name -> calls, total_s, self_s since the
        last reset), `counters` (name -> number) and `session` (None, or the
        last session: `open`, `spans` as dicts of name, parent (index into
        the list), thread, start_ns, end_ns (None while open), self_ns and
        syncs, `counters`, and `syncs_outside`: syncs held by no span of the
        session, on a thread outside every span or one the profiler does not
        record)."""
        if not _profiler_running():
            self._session_off()
        with self._lock:
            aggs = {k: {"calls": c, "total_s": t / 1e9, "self_s": s / 1e9}
                    for k, (c, t, s) in self._aggs.items()}
            counters = dict(self._counters)
            s = self._session
            if s is not None:
                recs = list(s["spans"])
                s_counters, outside, offset, is_open = (dict(s["counters"]),
                                                        s["syncs_outside"], s["offset_ns"],
                                                        s["open"])
        session = None
        if s is not None:
            index = {id(r): i for i, r in enumerate(recs)}
            spans = [{"name": r[0], "parent": None if r[1] is None else index.get(id(r[1])),
                      "thread": r[2], "start_ns": r[3] + offset,
                      "end_ns": None if r[4] is None else r[4] + offset,
                      "self_ns": r[5], "syncs": r[6]} for r in recs]
            session = {"open": is_open, "spans": spans, "syncs_outside": outside}
        with self._quiet():
            counters = {k: v.value() for k, v in counters.items()}
            if session is not None:
                session["counters"] = {k: v.value() for k, v in s_counters.items()}
        return {"spans": aggs, "counters": counters, "session": session}

    @contextlib.contextmanager
    def _quiet(self):
        """The sync debug mode of before the session, while snapshot()
        reads device counters: those reads are no syncs of the program's."""
        restore = self._restore
        if restore is None or restore[0] is None:
            yield
            return
        torch.cuda.set_sync_debug_mode(restore[0])
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def reset(self):
        """Forget every aggregate, counter and session."""
        self._session_off()
        with self._lock:
            self._aggs.clear()
            self._counters.clear()
            self._session = None


class _Tally:
    """A counter: an int, and the device tensors counted, summed on their
    device 64 at a time."""

    __slots__ = ("n", "pending")

    def __init__(self):
        self.n, self.pending = 0, []

    def add(self, v):
        if isinstance(v, torch.Tensor):
            self.pending.append(v.detach())
            if len(self.pending) >= 64:
                self.pending = [torch.stack(self.pending).sum()]
        else:
            self.n += v

    def value(self):
        return self.n + (torch.stack(self.pending).sum().item() if self.pending else 0)


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
snapshot = _RECORDER.snapshot
reset = _RECORDER.reset


def enabled() -> bool:
    """Whether a torch.profiler records, so a session is kept."""
    return _profiler_enabled()
