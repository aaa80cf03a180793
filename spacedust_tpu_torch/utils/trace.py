"""Spans and counts of the program's stages, for a reader that lines them
up with a device trace.

`span(name, **attrs)` is a context manager that times a stage on the
host's monotonic clock (`time.perf_counter_ns`), on the thread that does
the work; its `seconds` are what the stage reports (a key of the
`detail:` line, an engine metric), so every stage is timed once.  While
recording is on, each span's end appends

    (name, thread id, t0_ns, t1_ns, attrs, rss_bytes)

to one buffer of the process (`rss_bytes`: the resident set at the
span's end, from /proc/self/statm), and `count(name, n)` appends
(name, thread id, t_ns, n).  With recording off a span reads the clock
twice and appends nothing.  Spans and counts stay at the granularity of
a stage or a chunk: a loop over pairs gets one span round it and a count.

Recording is on between `start()` and `stop()`, and while torch.profiler
records in this process.  torch.profiler drops `record_function` ranges
opened on worker threads, so a profiled run carries the program's spans
here instead, for its reader to merge with the profiler's timeline.

Every start and read records an anchor pair (perf_counter_ns, time_ns);
`Recorded.epoch_ns` maps a span's clock through the anchors onto the
epoch clock, which is that of a chrome trace of torch.profiler (`ts` in
us plus the trace's `baseTimeNanoseconds`).  `write_chrome` writes spans
as Chrome-trace JSON (Perfetto, chrome://tracing), and `recording_to`
does so for one command (the CLI's `--trace-file`).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch.autograd.profiler as _profiler

_PAGE = os.sysconf("SC_PAGE_SIZE")


def _rss() -> int:
    """Resident bytes of this process (0 where /proc is absent)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE
    except OSError:
        return 0


@dataclass
class Recorded:
    """What was recorded: spans (name, tid, t0_ns, t1_ns, attrs,
    rss_bytes) in the order they ended, counts (name, tid, t_ns, n), and
    the anchor pairs (perf_counter_ns, time_ns), first to last."""
    spans: list
    counts: list
    anchors: list

    def epoch_ns(self, t_ns: int) -> float:
        """A perf_counter_ns reading on the epoch clock, interpolated
        between the first and the last anchor."""
        (p0, e0), (p1, e1) = self.anchors[0], self.anchors[-1]
        if p1 == p0:
            return float(e0 + (t_ns - p0))
        return e0 + (t_ns - p0) * ((e1 - e0) / (p1 - p0))

    def since(self, t_ns: int) -> "Recorded":
        """The spans that started, and the counts made, at t_ns or
        later."""
        return Recorded([s for s in self.spans if s[2] >= t_ns],
                        [c for c in self.counts if c[2] >= t_ns],
                        self.anchors)


class _Buffer:
    def __init__(self):
        self.on = False
        self.spans: list = []
        self.counts: list = []
        self.anchors: list = []
        self.lock = threading.Lock()

    def anchor(self) -> None:
        self.anchors.append((time.perf_counter_ns(), time.time_ns()))

    def append(self, where: list, item: tuple) -> None:
        if not self.anchors:
            self.anchor()
        where.append(item)


_buf = _Buffer()


def recording() -> bool:
    return _buf.on or _profiler._is_profiler_enabled


class Span:
    """A timed stage: `t0`, `t1` (perf_counter_ns) and `seconds`."""

    __slots__ = ("name", "attrs", "t0", "t1")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.t0 = self.t1 = 0

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if _buf.on or _profiler._is_profiler_enabled:
            _buf.append(_buf.spans, (self.name, threading.get_native_id(),
                                     self.t0, self.t1, self.attrs, _rss()))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def span(name: str, **attrs) -> Span:
    return Span(name, attrs)


def count(name: str, n: int) -> None:
    if _buf.on or _profiler._is_profiler_enabled:
        _buf.append(_buf.counts, (name, threading.get_native_id(),
                                  time.perf_counter_ns(), int(n)))


def start() -> None:
    """Turn recording on, with an empty buffer."""
    with _buf.lock:
        _buf.spans, _buf.counts, _buf.anchors = [], [], []
        _buf.anchor()
        _buf.on = True


def snapshot() -> Recorded:
    """What has been recorded so far; the buffer keeps it."""
    with _buf.lock:
        _buf.anchor()
        return Recorded(list(_buf.spans), list(_buf.counts),
                        list(_buf.anchors))


def take() -> Recorded:
    """What has been recorded so far; the buffer starts anew (recording
    stays as it is)."""
    with _buf.lock:
        _buf.anchor()
        out = Recorded(_buf.spans, _buf.counts, _buf.anchors)
        _buf.spans, _buf.counts, _buf.anchors = [], [], [out.anchors[-1]]
        return out


def stop() -> Recorded:
    """take(), and recording off."""
    out = take()
    _buf.on = False
    return out


def write_chrome(path: str | Path, rec: Recorded) -> None:
    """Chrome-trace JSON of `rec`: one "X" event a span (ts and dur in us,
    ts on the epoch clock, one tid a thread, attrs as args), the resident
    memory at each span's end as the counter track "rss", and each count
    as a counter track of its name."""
    pid = os.getpid()
    main = threading.main_thread().native_id
    tids = sorted({s[1] for s in rec.spans} | {c[1] for c in rec.counts})
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
               "args": {"name": "main" if tid == main else f"worker {tid}"}}
              for tid in tids]
    for name, tid, t0, t1, attrs, rss in sorted(rec.spans,
                                                key=lambda s: s[2]):
        events.append({"name": name, "cat": "spacedust", "ph": "X",
                       "ts": rec.epoch_ns(t0) / 1e3,
                       "dur": (t1 - t0) / 1e3, "pid": pid, "tid": tid,
                       "args": attrs})
        events.append({"name": "rss", "ph": "C", "pid": pid,
                       "ts": rec.epoch_ns(t1) / 1e3,
                       "args": {"GiB": rss / 2**30}})
    for name, tid, t, n in rec.counts:
        events.append({"name": name, "ph": "C", "pid": pid, "tid": tid,
                       "ts": rec.epoch_ns(t) / 1e3, "args": {name: n}})
    Path(path).write_text(json.dumps({"traceEvents": events,
                                      "displayTimeUnit": "ms"}))


@contextlib.contextmanager
def recording_to(path: str | None):
    """Record the body's spans and write them to `path` as Chrome-trace
    JSON when it ends (nothing where path is None).  Where recording was
    on before (start(), or torch.profiler), the buffer keeps the spans
    for its reader."""
    if path is None:
        yield
        return
    was_on = _buf.on
    _buf.on = True
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        _buf.on = was_on
        rec = snapshot() if recording() else take()
        write_chrome(path, rec.since(t0))
