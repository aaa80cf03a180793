"""The device timeline of a traced window, from torch.profiler's chrome
trace: the seconds in which a kernel, a copy or a memset ran on the card
(the union of their intervals, clipped to the window), the device
operations that took most time, and the longest idle gaps, each labelled
by the innermost harness span (`portbench.*` record_function ranges) that
holds its middle."""

from __future__ import annotations

import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(path: Path) -> dict:
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans, device = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            device.append((ts, end, e["name"]))
        elif (e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("portbench.")):
            spans.append((ts, end, e["name"][len("portbench."):]))
    window = next(((s, e) for s, e, n in spans if n == "window"), None)
    if window is None:
        raise ValueError("the trace holds no portbench.window span")
    w0, w1 = window
    busy = _union((max(s, w0), min(e, w1)) for s, e, _n in device
                  if e > w0 and s < w1)
    busy_us = sum(e - s for s, e in busy)

    by_name: dict[str, float] = {}
    for s, e, n in device:
        if e > w0 and s < w1:
            by_name[n] = by_name.get(n, 0.0) + (min(e, w1) - max(s, w0))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    inner = [sp for sp in spans if sp[2] != "window"]

    def label(a, b):
        mid = 0.5 * (a + b)
        holding = [sp for sp in inner if sp[0] <= mid <= sp[1]]
        return (min(holding, key=lambda sp: sp[1] - sp[0])[2] if holding
                else "window")

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[label(a, b), (b - a) / 1e6] for a, b in longest]}
