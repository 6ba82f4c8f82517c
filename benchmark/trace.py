"""The reduction of one profiled pass's trace (``torch.profiler``'s Chrome
trace events) to device busy time, the device operations with most time
and the longest idle gaps named by what the host was doing."""

from __future__ import annotations

import numpy as np

__all__ = ["DEVICE_CATS", "device_spans", "busy_seconds", "top_ops",
           "idle_gaps"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 200   # a device operation's name as reported


def device_spans(events: list) -> list:
    """(start us, end us, name) of every device operation."""
    return [(e["ts"], e["ts"] + e["dur"], e.get("name", ""))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def _union(spans: list) -> list:
    """The merged busy intervals of (start, end, ...) spans."""
    out = []
    for a, b, *_ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(spans: list) -> float:
    """Seconds in which some device operation ran (the union of spans)."""
    return sum(b - a for a, b in _union(spans)) / 1e6


def top_ops(spans: list, n: int = 10) -> list:
    """[[name, seconds]] of the ``n`` device operations with most time."""
    by = {}
    for a, b, name in spans:
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[k[:NAME_CHARS], v]
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: list, spans: list, t0: float, t1: float,
              n: int = 10, looked_at: int = 200) -> list:
    """[[host activity, seconds]]: the device's idle time between ``t0`` and
    ``t1`` (us), in the ``looked_at`` longest gaps, summed by what the host
    was doing at each gap's middle (the stage annotation and the innermost
    host operation open there), the ``n`` largest."""
    busy = _union([s for s in spans if s[1] > t0 and s[0] < t1])
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(max(edges[i], t0), min(edges[i + 1], t1))
            for i in range(0, len(edges), 2)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:looked_at]
    host = [e for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    start = np.array([e["ts"] for e in host], dtype=np.float64)
    end = start + np.array([e["dur"] for e in host], dtype=np.float64)
    stage = np.array([e.get("name", "").startswith("stage:") for e in host],
                     dtype=bool)
    by = {}
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = (start <= mid) & (end > mid)
        name = []
        for sel in (open_ & stage, open_ & ~stage):
            idx = np.flatnonzero(sel)
            if idx.size:
                name.append(host[idx[np.argmax(start[idx])]]["name"][:80])
        key = "/".join(name) or "no host activity"
        by[key] = by.get(key, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
