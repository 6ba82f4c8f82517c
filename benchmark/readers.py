"""Helpers of the per-layer metric readers (``metrics/<name>.py``).  A
reader's ``read(ctx)`` returns a number, or None where it finds nothing to
read; ``ctx`` holds:

* ``passes``: the window's passes, each {"wall_s", "spans" {span name:
  seconds}, "stats" (``Engine.stats`` at the pass's end)};
* ``trace``: the profiled pass, {"spans" [(start us, end us, device
  operation)], "busy_s", "window_s"}, or None;
* ``lane``: {"n_reads", "read_len", "k"} and the facts the cell's reference
  gives, such as ``emitted``, the minimizers it counts in the lane;
* ``config`` and ``traffic``: the cell's files as loaded.
"""

from __future__ import annotations

__all__ = ["span_mean", "stat_mean"]


def span_mean(ctx: dict, name: str):
    """Mean seconds per pass in the span ``name``; None where no pass has
    it."""
    vals = [p["spans"][name] for p in ctx["passes"] if name in p["spans"]]
    return sum(vals) / len(vals) if vals else None


def stat_mean(ctx: dict, key: str):
    """Mean per pass of the engine counter ``key``."""
    vals = [p["stats"][key] for p in ctx["passes"] if key in p["stats"]]
    return sum(vals) / len(vals) if vals else None
