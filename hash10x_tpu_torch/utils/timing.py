"""Per-command timing/RSS reports — the ``timeUpdate`` analog — and the
spans and counters recorded inside the engine.

The reference prints user/sys CPU time and max-RSS deltas after every CLI
command (``utils.c:~timeUpdate``, SURVEY.md §3.1 #16).  Here: wall + CPU + RSS
delta lines on stderr, plus optional JSONL metrics (``--metrics``) with the
JAX package's keys, and the device memory torch holds on a CUDA device
(``--devMem``).  A stage on a CUDA device is synchronised before its wall is
read, so the wall covers the device work.

Spans and counters (always on, stage lines or not): ``StageTimer.span(name)``
times a block on the host clock (``time.perf_counter``) and, with
``device=True`` on a CUDA device, on the stream current when it begins: a
pair of timing events whose distance is the stream's seconds between the two
marks, idle time inside the span included (resolved events go back to a pool
of the process, which every timer draws from).
Under ``torch.profiler`` a span also opens a ``record_function`` of its name,
so it lies on the profiler's timeline.  ``StageTimer.add(name, n)`` adds to a
counter; ``StageTimer.add_device(name, x)`` adds a device scalar to one
without reading it: the sum stays on the device until the counters are
read.  A span adds no synchronisation, no device allocation and no read
of a device value: its events are resolved (``Event.query``, then
``elapsed_time``) when the outermost span closes or the totals are read,
and an event the stream has not reached yet stays for a later read.  Names
never begin with ``stage:``, a prefix the benchmark's stage ranges own.

Host waits: :func:`wait` wraps each statement that makes the host wait
for the card (a read of a device value, a shape that depends on device
data, a host-device copy that is not ``non_blocking``), named after its
site.  It adds its synchronisations to the counter ``host_waits`` and
records the host-clock span ``wait.<site>``, whose ``n`` counts those
synchronisations, under the span that is open; it takes no stream clock.
The same statements wait on the CPU too (there they read host memory), so
the counts do not depend on the device.

While one of its spans is open a timer is the current one, and code below
the engine records through this module's :func:`span`, :func:`wait` and
:func:`add`, which do nothing while no timer is current (a table flushed
outside an engine records nothing).  :func:`recording` makes another
timer, or none, current for a block.
"""

from __future__ import annotations

import contextlib
import json
import resource
import sys
import time

import torch

__all__ = ["StageTimer", "span", "wait", "add", "add_device", "recording",
           "kernel_device_ms"]

_current = None   # the timer whose span is open innermost, or None
_NULL = contextlib.nullcontext()
_FREE = {}   # device -> timing events of resolved spans, for reuse
_STREAMS = {}   # (stream id, device index, device type) -> torch's Stream
# the event class's base: its record and elapsed_time called directly,
# without the Python wrappers of torch.cuda.Event (~0.4 µs each)
_EVENT = torch.cuda.Event.__bases__[0]


def span(name: str, device: bool = False):
    """A span of the current timer (see :meth:`StageTimer.span`); nothing
    while no timer is current."""
    t = _current
    return _NULL if t is None else t.span(name, device)


def wait(site: str, n: int = 1):
    """A context manager around a block that makes the host wait for the
    card ``n`` times: adds ``n`` to the current timer's counter
    ``host_waits`` and records the block as the host-clock span
    ``wait.<site>`` under the span open when it begins, its ``n`` counting
    the waits.  It opens no span of its own and takes no stream clock.
    Nothing while no timer is current."""
    t = _current
    return _NULL if t is None else _Wait(t, "wait." + site, n)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the current timer's counter ``name``, if a timer is
    current."""
    t = _current
    if t is not None:
        t.add(name, n)


def add_device(name: str, x: torch.Tensor) -> None:
    """Add the device scalar ``x`` to the current timer's counter ``name``
    (see :meth:`StageTimer.add_device`), if a timer is current."""
    t = _current
    if t is not None:
        t.add_device(name, x)


@contextlib.contextmanager
def recording(timer):
    """Make ``timer`` (a ``StageTimer``, or None: nothing records) the
    current timer for the block."""
    global _current
    prev, _current = _current, timer
    try:
        yield timer
    finally:
        _current = prev


def _current_stream(device: torch.device):
    """``torch.cuda.current_stream(device)``, without making a new Stream
    object each call (that took 5.4 of a device span's microseconds of
    host time on an H100 host): the stream's ids, read from torch, key a
    Stream kept for them."""
    key = torch._C._cuda_getCurrentStream(
        device.index if device.index is not None
        else torch._C._cuda_getDevice())
    s = _STREAMS.get(key)
    if s is None:
        s = _STREAMS[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return s


class _Span:
    """One open span of ``timer`` (see :meth:`StageTimer.span`)."""

    __slots__ = ("timer", "name", "cuda", "key", "prev", "rf", "stream", "e0",
                 "t0", "child")

    def __init__(self, timer, name: str, cuda: bool):
        self.timer, self.name, self.cuda = timer, name, cuda

    def __enter__(self):
        global _current
        t = self.timer
        self.prev, _current = _current, t
        self.key = (self.name, t._open[-1].name if t._open else None)
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.cuda:
            self.stream = _current_stream(t.device)
            self.e0 = t._event()
            _EVENT.record(self.e0, self.stream)
        t._open.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _current
        dt = time.perf_counter() - self.t0
        t = self.timer
        t._open.pop()
        r = t._spans.get(self.key)
        if r is None:   # [n, host s, children's host s, device s or None]
            r = t._spans[self.key] = [0, 0.0, 0.0,
                                      0.0 if self.cuda else None]
        r[0] += 1
        r[1] += dt
        r[2] += self.child
        if t._open:
            t._open[-1].child += dt
        if self.cuda:
            e1 = t._event()
            _EVENT.record(e1, self.stream)
            t._pending.append((r, self.e0, e1))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _current = self.prev
        if not t._open:
            t._resolve()
        return False


class _Wait:
    """One host wait of ``timer`` (see :func:`wait`): the counter and the
    span record written directly, with no open-span entry, no event and
    no stream."""

    __slots__ = ("timer", "name", "n", "rf", "t0")

    def __init__(self, timer, name: str, n: int):
        self.timer, self.name, self.n = timer, name, n

    def __enter__(self):
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        t = self.timer
        c = t.counters
        c["host_waits"] = c.get("host_waits", 0) + self.n
        parent = t._open[-1] if t._open else None
        key = (self.name, parent.name if parent is not None else None)
        r = t._spans.get(key)
        if r is None:
            r = t._spans[key] = [0, 0.0, 0.0, None]
        r[0] += self.n
        r[1] += dt
        if parent is not None:
            parent.child += dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class StageTimer:
    def __init__(self, log=sys.stderr, jsonl_path=None, device_mem=False,
                 device: torch.device = None):
        self.log = log
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None
        self.device_mem = device_mem
        self.device = torch.device(device) if device is not None else None
        self._last_wall = time.monotonic()
        self._last_ru = resource.getrusage(resource.RUSAGE_SELF)
        self._t0 = self._last_wall
        self._open = []   # the open spans, innermost last
        self.clear()

    @property
    def enabled(self) -> bool:
        """Whether any sink consumes stage lines; a silenced timer's
        ``stage`` neither synchronises the device nor reads the clocks."""
        return self.log is not None or self.jsonl is not None

    # -- spans and counters ----------------------------------------------------

    def span(self, name: str, device: bool = False) -> _Span:
        """A context manager timing its block as the span ``name``, whose
        parent is the span open when it begins.  ``device``: on a CUDA
        device, also the current stream's seconds between its marks (never
        inside a CUDA graph capture, whose stream records no timing
        event); a pair of events costs tens of microseconds of host time,
        so only spans whose ``device_s`` is read take it."""
        if name.startswith("stage:"):
            raise ValueError(f"span {name!r}: the 'stage:' prefix is the "
                             "benchmark's")
        return _Span(self, name, device and self._on_cuda())

    def add(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        self.counters[name] = self.counters.get(name, 0) + n

    def add_device(self, name: str, x: torch.Tensor) -> None:
        """Add the integer scalar tensor ``x`` to the counter ``name``
        without reading it: the sum is kept on ``x``'s device (an
        operation in stream order, so a CUDA graph can record it) and read
        once, when the counters are read (:meth:`counter_totals`)."""
        x = x.reshape(()).to(torch.int64)
        prev = self.device_counters.get(name)
        self.device_counters[name] = x if prev is None else prev + x

    def counter_totals(self) -> dict:
        """The counters by name, those summed on the device read back
        (one synchronisation where there are any)."""
        out = dict(self.counters)
        for name, x in self.device_counters.items():
            out[name] = out.get(name, 0) + int(x)
        return out

    def clear(self) -> None:
        """Forget every span and counter recorded so far."""
        # (name, parent) -> [n, host s, children's host s, device s or None]
        self._spans = {}
        self._pending = []   # (record, start event, end event)
        self.counters = {}
        self.device_counters = {}   # name -> a device scalar (add_device)
        self._mark = ({}, {})   # the totals at the last JSONL record

    def _event(self) -> torch.cuda.Event:
        """A timing event: one a resolved span gave back, or a new one."""
        free = _FREE.get(self.device)
        return (free.pop() if free
                else torch.cuda.Event(enable_timing=True))

    def _resolve(self) -> None:
        """Add the stream seconds of every span whose end event the stream
        has passed (``query`` does not wait), and take its events back;
        keep the others."""
        left = []
        free = _FREE.setdefault(self.device, [])
        for r, e0, e1 in self._pending:
            if e1.query():
                r[3] += _EVENT.elapsed_time(e0, e1) / 1e3
                free += (e0, e1)
            else:
                left.append((r, e0, e1))
        self._pending = left

    def spans(self) -> list:
        """One record per (name, parent): {"name", "parent", "n" (the waits
        of a ``wait.<site>`` record), "host_s", "self_s" (host seconds
        outside its child spans and waits), "device_s" (CUDA spans)}."""
        self._resolve()
        out = []
        for (name, parent), (n, host, child, dev) in self._spans.items():
            rec = {"name": name, "parent": parent, "n": n, "host_s": host,
                   "self_s": host - child}
            if dev is not None:
                rec["device_s"] = dev
            out.append(rec)
        return out

    def span_totals(self, roots: bool = True) -> dict:
        """{name: {"host_s", "device_s" (CUDA spans), "n"}} over every
        parent; without ``roots``, of the spans opened inside another
        only."""
        out = {}
        for r in self.spans():
            if not roots and r["parent"] is None:
                continue
            d = out.setdefault(r["name"], {"host_s": 0.0, "n": 0})
            d["host_s"] += r["host_s"]
            d["n"] += r["n"]
            if "device_s" in r:
                d["device_s"] = d.get("device_s", 0.0) + r["device_s"]
        return out

    def stats(self) -> dict:
        """The counters by name and, for each span name N, ``N.host_s``,
        ``N.device_s`` (CUDA spans) and ``N.n``, as one flat dict."""
        out = self.counter_totals()
        for name, d in self.span_totals().items():
            for k, v in d.items():
                out[f"{name}.{k}"] = v
        return out

    def _since_mark(self):
        """(spans, counters) recorded since the last JSONL record.  Spans
        opened inside another only: a stage's own span, if it has one,
        closes after its line, and its wall is the line's."""
        tot, cnt = self.span_totals(roots=False), self.counter_totals()
        t0, c0 = self._mark
        self._mark = (tot, cnt)
        spans = {}
        for name, d in tot.items():
            p = t0.get(name, {})
            if d["n"] > p.get("n", 0):
                spans[name] = {k: (v - p.get(k, 0) if k == "n"
                                   else round(v - p.get(k, 0.0), 6))
                               for k, v in d.items()}
        return spans, {k: v - c0.get(k, 0) for k, v in cnt.items()
                       if v != c0.get(k, 0)}

    # -- stage lines -------------------------------------------------------------

    def _on_cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _device_mb(self):
        """``torch.cuda.memory_allocated`` in MB (the tensors torch holds on
        the device, not the caching allocator's reserve), or None off CUDA."""
        if not self._on_cuda():
            return None
        return torch.cuda.memory_allocated(self.device) / 1e6

    def stage(self, label: str) -> None:
        if not self.enabled:
            return
        if self._on_cuda():
            torch.cuda.synchronize(self.device)
        now = time.monotonic()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        wall = now - self._last_wall
        user = ru.ru_utime - self._last_ru.ru_utime
        syst = ru.ru_stime - self._last_ru.ru_stime
        rss_mb = ru.ru_maxrss / 1024.0
        dev_mb = self._device_mb() if self.device_mem else None
        dev_txt = f" HBM {dev_mb:.0f}MB" if dev_mb is not None else ""
        if self.log is not None:
            self.log.write(f"[{label}] wall {wall:.3f}s user {user:.2f}s "
                           f"sys {syst:.2f}s maxRSS {rss_mb:.0f}MB{dev_txt}\n")
        if self.jsonl is not None:
            rec = {
                "stage": label, "wall_s": round(wall, 4),
                "user_s": round(user, 4), "sys_s": round(syst, 4),
                "max_rss_mb": round(rss_mb, 1),
                "t_total_s": round(now - self._t0, 4)}
            if dev_mb is not None:
                rec["hbm_in_use_mb"] = round(dev_mb, 1)
            rec["spans"], rec["counters"] = self._since_mark()
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        self._last_wall = now
        self._last_ru = ru

    def total(self) -> float:
        return time.monotonic() - self._t0

    def close(self) -> None:
        """Close the JSONL file; later stages write to stderr only."""
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None


def kernel_device_ms(launch, n: int = 20) -> float:
    """Device time per launch of ``launch()`` on the current CUDA device:
    CUDA events around n launches queued behind a spin kernel, so that they
    run back to back on the card.  The spin must still be running when the
    last launch is queued, else the events would hold host gaps; it is
    lengthened until it is."""
    launch()
    torch.cuda.synchronize()
    spin = 2_000_000  # cycles, ~1 ms
    for _ in range(8):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        e0.record()
        for _ in range(n):
            launch()
        e1.record()
        queued_in_time = not e0.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return e0.elapsed_time(e1) / n
        spin *= 4
    raise RuntimeError("the card ran the timed launches faster than the "
                       "host queued them")
