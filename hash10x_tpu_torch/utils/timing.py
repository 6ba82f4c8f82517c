"""Per-command timing/RSS reports — the ``timeUpdate`` analog.

The reference prints user/sys CPU time and max-RSS deltas after every CLI
command (``utils.c:~timeUpdate``, SURVEY.md §3.1 #16).  Here: wall + CPU + RSS
delta lines on stderr, plus the device memory that torch holds when the
engine runs on a CUDA device.  A stage on a CUDA device is synchronised
before its wall is read, so the wall covers the device work.
"""

from __future__ import annotations

import resource
import sys
import time

import torch

__all__ = ["StageTimer"]


class StageTimer:
    def __init__(self, log=sys.stderr, device: torch.device = None):
        self.log = log
        self.device = torch.device(device) if device is not None else None
        self._last_wall = time.monotonic()
        self._last_ru = resource.getrusage(resource.RUSAGE_SELF)

    def _on_cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def stage(self, label: str) -> None:
        if self._on_cuda():
            torch.cuda.synchronize(self.device)
        now = time.monotonic()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        wall = now - self._last_wall
        user = ru.ru_utime - self._last_ru.ru_utime
        syst = ru.ru_stime - self._last_ru.ru_stime
        rss_mb = ru.ru_maxrss / 1024.0
        dev_txt = ""
        if self._on_cuda():
            dev_txt = (f" deviceMem "
                       f"{torch.cuda.memory_allocated(self.device) / 1e6:.0f}MB")
        if self.log is not None:
            self.log.write(f"[{label}] wall {wall:.3f}s user {user:.2f}s "
                           f"sys {syst:.2f}s maxRSS {rss_mb:.0f}MB{dev_txt}\n")
        self._last_wall = now
        self._last_ru = ru
