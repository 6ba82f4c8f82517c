"""Per-command timing/RSS reports — the ``timeUpdate`` analog.

The reference prints user/sys CPU time and max-RSS deltas after every CLI
command (``utils.c:~timeUpdate``, SURVEY.md §3.1 #16).  Here: wall + CPU + RSS
delta lines on stderr, plus optional JSONL metrics (``--metrics``) with the
JAX package's keys, and the device memory torch holds on a CUDA device
(``--devMem``).  A stage on a CUDA device is synchronised before its wall is
read, so the wall covers the device work.
"""

from __future__ import annotations

import json
import resource
import sys
import time

import torch

__all__ = ["StageTimer"]


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

    @property
    def enabled(self) -> bool:
        """Whether any sink consumes stage lines; a silenced timer neither
        synchronises the device nor reads the clocks."""
        return self.log is not None or self.jsonl is not None

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
