"""The system under test: ``hash10x_tpu_torch``'s ``Engine`` driven through
one pass of a traffic mix on a lane, with the benchmark's spans around its
calls.  Everything the benchmark takes from the program passes through
here: the engine, its ``stats`` counters and the outputs judged."""

from __future__ import annotations

import io
import time
from dataclasses import dataclass, field

import numpy as np
import torch

import hash10x_tpu_torch.cluster.sparse as sparse
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import Fqb

from .lane import Lane

__all__ = ["Pass", "System", "source", "outputs"]

# counters of the program's modules that a pass's ``stats`` take up: name
# -> (the module's dict, its key); each is dropped before a pass, so a pass
# that does not set it reports none
COUNTERS = {"propagation_rounds": (sparse.STATS, "rounds")}

# configuration keys that set EngineConfig fields of the same name
ENGINE_KEYS = ("mode", "table_bits", "batch_reads", "count_mode",
               "min_friend_share", "cluster_mode", "max_friends",
               "flush_batches")


@dataclass
class Pass:
    """One pass: its wall, a span per traffic ``span`` name, the engine's
    ``stats`` at the end, the text written to the sink, what the stages
    that name a ``keep`` returned, and the engine itself."""
    wall_s: float
    spans: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    text: str = ""
    kept: dict = field(default_factory=dict)
    engine: Engine = None

    def free(self) -> None:
        """Drop what the pass holds on the device: the engine, and kept
        values other than host arrays."""
        self.engine = None
        self.kept = {k: v for k, v in self.kept.items()
                     if isinstance(v, np.ndarray)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """A fresh engine per pass on ``lane``, with the configuration ``cfg``
    and the traffic mix ``traffic`` (its ``engine`` overrides and its
    ``stages``: calls of ``Engine`` methods with the arguments ``lane`` or
    ``sink``, each inside the span it names, its return value kept under
    ``keep`` where the stage names one)."""

    def __init__(self, cfg: dict, traffic: dict, lane: Lane,
                 device: torch.device):
        kw = {k: cfg[k] for k in ENGINE_KEYS if k in cfg}
        kw.update(traffic.get("engine", {}))
        self.engine_config = EngineConfig(
            spec=HashSpec(k=cfg["k"], w=cfg["w"], seed=cfg["hash_seed"]),
            min_count=cfg["band"][0], max_count=cfg["band"][1], **kw)
        self.stages = traffic["stages"]
        self.device = device
        self.fqb = Fqb(packed=lane.packed, lengths=lane.lengths,
                       barcode_ids=lane.barcode_ids,
                       barcode_keys=np.arange(lane.n_codes, dtype=np.uint32),
                       read_len=lane.read_len)

    def run_pass(self, spans: bool = False) -> Pass:
        """One pass.  With ``spans`` each stage is timed on the host clock
        with the device synchronised on both sides; without, the pass is
        timed whole (its report ends in a copy to the host)."""
        dev = self.device
        for d, key in COUNTERS.values():
            d.pop(key, None)
        t0 = time.perf_counter()
        eng = Engine(self.engine_config, dev, log=None)
        sink = io.StringIO()
        args = {"lane": self.fqb, "sink": sink}
        p = Pass(0.0, engine=eng)
        for st in self.stages:
            call = getattr(eng, st["call"])
            with torch.profiler.record_function("stage:" + st["span"]):
                if spans:
                    _sync(dev)
                    a = time.perf_counter()
                got = call(*[args[x] for x in st.get("args", ())])
                if spans:
                    _sync(dev)
                    p.spans[st["span"]] = (p.spans.get(st["span"], 0.0)
                                           + time.perf_counter() - a)
            if "keep" in st:
                p.kept[st["keep"]] = got
        _sync(dev)
        p.wall_s = time.perf_counter() - t0
        p.stats = dict(eng.stats)
        p.stats.update({name: d[key] for name, (d, key) in COUNTERS.items()
                        if key in d})
        p.text = sink.getvalue()
        return p


def _host(x):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.int64)
    return x


def source(p: Pass, name: str):
    """One part of a pass's outputs, on the host: ``sink`` is the text the
    pass wrote, a name that a stage keeps is what that stage returned, and
    any other name is a dotted attribute path on the pass's engine (None
    where the engine has no such thing)."""
    if name == "sink":
        return p.text
    if name in p.kept:
        return _host(p.kept[name])
    x = p.engine
    for attr in name.split("."):
        x = getattr(x, attr, None)
    return _host(x)


def outputs(p: Pass, checks: dict, held: bool = False) -> dict:
    """{check: [part]} of pass ``p`` for the traffic's ``compare`` entries
    ``checks`` ({check: {"outputs": [source], "limit": n}}); with ``held``,
    only the checks whose every source a freed pass still holds (the sink
    and kept host arrays)."""
    return {name: [source(p, s) for s in c["outputs"]]
            for name, c in checks.items()
            if not held or all(s == "sink" or s in p.kept
                               for s in c["outputs"])}
