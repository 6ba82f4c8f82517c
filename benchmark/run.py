"""The benchmark of ``hash10x_tpu_torch``: one cell of ``BENCHMARK.json``.

    python3 -m benchmark.run --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

A cell is a configuration (``configs/<name>.json``: the lane's sizes and the
engine's settings) under a traffic mix (``traffic/<name>.json``: the engine
calls of one pass, each inside a named span; the checks that decide
``correct``, each with the outputs it reads and its limit; the name of its
plain reference, ``reference/<name>.py``).  Set-up makes the lane from
``--seed`` (``lane.py``) and runs one cold pass.  The window then runs
passes back to back, each on a fresh ``Engine``, for ``--seconds``: a pass
starts only while the longest pass so far still fits in the time left.
Once it closes, the peak device memory is read, the last pass's outputs go
to the host and the program's state is freed; with ``--trace 1`` one more
pass runs under ``torch.profiler``.  Then the reference works the lane out
again on the device and ``compare.py`` decides ``correct``.  Each metric is
read by ``metrics/<name>.py``: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones.  The last line of standard
output is the result's JSON; the numbers compared, each beside its limit,
end standard error.

Without a CUDA card, with fewer cards than the cell asks for, without the
program, or with JAX or the JAX package loaded once all of that is done,
the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hash10x_tpu")

__all__ = ["load_cell", "reference_of", "forbidden_modules", "run_cell",
           "main"]


class NoResult(Exception):
    """A run that must print no result."""


def load_cell(workload: str, root: Path = ROOT):
    """(manifest, cell, configuration, traffic) of ``workload``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return manifest, cell, cfg, traffic


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_of(name: str):
    """``reference(lane, cfg, device, control)`` of ``reference/<name>.py``."""
    return importlib.import_module(f"{__package__}.reference.{name}") \
        .reference


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def _profiled_pass(system, device) -> tuple:
    """One pass under torch.profiler: (the pass, its reduced trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .trace import busy_seconds, device_spans, idle_gaps, top_ops
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        p = system.run_pass()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    del prof
    spans = device_spans(events)
    marks = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("stage:")]
    t0 = min((e["ts"] for e in marks), default=0.0)
    t1 = max([e["ts"] + e["dur"] for e in marks] + [b for _, b, _ in spans],
             default=t0)
    trace = {"spans": spans, "busy_s": busy_seconds(spans),
             "window_s": p.wall_s,
             "breakdown": {"device_ops": top_ops(spans),
                           "idle_gaps": idle_gaps(events, spans, t0, t1)}}
    del events
    p.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return p, trace


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, root: Path = ROOT, t0: float = T0,
             log=sys.stderr) -> dict:
    """One run of ``workload`` on ``device``: the result's dict, its last
    key ``checks`` ({check: {"value", "limit"}})."""
    import torch

    from .compare import compare
    from .lane import lane_of
    from .program import System, outputs

    manifest, cell, cfg, traffic = load_cell(workload, root)
    checks = traffic["compare"]
    reference = reference_of(traffic["reference"])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    lane = lane_of(cfg, seed)
    system = System(cfg, traffic, lane, device)
    system.run_pass().free()   # the cold pass: the kernel, the allocator
    gc.collect()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    passes, longest = [], 0.0
    start = time.perf_counter()
    while True:
        if passes:
            passes[-1].free()   # the last pass's state goes first
            gc.collect()
        p = system.run_pass(spans=trace)
        passes.append(p)
        longest = max(longest, p.wall_s)
        end = time.perf_counter()
        if end - start + longest > seconds:
            break
    window_s = end - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    reserved = torch.cuda.max_memory_reserved(device) if cuda else 0
    got = [outputs(p, checks, held=True) for p in passes[:-1]]
    got.append(outputs(passes[-1], checks))
    passes[-1].free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    print(f"setup {setup_s:.3f} s, {len(passes)} passes in {window_s:.3f} s"
          f" ({' '.join(f'{p.wall_s:.3f}' for p in passes)}), peak "
          f"{peak / 1e9:.3f} GB allocated, {reserved / 1e9:.3f} GB reserved",
          file=log)

    traced = None
    if trace:
        p, traced = _profiled_pass(system, device)
        got.append(outputs(p, checks, held=True))
        print(f"profiled pass {p.wall_s:.3f} s, device busy "
              f"{traced['busy_s']:.3f} s", file=log)

    r0 = time.perf_counter()
    want, facts = reference(lane, cfg, device)
    if set(want) != set(checks):
        raise ValueError(f"reference {traffic['reference']!r} gives "
                         f"{sorted(want)}, the mix compares {sorted(checks)}")
    if cuda:
        torch.cuda.synchronize(device)
        ref_peak = torch.cuda.max_memory_allocated(device)
    values, failed = compare([g for g in got if g], want)
    del want
    print(f"reference and comparison {time.perf_counter() - r0:.3f} s"
          + (f", peak since the window {ref_peak / 1e9:.3f} GB"
             if cuda else ""), file=log)

    ctx = {"passes": [{"wall_s": p.wall_s, "spans": p.spans,
                       "stats": p.stats} for p in passes],
           "window": {"seconds": window_s, "reads": len(passes) * lane.n_reads,
                      "setup_s": setup_s, "peak_bytes": peak},
           "trace": traced,
           "lane": {"n_reads": lane.n_reads, "read_len": lane.read_len,
                    "k": cfg["k"], **facts},
           "config": cfg, "traffic": traffic}
    metrics = {}
    for m in manifest["per_layer" if trace else "end_to_end"]:
        if not _applies(m, workload):
            continue
        v = _reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else device.type),
           "count": cell["chips"], "memory_peak_bytes": peak}
    limits = {k: c.get("limit", 0) for k, c in checks.items()}
    result = {"correct": all(values[k] <= limits[k] for k in limits),
              "attempted": sum(1 for g in got if g), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {k: {"value": values[k], "limit": limits[k]}
                        for k in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        _, cell, _, _ = load_cell(args.workload)
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoResult(f"{cell['chips']} cards asked for, "
                           f"{torch.cuda.device_count()} present")
        try:
            import hash10x_tpu_torch  # noqa: F401
        except ImportError as e:
            raise NoResult(f"the program is missing: {e}") from e
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0))
        found = forbidden_modules()
        if found:
            raise NoResult("loaded by the run: " + ", ".join(found))
    except NoResult as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
