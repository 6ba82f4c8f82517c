#!/usr/bin/env python3
"""Stage walls of the sharded paths on one CUDA card: the 800k-read /
50k-barcode lane of chip_smoke.py through the CLI at --shards 1 (the
single-GPU path), 2 and 4 in one process, and as two processes sharing the
card over gloo (--hosts 2, one shard each).

    python3 shards_bench.py [--runs 3] [--json chiprun_out/shards_bench.json]

Per setting: one warm-up run, ``--runs`` timed runs (stage walls from the
CLI's stage lines: count, filter+incidence, cluster, split, report; with two
processes, process 0's), then one run under the CLI's --profile, whose
trace gives the device's busy time (the union of its kernel, copy and set
intervals) and busy share over that run's stage walls, the five device
operations with the most time, and the exchange: host time inside the
``exchange[count]`` ranges (the send-lane build and the all_to_all of the
count pass) over the count wall.  Prints the card's name and power limit,
one JSON line per setting, and writes them all to ``--json``.  Exits
non-zero without a card.
"""

import argparse
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STAGES = ("count", "filter+incidence", "cluster", "split", "report")


def trace_stats(trace_dir, count_wall, phase_sum):
    """Busy ms, busy share, top device operations and exchange share from
    the one chrome trace the CLI's --profile wrote into ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(paths) != 1:
        raise RuntimeError(f"{trace_dir}: {len(paths)} traces")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name, exchange_us = [], {}, 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        elif e.get("cat") == "user_annotation" \
                and e["name"] == "exchange[count]":
            exchange_us += e["dur"]
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_ms": busy / 1e3, "busy_share": busy / 1e6 / phase_sum,
            "top_device_ms": [[n[:70], us / 1e3] for n, us in top],
            "exchange_ms": exchange_us / 1e3,
            "exchange_share_of_count": exchange_us / 1e6 / count_wall}


def summary(values):
    v = sorted(values)
    return {"median": float(np.median(v)), "min": v[0], "max": v[-1],
            "runs": v}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--json", default=os.path.join(ROOT, "chiprun_out",
                                                   "shards_bench.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("shards_bench: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from hash10x_tpu_torch.cli.main import run
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        reads, bc_ids = CS.make_lane()
        lane = os.path.join(tmp, "lane.fqb")
        CS.write_fqb(lane, reads, bc_ids, CS.N_CODES)
        del reads, bc_ids

        def in_process(argv):
            err = io.StringIO()
            t0 = time.monotonic()
            run(argv, io.StringIO(), err)
            torch.cuda.synchronize()
            return CS.shard_walls(err.getvalue()), time.monotonic() - t0

        def two_processes(argv):
            res = CS.run_hosts(tmp, argv)
            return CS.shard_walls(res[0][1]), res[0][2]

        settings = [("shards1", in_process, []),
                    ("shards2", in_process, ["--shards", "2"]),
                    ("shards4", in_process, ["--shards", "4"]),
                    ("hosts2_gloo", two_processes, [])]
        for name, fn, flags in settings:
            argv = CS.lane_argv(lane, *flags)
            fn(argv)  # warm-up
            walls, clis = [], []
            for _ in range(args.runs):
                w, cli_wall = fn(argv)
                walls.append(w)
                clis.append(cli_wall)
            trace_dir = os.path.join(tmp, f"trace_{name}")
            w, _ = fn(["--profile", trace_dir] + argv)
            rec = {"setting": name, "flags": flags, "card": smi,
                   "stage_walls_s": {s: summary([x[s] for x in walls])
                                     for s in STAGES},
                   "phase_sum_s": summary([sum(x.values()) for x in walls]),
                   "cli_wall_s": summary(clis),
                   "profiled_run_walls_s": w}
            rec.update(trace_stats(trace_dir, w["count"],
                                   sum(w.values())))
            print(json.dumps(rec), flush=True)
            results.append(rec)
    os.makedirs(os.path.dirname(args.json), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
