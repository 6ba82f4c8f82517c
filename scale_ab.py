#!/usr/bin/env python3
"""Stage walls and device memory of the lane at 20x the bench lane's scale
(16M reads, 1M barcodes, 2 Gb genome: ``bench.make_barcodes_lane_blocked``)
through the library API on one CUDA card, for this tree and other
checkouts in one call.

    python3 scale_ab.py [OTHER_TREE ...] [--dumps] [--shards 4]
                        [--json chiprun_out/scale_ab.json]

The lane is built once by this tree and written as an .fqb.  Each tree
then runs it in a process of its own (``PYTHONPATH`` set to the tree), in
the order other trees, this tree, this tree, other trees: count, info,
filter, incidence, cluster, split and report (and, with ``--dumps``, the
--writeCounts and --writeClusters text into a counting sink), each stage
synchronised, with its wall, peak device memory (``max_memory_allocated``,
reset at the stage's start), ``memory_reserved`` after it and the table
flushes during it; then the steps, flushes, incidence pairs, the clustering
figures the tree records (``cluster/sparse.py`` ``STATS``, if it has them)
and the process's peak host RSS.  Prints the card's name and power limit
and one JSON line per run, and writes them all to ``--json``.  Exits
non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

WORKER = r'''
import io, json, resource, sys, time
import torch
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import load_fqb
from hash10x_tpu_torch.table import sorted_table as st
from hash10x_tpu_torch.cluster import sparse as SP
from hash10x_tpu_torch.cluster import sparse_dist as SPD


class Sink:
    n = 0

    def write(self, s):
        self.n += len(s)


path, dumps, shards = sys.argv[1], sys.argv[2] == "1", int(sys.argv[3])
fqb = load_fqb(path)
eng = Engine(EngineConfig(spec=HashSpec(k=21, w=11, seed=17), table_bits=22,
                          min_count=2, max_count=64, min_friend_share=8,
                          n_shards=shards), "cuda", log=None)
sink = Sink()
plan = [("count", lambda: eng.count(fqb)), ("info", lambda: eng.info(sink)),
        ("filter", eng.filter), ("incidence", lambda: eng.incidence(fqb)),
        ("cluster", eng.cluster), ("split", eng.split),
        ("report", lambda: eng.report(sink))]
if dumps:
    plan += [("write_counts", lambda: eng.write_counts(sink)),
             ("write_clusters", lambda: eng.write_clusters(sink))]
stages = {}
for name, fn in plan:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f0 = st.FLUSHES
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    stages[name] = {"wall_s": time.monotonic() - t0,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "reserved_gb": torch.cuda.memory_reserved() / 1e9,
                    "flushes": st.FLUSHES - f0}
cl = getattr(SPD if shards > 1 else SP, "STATS", {})
print(json.dumps({"stages": stages, "stats": eng.stats,
                  "pairs": eng.inc.n_pairs, "report_bytes": sink.n,
                  "cluster": cl,
                  "host_rss_peak_gb": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss / 1e6}))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--dumps", action="store_true")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--json", default=os.path.join(ROOT, "chiprun_out",
                                                   "scale_ab.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scale_ab: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    sys.path.insert(0, ROOT)
    from hash10x_tpu_torch.bench import make_barcodes_lane_blocked
    from hash10x_tpu_torch.io.fqb import save_fqb
    others = [os.path.abspath(t) for t in args.trees]
    order = others + [ROOT, ROOT] + others
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        lane = os.path.join(tmp, "lane20x.fqb")
        t0 = time.monotonic()
        save_fqb(lane, make_barcodes_lane_blocked())
        print(f"lane20x built and written in {time.monotonic() - t0:.1f} s",
              flush=True)
        for tree in order:
            env = dict(os.environ, PYTHONPATH=tree)
            r = subprocess.run(
                [sys.executable, "-c", WORKER, lane, "1" if args.dumps
                 else "0", str(args.shards)], env=env, cwd=tree,
                capture_output=True, text=True, timeout=1800)
            if r.returncode:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            res = json.loads(r.stdout.strip().splitlines()[-1])
            res.update(tree=os.path.relpath(tree, ROOT), card=smi,
                       shards=args.shards)
            results.append(res)
            print(json.dumps(res), flush=True)
    os.makedirs(os.path.dirname(args.json), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
