#!/usr/bin/env python3
"""Stage walls and device memory of the lane at 20x the bench lane's scale
(16M reads, 1M barcodes, 2 Gb genome: ``bench.make_barcodes_lane_blocked``)
through the library API on one CUDA card, for this tree and other
checkouts in one call.

    python3 scale_ab.py [OTHER_TREE ...] [--dumps] [--shards 4] [--paths]
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

With ``--paths`` it times the paths off the main path instead, each tree
once (other trees first) in a process of its own per path: capped-friend
clustering (``max_friends`` 256) on the lane, and ``build_crib`` and
``crib_report`` on its diploid form (``het_rate`` 0.001, two 2 Gb
haplotypes of 20 FASTA records each) after the default clustering.  A
process still running after ``PATH_LIMIT_S`` seconds is stopped and its
run written down as ``"> 600 s"``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PATH_LIMIT_S = 600

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


PATHS_WORKER = r'''
import json, resource, sys, time
import torch
from hash10x_tpu_torch.crib.crib import build_crib, crib_report
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import load_fqb


class Sink:
    n = 0

    def write(self, s):
        self.n += len(s)


path, what, fastas = sys.argv[1], sys.argv[2], sys.argv[3:]
fqb = load_fqb(path)
eng = Engine(EngineConfig(spec=HashSpec(k=21, w=11, seed=17), table_bits=22,
                          min_count=2, max_count=64, min_friend_share=8,
                          max_friends=256 if what == "friend" else 0),
             "cuda", log=None)
sink = Sink()
held = {}
plan = [("count", lambda: eng.count(fqb)), ("filter", eng.filter),
        ("incidence", lambda: eng.incidence(fqb)), ("cluster", eng.cluster)]
if what == "crib":
    plan += [("cribBuild", lambda: held.setdefault("crib", build_crib(
                 eng.cfg.spec, eng.retained_hashes, fastas))),
             ("cribReport", lambda: crib_report(eng.inc, eng.cluster_labels,
                                                held["crib"], sink))]
stages = {}
for name, fn in plan:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    stages[name] = {"wall_s": time.monotonic() - t0,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps({"stage": name, **stages[name]}), flush=True)
print(json.dumps({"stages": stages, "pairs": eng.inc.n_pairs,
                  "report_bytes": sink.n,
                  "host_rss_peak_gb": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss / 1e6}))
'''


def run_paths(trees, tmp, smi):
    """The --paths runs: (tree, path) per process, other trees first."""
    from hash10x_tpu_torch.bench import (make_barcodes_lane_blocked,
                                         write_fasta_records)
    from hash10x_tpu_torch.io.fqb import save_fqb
    lanes = {"friend": [os.path.join(tmp, "lane20x.fqb")],
             "crib": [os.path.join(tmp, "diploid20x.fqb"),
                      os.path.join(tmp, "h1.fa"), os.path.join(tmp, "h2.fa")]}
    t0 = time.monotonic()
    save_fqb(lanes["friend"][0], make_barcodes_lane_blocked())
    fqb, haps = make_barcodes_lane_blocked(het_rate=0.001,
                                           return_haplotypes=True)
    save_fqb(lanes["crib"][0], fqb)
    for fa, hap in zip(lanes["crib"][1:], haps):
        write_fasta_records(fa, hap, 20)
    del fqb, haps
    print(f"lanes built and written in {time.monotonic() - t0:.1f} s",
          flush=True)
    results = []
    for what, args in lanes.items():
        for tree in trees:
            env = dict(os.environ, PYTHONPATH=tree)
            t0 = time.monotonic()
            try:
                r = subprocess.run(
                    [sys.executable, "-c", PATHS_WORKER, args[0], what,
                     *args[1:]], env=env, cwd=tree, capture_output=True,
                    text=True, timeout=PATH_LIMIT_S)
            except subprocess.TimeoutExpired as e:
                out = e.stdout.decode() if isinstance(e.stdout, bytes) \
                    else (e.stdout or "")
                done = [json.loads(l) for l in out.splitlines()
                        if l.startswith('{"stage"')]
                res = {"stopped": f"> {PATH_LIMIT_S} s",
                       "stages_done": done}
            else:
                if r.returncode:
                    print(r.stderr[-4000:], file=sys.stderr)
                    return None
                res = json.loads(r.stdout.strip().splitlines()[-1])
            res.update(tree=os.path.relpath(tree, ROOT), path=what, card=smi,
                       process_wall_s=time.monotonic() - t0)
            results.append(res)
            print(json.dumps(res), flush=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--dumps", action="store_true")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--paths", action="store_true")
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
    others = [os.path.abspath(t) for t in args.trees]
    order = others + [ROOT, ROOT] + others
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        if args.paths:
            results = run_paths(others + [ROOT], tmp, smi)
            if results is None:
                return 1
        else:
            from hash10x_tpu_torch.bench import make_barcodes_lane_blocked
            from hash10x_tpu_torch.io.fqb import save_fqb
            lane = os.path.join(tmp, "lane20x.fqb")
            t0 = time.monotonic()
            save_fqb(lane, make_barcodes_lane_blocked())
            print(f"lane20x built and written in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
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
