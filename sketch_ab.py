#!/usr/bin/env python3
"""Time this checkout's port against another checkout's on one CUDA card:
the sketch kernel per route and the lanes end to end, in alternating
processes.

    mkdir -p _archive/parent
    git archive <commit> | tar -x -C _archive/parent
    python3 sketch_ab.py _archive/parent [--rounds 3] [--crib | --wide]

With --wide it times only the minimizer route for windows wider than the
tile kernel's (w > 4,096), no lanes: the device and wrapper ms at 33 x
12,288 with w = 4,097 (dense), at 4,096 x 32,768 genome rows with w = 5,000
(dense and C = 64), and the tile kernel at w = 4,096 beside w = 4,097 on
those rows, each after checking the kernel against ``sketch_plain`` (all
rows at 33 x 12,288, the first 16 rows at 4,096 x 32,768).

Otherwise it builds chip_smoke.py's 800k-read / 50k-barcode lane once (and, with
--crib, its phase-11 diploid lane with two 100 Mb haplotype FASTAs), then
runs one worker process per tree in the order other, this, this, other,
other, this, ... (2 x rounds workers).  Each worker imports the package of
its tree and measures:

- per route (read batches B=4096, L=150, k=21 in minimizer mode with the
  engine's C, modimizer m=11 and syncmer s=11; one crib row group, kmer
  mode dense, 4096 x 32,768): the wrapper's ms per call (CUDA events over
  back-to-back ``sketch`` calls, chip_smoke.py's "ms") and the kernel's
  device ms per launch (chip_smoke.kernel_device_ms, through the tree's
  ctypes library into preallocated outputs), after checking the kernel
  against ``sketch_plain`` on all four outputs;
- per lane (minimizer, --syncmer 11, --modimizer; with --crib the diploid
  lane through --cribBuild): one warm-up run, then two timed runs (the CLI
  wall and the sum of its stage walls), then one run under torch.profiler
  (the device's busy time, the union of its kernel and copy intervals; the
  sketch kernel's events, launches and device ms; the five kernels with
  the most device ms).

Prints the card's name and power limit, one JSON line per worker, and one
JSON summary line per metric: each side's values, median and range, and
whether the ranges overlap.  Exits non-zero without a card, or when a
worker fails.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def chip_smoke():
    """This checkout's chip_smoke.py as a module (a tree on sys.path may
    hold its own)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lane_argv(CS, lanes):
    base = ["-k", str(CS.K), "-w", str(CS.W), "-r", str(CS.SEED), "-B", "22",
            "--minCount", "2", "--maxCount", "64", "--friendShare", "8"]
    report = ["--readFQB", lanes["lane"], "--hashInfo", "--hashDist",
              "--codeClusters", "--clusterSplit", "--clusterReport"]
    cells = {f"{mode} 800k": base + flags + report
             for mode, flags in (("minimizer", []),
                                 ("syncmer", ["--syncmer", "11"]),
                                 ("modimizer", ["--modimizer"]))}
    if "crib" in lanes:
        cells["crib diploid 800k"] = base + [
            "--readFQB", lanes["crib"], "--codeClusters", "--cribBuild",
            *lanes["fasta"]]
    return cells


def make_lanes(CS, tmp, crib):
    lanes = {"lane": os.path.join(tmp, "lane.fqb")}
    reads, bc_ids = CS.make_lane()
    CS.write_fqb(lanes["lane"], reads, bc_ids, CS.N_CODES)
    del reads, bc_ids
    if crib:
        from hash10x_tpu_torch.io.fqb import from_read_batch, save_fqb
        from hash10x_tpu_torch.io.sim import SimConfig, simulate
        sim = simulate(SimConfig(
            genome_len=CS.CRIB_GENOME, n_barcodes=CS.N_CODES,
            molecules_per_barcode=1, molecule_len=30_000,
            reads_per_molecule=CS.N_READS // CS.N_CODES,
            read_len=CS.READ_LEN, het_rate=0.001))
        lanes["crib"] = os.path.join(tmp, "diploid.fqb")
        save_fqb(lanes["crib"], from_read_batch(sim.reads))
        lanes["fasta"] = [os.path.join(tmp, f"h{i + 1}.fa") for i in range(2)]
        CS.write_fasta(lanes["fasta"][0], b"hap1", sim.genome)
        CS.write_fasta(lanes["fasta"][1], b"hap2", sim.genome_hap1)
    return lanes


def raw_launcher(torch, MK, seqhash, spec, c, ln, kw):
    """One launch of the tree's kernel library into preallocated outputs,
    through its C interface.  The tile routes take the same arguments in
    every tree of the port: the three scratch arguments of the wide route
    (earlier a ring's two pointers and its mask) are null or 0 here."""
    lib = MK.build()
    B, L = c.shape
    mode, C = kw["mode"], kw.get("compact_to", 0)
    R = C or L - spec.k + 1
    out = [torch.empty((B, R), dtype=dt, device=c.device)
           for dt in (torch.int64, torch.uint8)]
    out.append(torch.empty(B, dtype=torch.int32, device=c.device))
    modulus = (kw.get("m", 0) or spec.w) if mode == "modimizer" else 0
    s = kw.get("syncmer_s", 0)
    sub = seqhash.smer_spec(spec, s) if mode == "syncmer" else None
    args = (c.data_ptr(), ln.data_ptr(), B, L, spec.k, spec.w, spec.factor1,
            spec.shift1, MK.KERNEL_MODES[mode], modulus, s if sub else 0,
            sub.factor1 if sub else 0, sub.shift1 if sub else 0, C, None,
            None, 0, *(t.data_ptr() for t in out),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        if lib.h10x_sketch(*args) != 0:
            raise RuntimeError("sketch kernel launch failed")
    return launch


def wrapper_ms(torch, fn, n, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def profile_run(torch, MK, run, argv):
    """(busy ms, sketch kernel events, their device ms, launches counted by
    the wrapper, the five kernels with the most device ms) of one CLI run
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    MK.LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(argv, io.StringIO(), io.StringIO())
        torch.cuda.synchronize()
    spans, n_sk, sk_ms, by_name = [], 0, 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
        if "sketch_kernel" in e.name:
            n_sk += 1
            sk_ms += e.device_time_total / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (busy / 1e3, n_sk, sk_ms, MK.LAUNCHES,
            [[name[:60], ms] for name, ms in top])


def wide_worker(tree, torch, CS, MK, HashSpec):
    """--wide: the w > 4,096 route's device and wrapper ms (see the module
    docstring), through the tree's own launcher and sketch."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(CS.SEED + 5)
    result = {"tree": tree}

    def route(name, spec, c, ln, C, rows, n=5):
        got = MK.sketch(spec, c[rows], ln[rows], compact_to=C)
        ref = MK.sketch_plain(spec, c[rows], ln[rows], compact_to=C)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise SystemExit(f"sketch_ab: {tree}: {name} kernel != plain")
        del got, ref
        result[f"{name} wrapper_ms"] = wrapper_ms(
            torch, lambda: MK.sketch(spec, c, ln, compact_to=C), n, warm=1)
        result[f"{name} device_ms"] = CS.kernel_device_ms(
            torch, MK.launcher(spec, c, ln, compact_to=C), n)

    codes, lengths = CS._tile_rows(rng, 33, 3 * 4096, CS.K, 4097, "minimizer")
    c, ln = (torch.from_numpy(x).to(dev) for x in (codes, lengths))
    route("wide 33x12288 w4097 dense", HashSpec(k=CS.K, w=4097, seed=CS.SEED),
          c, ln, 0, slice(None))
    codes, lengths = CS._genome_rows(rng, 4096, 1 << 15, CS.K)
    c, ln = (torch.from_numpy(x).to(dev) for x in (codes, lengths))
    del codes
    spec = HashSpec(k=CS.K, w=5000, seed=CS.SEED)
    for C in (0, 64):
        route(f"wide 4096x32768 w5000 C{C}", spec, c, ln, C, slice(0, 16))
    ln.fill_(1 << 15)
    for w in (4096, 4097):
        route(f"{'tile' if w == 4096 else 'wide'} 4096x32768 w{w} dense",
              HashSpec(k=CS.K, w=w, seed=CS.SEED), c, ln, 0, slice(0, 16))
    print(json.dumps(result), flush=True)


def worker(tree, lanes_json):
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    CS = chip_smoke()
    from hash10x_tpu_torch.cli.main import run
    from hash10x_tpu_torch.core import seqhash
    from hash10x_tpu_torch.crib.crib import _ROWS
    from hash10x_tpu_torch.engine import Engine, EngineConfig
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.kernels import minimizer as MK
    lanes = json.loads(lanes_json)
    if lanes.get("wide"):
        wide_worker(tree, torch, CS, MK, HashSpec)
        return
    dev = torch.device("cuda")
    rng = np.random.default_rng(CS.SEED)
    spec = HashSpec(k=CS.K, w=CS.W, seed=CS.SEED)
    codes, lengths = CS._batch(rng, CS.PARITY_B, CS.READ_LEN, CS.K, CS.W)
    lengths[:] = CS.READ_LEN
    reads = (torch.from_numpy(codes).to(dev),
             torch.from_numpy(lengths).to(dev))
    L = 1 << 15
    codes, lengths = CS._genome_rows(rng, _ROWS["cuda"], L, CS.K)
    lengths[:] = L
    rows = (torch.from_numpy(codes).to(dev),
            torch.from_numpy(lengths).to(dev))
    routes = []
    for mode, kw in (("minimizer", {}), ("modimizer", {"m": CS.W}),
                     ("syncmer", {"syncmer_s": 11})):
        cfg = EngineConfig(spec=spec, mode=mode, modulus=kw.get("m", 0),
                           syncmer_s=kw.get("syncmer_s", 0))
        C = Engine(cfg, "cuda", log=None)._compact_rows(CS.READ_LEN - CS.K + 1)
        routes.append((mode, reads, dict(mode=mode, compact_to=C, **kw), 50))
    routes.append(("crib", rows, dict(mode="kmer"), 5))
    result = {"tree": tree}
    for name, (c, ln), kw, n in routes:
        got = MK.sketch(spec, c, ln, **kw)
        ref = MK.sketch_plain(spec, c, ln, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise SystemExit(f"sketch_ab: {tree}: {name} kernel != plain")
        del got, ref
        result[f"{name} wrapper_ms"] = wrapper_ms(
            torch, lambda: MK.sketch(spec, c, ln, **kw), n)
        result[f"{name} device_ms"] = CS.kernel_device_ms(
            torch, raw_launcher(torch, MK, seqhash, spec, c, ln, kw),
            min(n, 20))
    del reads, rows
    torch.cuda.empty_cache()
    for cell, argv in lane_argv(CS, lanes).items():
        run(argv, io.StringIO(), io.StringIO())
        for i in range(2):
            err = io.StringIO()
            t0 = time.monotonic()
            run(argv, io.StringIO(), err)
            torch.cuda.synchronize()
            result.setdefault(f"{cell} wall_s", []).append(
                time.monotonic() - t0)
            result.setdefault(f"{cell} phase_s", []).append(
                sum(CS.stage_walls(err.getvalue()).values()))
        busy, n_sk, sk_ms, launches, top = profile_run(torch, MK, run, argv)
        result[f"{cell} busy_ms"] = busy
        result[f"{cell} sketch_ms"] = sk_ms
        result[f"{cell} sketch_events/launches"] = [n_sk, launches]
        result[f"{cell} top_device_ms"] = top
    print(json.dumps(result), flush=True)


def summary(results, other, this):
    keys = [k for k in results[0] if k != "tree"]
    for key in keys:
        runs = {tag: [r[key] for r in results if r["tree"] == tree]
                for tag, tree in (("other", other), ("this", this))}
        if key.endswith(("events/launches", "top_device_ms")):
            print(json.dumps({"metric": key, **runs}))
            continue
        side = {t: [x for v in vs for x in (v if isinstance(v, list) else [v])]
                for t, vs in runs.items()}
        med = {t: float(np.median(v)) for t, v in side.items()}
        lo = {t: min(v) for t, v in side.items()}
        hi = {t: max(v) for t, v in side.items()}
        print(json.dumps({
            "metric": key, "other": side["other"], "this": side["this"],
            "median_other": med["other"], "median_this": med["this"],
            "range_other": [lo["other"], hi["other"]],
            "range_this": [lo["this"], hi["this"]],
            "ratio_this_over_other": med["this"] / med["other"],
            "ranges_overlap": lo["this"] <= hi["other"]
            and lo["other"] <= hi["this"]}))


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
        return 0
    import torch
    args = sys.argv[1:]
    if not args or args[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sketch_ab: no CUDA card", file=sys.stderr)
        return 1
    other = os.path.abspath(args[0])
    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args else 3
    CS = chip_smoke()
    print(CS.phase_device(torch), flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        if "--wide" in args:
            lanes = {"wide": True}
        else:
            lanes = make_lanes(CS, tmp, "--crib" in args)
            print(f"lanes built in {time.monotonic() - t0:.1f} s", flush=True)
        for tree in [other, ROOT, ROOT, other] * (rounds // 2) + (
                [other, ROOT] if rounds % 2 else []):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--worker", tree, json.dumps(lanes)],
                               capture_output=True, text=True, cwd=tree)
            if r.returncode != 0:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            line = r.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            results.append(json.loads(line))
    summary(results, other, ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
