#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, kernel parity in
every sketch mode, the barcodes-mode main path and the modimizer, syncmer,
occurrence-count and checkpoint paths at full lane scale, and byte-level
checks against the C stand-in and the CPU.

Run from the repository root with no arguments:  python3 chip_smoke.py
(``python3 chip_smoke.py --only 23,24,25,26`` builds the kernel and runs
only the phases named; its last line is the same JSON result, with no
kernels line.)

Phases (any failure exits non-zero):
  1. device   - the card's name and power limit (nvidia-smi) and torch's name
  2. build    - nvcc builds csrc/minimizer.cu for sm_90a (timed)
  3. parity   - the sketch kernel equals kernels.minimizer.sketch_plain bit for
                bit (all four outputs) on ragged, N-salted, short, homopolymer
                and overflow batches: minimizer and kmer modes, w = 100 and
                w = 130 = P, and modimizer (m = w, 7, 2, 65521 at k = 21, 16,
                31) and syncmer (s = 11, 5, 1, 20 at k = 21; s = 30 at k = 31)
                modes, dense and compacted; the crib's shape: kmer mode,
                dense, L = 32,768 with N blocks, rows shorter than k and one
                of exactly k bases; seeded cases aimed at the kernel's tile
                edges in every mode, on rows at unaligned addresses too
                (phase_tile_fuzz); the wide route (minimizer, w > 4,096:
                phase_wide) at w = 4,097, 5,000, 8,191 and w > P on rows of
                3w aimed at its block edges, dense and compacted, at an
                unaligned offset, and on a 64-row subset of 4,096 x 32,768
                at w = 5,000.  Each route (minimizer, modimizer, syncmer at
                B=4096, L=150; a crib row group; the wide route at the CLI
                check's shape, at 33 x 12,288 with w = 4,097 and at the
                full-card shape, there beside the tile kernel at w = 4,096)
                is timed three ways, each with CUDA events: the kernel's
                device time per launch (kernel_device_ms), the wrapper's
                time per call (the kernels line's "ms") and the plain
                version's (not at the full-card shape), against its bound
                (sketch_bound)
  4. main     - the 800k-read / 50k-barcode lane of bench.py as an .fqb,
                through hash10x_tpu_torch.cli.main on CUDA; every batch must go
                through the kernel (launch counter > 0, plain calls == 0) in
                multi-batch steps: every step one CUDA graph replay holding
                one sketch launch (launches = replays + one warm-up launch
                per captured graph), fewer launches than batches
  5. c_ref    - native/c_ref/hash10x_ref.c on the same lane: equal count
                table, byte-identical report, and byte-identical cluster dump
                on a 50k-read sub-lane
  6. cpu      - the CLI on CUDA and on the CPU give byte-identical output on
                a 20k-read lane with N bases, ragged and short reads; the
                same with -w 5000 (the wide route, C = 24): kernel launches
                > 0 and plain calls 0 in the CUDA run
  7. modes    - the 800k lane through the CLI on CUDA with --syncmer 11 and
                with --modimizer, each through the report; kernel launches > 0
                and plain calls == 0 in each run
  8. counts   - BASELINE config #1 (bench.py's make_lane: 262,144 reads of
                150 bp from a 2 Mb genome, all under barcode 0) through the
                CLI on CUDA with --countMode occurrences: the table equals
                native/c_ref run without --barcodes
  9. ckpt     - the 800k lane with --errorFixReads 2 --errorFix 1 through the
                report and --writeHash; a fresh CLI's --readHash
                --clusterReport is byte-identical
 10. cpu2     - CUDA and CPU byte-identical on the 20k lane with one
                3,000-read barcode under --batchReads 1024, for --syncmer 11,
                --modimizer and --countMode occurrences
 11. crib     - a diploid 800k-read / 50k-barcode lane from io/sim (two 100 Mb
                haplotypes written as FASTA) through --codeClusters
                --cribBuild h1.fa h2.fa --cribReport on CUDA: every genome
                row goes through the kernel's dense kmer mode (launches during
                cribBuild > 0, plain calls 0), overall purity >= 0.85
 12. legacy   - the 800k lane on CUDA with --clusterMode pair --minShare 2 and
                with --maxFriends 256, each through the report
 13. cpu3     - CUDA and CPU byte-identical on the 20k lane of phase 6 for
                pair mode, capped friend and the crib (2 Mb haplotypes)
 14. observe  - --metrics --devMem --profile on the 20k lane (every JSONL line
                has hbm_in_use_mb, the trace names the sketch kernel); the
                800k lane written as FASTQ and read with --readFastq through
                the native loader: stdout byte-identical to phase 4's, load
                walls of the native loader and the numpy parser
 15. shards   - the 800k lane through the CLI on CUDA with --shards 4 and with
                --shards 2: stdout (table slots masked), --writeCounts and
                --writeClusters byte-identical to phase 4's; stacked
                sharded steps, each one CUDA graph replay holding one
                sketch launch (launches = replays + one warm-up launch per
                captured graph, fewer than one per batch and pass, 392),
                0 plain calls; stage walls and lines
 16. lanes    - the lane with --shards 4 --laneCapacity 4096 (overflows: the
                pass runs again with doubled lanes, output unchanged), and
                with --labelBlocks 1048576 (labels unchanged)
 17. hosts    - two processes sharing the card over gloo (--hosts 2 --shards
                4, cuda:0), each under a hard timeout: with --readFQB of the
                lane and with --readFQBShard of the lane split into two
                barcode-disjoint files, the coordinator's stdout equals phase
                4's and the other process prints nothing; each process
                sends eager stacked steps, one sketch launch each (fewer
                than 392); steps, launches and walls per process
 18. cpu4     - CUDA and CPU byte-identical with --shards 4 on phase 6's lane
 19. reset    - config #1 through the library API on CUDA: a fresh Engine's
                count, then Engine.reset() and a recount of the same lane
                (the lane stays on the device): both tables byte-equal to
                each other and to phase 8's native/c_ref dump; kernel
                launches > 0 and plain calls 0 in the recount
 20. steps    - the 800k lane through the library API at flush_batches 16, 5
                and 1 and with kernel_compact off: report, --writeCounts and
                --writeClusters byte-identical to phase 4's; per setting the
                steps, replays and launches of a pass, the count and
                filter+incidence walls (first pass, then three reset()
                passes in turns) and the device busy share of a traced pass;
                one replayed step's device and host ms against the same step
                run eagerly (its kernels back to back on the device), at
                S = 16 and 1; the sketch at the stacked shape (16 x 4,096
                reads) against its plain version, timed as in phase 3
 21. shard steps - the 800k lane through the library API at --shards 4
                with flush_batches 16, 5 and 1: report, --writeCounts and
                --writeClusters byte-identical to phase 4's; steps,
                replays and launches (each step one graph replay), count
                and filter+incidence walls of the first and two warm passes
 22. join     - CUDA = CPU at -k 31 on phase 6's 20k lane, one GPU and
                --shards 4: the retained join keying and the segmented
                dedup's extra sort under CUDA graphs; a second band
                (min_count 3) and incidence on the same Engine capture the
                pair graphs again; reports and dumps byte-identical
 23. scale    - lane20x (bench.make_barcodes_lane_blocked: 16M reads of
                150 bp, 1M barcodes x one 30 kb molecule of a 2 Gb
                genome, 20x the phase-4 lane) through the CLI on CUDA, one
                GPU, --shards 4 and --shards 4 --labelBlocks 16777216
                (>= 8 label blocks), with --hashInfo, --codeClusters,
                --clusterSplit, --clusterReport, --writeCounts and
                --writeClusters: stdout (table slots masked) and both
                dumps (sha256) byte-identical across the three runs; the
                incidence pairs equal the in-band sum of the counts dump;
                kernel launches > 0, plain calls 0, each step one CUDA
                graph replay; per stage the wall, peak device memory,
                reserved memory, host RSS, flushes and table slots; the
                generator's wall and host RSS
 24. stress   - the JAX package's stress lane (tests_tpu/probe_edge_stress.py:
                synth_incidence(50_000, 400_000, 30)) through build_incidence
                and clustering at min_friend_share 4: the default edge
                block, 2^17-edge blocks and 4 shards with 2^17-pair label
                blocks (>= 8 blocks each), byte-equal labels, and equal to
                the CPU's; cold and warm walls, peak device memory, pairs,
                friend keys, edges, rounds, each co-occurrence reduction
 25. paths    - the paths off the main path on lane20x (phase 23's .fqb):
                --maxFriends 256 on one GPU and at --shards 4, stdout
                byte-identical, the cluster stage under 60 s, and
                cooccur.friends_table's rows equal to the dense _friends
                rows on 4,096 codes of every size class; --clusterMode
                pair; --writeHash, then --readHash --hashInfo
                --clusterReport in a fresh CLI process, and the lane as
                FASTQ through --readFastq (the native loader), each stdout
                byte-identical to phase 23's one-GPU run (table slots
                masked); --modimizer and --syncmer 11, each step one graph
                replay, the incidence pairs equal to the counts dump's
                in-band sum, and the kernel in each mode at the stacked
                shape 65,536 x 150 against its plain version, timed as in
                phase 3; per stage wall, peak and reserved device memory,
                host RSS; the .npz size and the save and load walls
 26. crib20x  - a diploid lane20x (bench.make_barcodes_lane_blocked with
                het_rate 0.001; two 2 Gb haplotypes, each written as 20
                FASTA records of 100 Mb) through --codeClusters
                --clusterReport --cribBuild h1.fa h2.fa --cribReport on one
                GPU: every genome row through the kernel's kmer mode,
                overall purity >= 0.85, one crib line per molecule, crib
                totals summing to the retained k-mers; per stage (cribBuild
                and cribReport too) wall, peak and reserved device memory,
                host RSS
The last two lines of stdout before the result are a JSON line describing
the kernels and the card's name and power limit; the last line is the JSON
result {"ok": true, "device": {...}}.
"""

import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K, W, SEED = 21, 11, 17
READ_LEN = 150
N_READS, N_CODES = 800_000, 50_000
SUB_CODES = 3_125  # 50,000 reads
PARITY_B = 4096
CRIB_GENOME = 100_000_000  # bases per haplotype of the phase-11 lane


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device(torch):
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    smi = r.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    return smi


def _batch(rng, B, L, k, w, bad=0.0, ragged=False, homo=2):
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    if bad:
        codes[rng.random(codes.shape) < bad] = 4
    lengths = (rng.integers(0, L + 1, size=B) if ragged
               else np.full(B, L)).astype(np.int32)
    codes[0] = homo                   # homopolymer
    codes[1, :L // 2] = 3
    lengths[2] = k + w - 2            # short read: 0 < P_i < w
    lengths[3] = k                    # exactly one k-mer
    lengths[4] = k - 1                # no k-mer
    return codes, lengths


def kernel_device_ms(torch, launch, n=20):
    """Device ms per launch of ``launch()`` (CUDA events around launches
    queued behind a spin kernel): ``utils.timing.kernel_device_ms``, which
    the bench uses too."""
    from hash10x_tpu_torch.utils.timing import kernel_device_ms as device_ms
    return device_ms(launch, n)


def kernel_entry(name, launches, err, ms, plain_ms, device_ms, shape):
    """One entry of the kernels JSON line; ``shape`` = sketch_bound's
    arguments for the timed call.  ``ms`` is the wrapper's time per call
    (CUDA events over back-to-back calls, as in earlier slices),
    ``device_ms`` the kernel's alone (kernel_device_ms)."""
    from hash10x_tpu_torch.kernels.minimizer import sketch_bound
    _, _, bound_ms, bound_by = sketch_bound(*shape)
    return {"name": name, "route": "cuda",
            "source": "hash10x_tpu_torch/csrc/minimizer.cu",
            "replaces": "hash10x_tpu/kernels/minimizer_pallas.py:403",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "device_ms": device_ms,
            "bound_share": bound_ms / device_ms}


def phase_parity(torch, MK, HashSpec, compact_rows):
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cases = [  # (k, w, compact_to, mode, bad, ragged)
        (21, 11, compact_rows, "minimizer", 0.0, False),
        (21, 11, compact_rows, "minimizer", 0.01, True),
        (21, 11, 0, "minimizer", 0.01, True),
        (4, 3, 16, "minimizer", 0.01, True),
        (16, 5, 0, "minimizer", 0.01, True),
        (16, 5, 40, "minimizer", 0.0, True),
        (31, 2, 0, "minimizer", 0.01, True),
        (31, 2, 96, "minimizer", 0.0, False),
        (21, 3, 8, "minimizer", 0.0, False),   # tiny C: per-read overflow
        (21, 11, 0, "kmer", 0.01, True),
    ]
    max_err = 0.0
    for k, w, C, mode, bad, ragged in cases:
        spec = HashSpec(k=k, w=w, seed=SEED)
        codes, lengths = _batch(rng, PARITY_B, READ_LEN, k, w, bad, ragged)
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        got = MK.sketch(spec, c, ln, mode=mode, compact_to=C)
        torch.cuda.synchronize()
        ref = MK.sketch_plain(spec, c, ln, mode=mode, compact_to=C)
        torch.cuda.synchronize()
        err = float((got[0] - ref[0]).abs().max()) if got[0].numel() else 0.0
        max_err = max(max_err, err)
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        n_over = int(got[3].sum())
        print(f"parity k={k} w={w} C={C} mode={mode} bad={bad} "
              f"ragged={ragged}: {'equal' if same else 'DIFFERENT'} "
              f"(emitted {int(got[2].sum())}, overflow {n_over})")
        if not same:
            fail(f"kernel != plain for k={k} w={w} C={C} mode={mode}")
        if C == 8 and n_over == 0:
            fail("the tiny-C case did not overflow")

    # times at the main path's shape (B=4096, L=150, k=21, w=11, C)
    spec = HashSpec(k=K, w=W, seed=SEED)
    times = time_sketch(torch, MK, rng, spec,
                        dict(mode="minimizer", compact_to=compact_rows))
    print_times(f"sketch B={PARITY_B} L={READ_LEN} k={K} w={W} "
                f"C={compact_rows}", times,
                (PARITY_B, READ_LEN, compact_rows, K, "minimizer"))
    return (max_err, *times)


def print_times(what, times, shape):
    from hash10x_tpu_torch.kernels.minimizer import sketch_bound
    ms, plain_ms, dev_ms = times
    nbytes, ops, bound_ms, bound_by = sketch_bound(*shape)
    print(f"{what}: device {dev_ms:.4f} ms/launch (CUDA events around "
          f"back-to-back launches into preallocated outputs); wrapper "
          f"{ms:.4f} ms/call, plain {plain_ms:.4f} "
          f"ms/call (CUDA events over back-to-back calls, kernel, plain, "
          f"plain, kernel); bound {bound_ms:.4f} ms ({nbytes} bytes, {ops} "
          f"int32 ops: {bound_by}), {bound_ms / dev_ms:.4f} of it")


def time_sketch(torch, MK, rng, spec, kw, n=50):
    """Wrapper and plain ms per call and the kernel's device ms per launch
    on a B=4096, L=150 batch."""
    dev = torch.device("cuda")
    codes, lengths = _batch(rng, PARITY_B, READ_LEN, spec.k, spec.w)
    lengths[:] = READ_LEN
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    ms, plain_ms = time_kernel_plain(torch, MK, spec, c, ln, kw, n)
    return ms, plain_ms, kernel_device_ms(
        torch, MK.launcher(spec, c, ln, **kw))


def time_kernel_plain(torch, MK, spec, c, ln, kw, n, warm=3, plain=True):
    """Kernel and plain ms per call on (c, ln): CUDA events over n calls
    after ``warm`` warm-ups, in the order kernel, plain, plain, kernel;
    with ``plain=False`` the kernel twice, and None for the plain."""
    def timed(fn):
        for _ in range(warm):
            fn(spec, c, ln, **kw)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn(spec, c, ln, **kw)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n
    ms, plain_ms = [], []
    order = ((MK.sketch, ms), (MK.sketch_plain, plain_ms),
             (MK.sketch_plain, plain_ms), (MK.sketch, ms))
    for fn, acc in order if plain else order[::3]:
        acc.append(timed(fn))
    return float(np.mean(ms)), float(np.mean(plain_ms)) if plain else None


def phase_mode_parity(torch, MK, HashSpec, compact_rows_of):
    """Kernel == plain in the modimizer and syncmer modes and at w > 64,
    dense and compacted at the engine's width, on ragged N-salted batches
    whose row 0 is a full-length poly-A read: its hash is 0, so every
    position is a modimizer and (all s-mers tie) a syncmer, and the
    compacted row must overflow.  Returns per mode (max_abs_err, ms,
    plain_ms, device_ms)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    cases = [("minimizer", 21, 100, {}), ("minimizer", 21, 130, {})]
    cases += [("modimizer", k, W, {"m": m}) for k in (21, 16, 31)
              for m in (0, 7, 2, 65521)]
    cases += [("syncmer", 21, W, {"syncmer_s": s}) for s in (11, 5, 1, 20)]
    cases += [("syncmer", 31, W, {"syncmer_s": 30})]
    err = {"modimizer": 0.0, "syncmer": 0.0, "minimizer": 0.0}
    for mode, k, w, kw in cases:
        spec = HashSpec(k=k, w=w, seed=SEED)
        C_eng = compact_rows_of(spec, mode, kw)
        codes, lengths = _batch(rng, PARITY_B, READ_LEN, k, w, 0.01, True,
                                homo=0)
        lengths[0] = READ_LEN
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        for C in dict.fromkeys((0, C_eng)):  # C_eng is 0 where P is too short
            got = MK.sketch(spec, c, ln, mode=mode, compact_to=C, **kw)
            torch.cuda.synchronize()
            ref = MK.sketch_plain(spec, c, ln, mode=mode, compact_to=C, **kw)
            torch.cuda.synchronize()
            e = float((got[0] - ref[0]).abs().max()) if got[0].numel() else 0.0
            err[mode] = max(err[mode], e)
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            homo_over = (int(got[3][0]), int(ref[3][0]))
            print(f"parity {mode} k={k} w={w} {kw} C={C}: "
                  f"{'equal' if same else 'DIFFERENT'} (emitted "
                  f"{int(got[2].sum())}, overflow {int(got[3].sum())}, "
                  f"poly-A row overflow {homo_over[0]})")
            if not same:
                fail(f"kernel != plain for {mode} k={k} w={w} {kw} C={C}")
            if C and mode != "minimizer" and (
                    homo_over[0] != homo_over[1] or homo_over[0] <= 0):
                fail(f"the poly-A row did not overflow C={C} for {mode} {kw}")
    out = {}
    for mode, kw in (("modimizer", {"m": W}), ("syncmer", {"syncmer_s": 11})):
        spec = HashSpec(k=K, w=W, seed=SEED)
        C = compact_rows_of(spec, mode, kw)
        times = time_sketch(torch, MK, rng, spec,
                            dict(mode=mode, compact_to=C, **kw))
        shape = (PARITY_B, READ_LEN, C, K, mode, kw.get("syncmer_s", 0))
        print_times(f"sketch {mode} {kw} B={PARITY_B} L={READ_LEN} k={K} "
                    f"C={C}", times, shape)
        out[mode] = (err[mode], *times, shape)
    return out, err["minimizer"]


def make_lane():
    """bench.py's barcodes lane: 800k reads of 150 bp, 50k barcodes, each
    barcode one 30 kb molecule of a 100 Mb random genome."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=100_000_000).astype(np.uint8)
    mol_starts = rng.integers(0, len(genome) - 30_000, size=N_CODES)
    bc_ids = np.repeat(np.arange(N_CODES, dtype=np.int32), N_READS // N_CODES)
    offs = rng.integers(0, 30_000 - READ_LEN, size=N_READS)
    starts = mol_starts[bc_ids] + offs
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    return reads, bc_ids


def write_fqb(path, reads, bc_ids, n_codes):
    from hash10x_tpu_torch.core.encode import pack_2bit
    from hash10x_tpu_torch.io.fqb import Fqb, save_fqb
    save_fqb(path, Fqb(packed=pack_2bit(reads),
                       lengths=np.full(len(reads), READ_LEN, np.int32),
                       barcode_ids=bc_ids,
                       barcode_keys=np.arange(n_codes, dtype=np.uint32),
                       read_len=READ_LEN))


def phase_main(torch, MK, ES, run, lane):
    argv = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
            "--minCount", "2", "--maxCount", "64", "--friendShare", "8",
            "--readFQB", lane, "--hashInfo", "--hashDist", "--codeClusters",
            "--clusterSplit", "--clusterReport"]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    MK.LAUNCHES = 0
    MK.PLAIN_CALLS = 0
    ES.REPLAYS = 0
    t0 = time.monotonic()
    eng = run(argv, out, err)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain = MK.LAUNCHES, MK.PLAIN_CALLS
    sys.stderr.write(err.getvalue())
    n_batches = len(eng._lane_cache[3])
    if launches <= 0 or plain != 0:
        fail("the main path did not run every batch through the kernel")
    steps, replays, graphs = check_replays("main path", eng, ES, launches,
                                           2 * n_batches)
    print(f"main path: {steps} steps over {n_batches} batches per pass "
          f"(count and incidence), {replays} CUDA graph replays of "
          f"{graphs} captured graphs, kernel launches {launches}, plain "
          f"calls {plain}")
    walls = stage_walls(err.getvalue())
    phases = {"count": walls["count"],
              "filter+incidence": walls["filter"] + walls["incidence"],
              "cluster": walls["cluster"], "split": walls["split"],
              "report": walls["report"]}
    total = sum(phases.values())
    print("main path walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items())
        + f"; sum {total:.3f}; CLI wall {wall:.3f} (includes .fqb load)")
    print(f"main path: {N_READS / total:.1f} reads/s over the phase walls; "
          f"{eng.inc.n_pairs} incidence pairs; {eng.table.n_filled} kmers; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    text = out.getvalue()
    if "table slots" not in text or "code 0 nKmers" not in text:
        fail("main path output lacks --hashInfo or --clusterReport lines")
    return eng, text, launches, n_batches


def stage_walls(err_text):
    """Seconds per stage label from the CLI's stderr timing lines."""
    walls = {}
    for line in err_text.splitlines():
        label = line[1:line.index("]")].split(":")[0].split(" ")[0]
        walls[label] = walls.get(label, 0.0) + float(
            line.split("] wall ")[1].split("s")[0])
    return walls


def c_ref_exe(tmp):
    exe = os.path.join(tmp, "hash10x_ref")
    subprocess.run(["gcc", "-O2", "-o", exe,
                    os.path.join(ROOT, "native", "c_ref", "hash10x_ref.c")],
                   check=True, capture_output=True)
    return exe


def run_c_ref(exe, tmp, tag, reads, bc_ids, extra):
    rb = os.path.join(tmp, f"{tag}_reads.bin")
    bb = os.path.join(tmp, f"{tag}_bc.bin")
    with open(rb, "wb") as f:
        np.array([len(reads), reads.shape[1]], np.uint32).tofile(f)
        reads.astype(np.uint8).tofile(f)
    bc_ids.astype(np.uint32).tofile(bb)
    t0 = time.monotonic()
    # table bits 24: the stand-in lists the distinct hashes (~10.4M on the
    # full lane) in its 2^bits table arrays, so 2^22 would overflow them
    subprocess.run([exe, rb, str(K), str(W), str(SEED), "24", "--barcodes", bb,
                    "--minCount", "2", "--maxCount", "64", "--friendShare",
                    "8", "--cluster", *extra], check=True, capture_output=True)
    return time.monotonic() - t0


def phase_c_ref(torch, st, run, eng, text, reads, bc_ids, tmp):
    exe = c_ref_exe(tmp)
    dump = os.path.join(tmp, "counts.bin")
    rep = os.path.join(tmp, "report.txt")
    secs = run_c_ref(exe, tmp, "full", reads, bc_ids,
                     ["--dump", dump, "--report", rep])
    print(f"c_ref full pipeline: {secs:.3f} s single-thread on the host CPU")
    with open(dump, "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        c_hashes = np.fromfile(f, np.uint64, m)
        c_counts = np.fromfile(f, np.uint32, m)
    h, c = (x.cpu().numpy() for x in st.compact(eng._flushed()))
    if not (np.array_equal(h.astype(np.uint64), c_hashes)
            and np.array_equal(c.astype(np.uint32), c_counts)):
        fail("count table != c_ref dump")
    print(f"c_ref counts: {m} (hash, count) pairs equal")
    report = text[text.index("code 0 nKmers"):]
    with open(rep) as f:
        if report != f.read():
            fail("--clusterReport text != c_ref report")
    print(f"c_ref report: {report.count(chr(10))} lines byte-identical")

    # cluster dump on a 50k-read sub-lane (the full dump is ~10M lines)
    keep = bc_ids < SUB_CODES
    sub_reads, sub_bc = reads[keep], bc_ids[keep]
    sub_lane = os.path.join(tmp, "sub.fqb")
    write_fqb(sub_lane, sub_reads, sub_bc, SUB_CODES)
    mine = os.path.join(tmp, "sub_clusters_port.txt")
    theirs = os.path.join(tmp, "sub_clusters_c.txt")
    run(["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
         "--minCount", "2", "--maxCount", "64", "--friendShare", "8",
         "--readFQB", sub_lane, "--codeClusters", "--writeClusters", mine],
        io.StringIO(), io.StringIO())
    run_c_ref(exe, tmp, "sub", sub_reads, sub_bc, ["--dumpClusters", theirs])
    with open(mine) as a, open(theirs) as b:
        ta, tb = a.read(), b.read()
    if ta != tb:
        fail("sub-lane --writeClusters != c_ref --dumpClusters")
    print(f"c_ref clusters: {len(sub_reads)}-read sub-lane, "
          f"{ta.count(chr(10))} lines byte-identical")


def phase_cuda_vs_cpu(run, tmp, w=W, MK=None):
    """The CLI on CUDA and on the CPU (plain versions) on a small lane with
    N bases, ragged and short reads and reads without a barcode: stdout and
    both dump files must be byte-identical.  With ``MK`` the CUDA run's
    kernel launches are counted (from 0) and returned; it fails unless
    they are > 0 with no plain call."""
    from hash10x_tpu_torch.io.fastq import ReadBatch
    from hash10x_tpu_torch.io.fqb import from_read_batch, save_fqb
    rng = np.random.default_rng(SEED)
    n = 20_000
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    mol = rng.integers(0, len(genome) - 20_000, size=n // 20)
    starts = np.repeat(mol, 20) + rng.integers(0, 20_000 - READ_LEN, size=n)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    codes[rng.random(codes.shape) < 0.005] = 4
    lengths = rng.integers(15, READ_LEN + 1, size=n).astype(np.int32)
    lengths[rng.random(n) < 0.01] = 0
    keys = np.repeat(rng.choice(1 << 32, size=n // 20, replace=False),
                     20).astype(np.uint32)
    lane = os.path.join(tmp, "ragged.fqb")
    save_fqb(lane, from_read_batch(ReadBatch(codes, lengths, keys)))
    outs = []
    launches = plain = 0
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        files = [os.path.join(tmp, f"ragged_{dev}.{x}")
                 for x in ("counts", "clusters")]
        if MK is not None and dev == "cuda":
            MK.LAUNCHES = MK.PLAIN_CALLS = 0
        run(["--device", dev, "-k", str(K), "-w", str(w), "-r", str(SEED),
             "--batchReads", "1024", "--friendShare", "4", "--readFQB", lane,
             "--hashInfo", "--hashDist", "--codeClusters", "--clusterSplit",
             "--clusterReport", "--writeCounts", files[0],
             "--writeClusters", files[1]], out, io.StringIO())
        if MK is not None and dev == "cuda":
            launches, plain = MK.LAUNCHES, MK.PLAIN_CALLS
        texts = [out.getvalue()]
        for f in files:
            with open(f) as fh:
                texts.append(fh.read())
        outs.append(texts)
    if outs[0] != outs[1]:
        fail(f"CUDA and CPU runs differ on the ragged N lane at w={w}")
    tag = "" if w == W else f" -w {w}"
    print(f"cuda vs cpu{tag}: {n}-read ragged lane with N bases, stdout "
          f"({outs[0][0].count(chr(10))} lines) and dumps byte-identical")
    if MK is not None:
        print(f"cuda vs cpu{tag}: CUDA run kernel launches {launches}, plain "
              f"calls {plain}")
        if launches <= 0 or plain != 0:
            fail(f"the -w {w} CUDA run did not run every batch through the "
                 f"kernel")
    return launches


def run_counted(torch, MK, run, argv):
    """One CLI run on CUDA with the launch counters set to 0 just before it
    and read just after; fails unless every batch went through the kernel.
    Returns (stdout, stderr, engine, launches, wall seconds)."""
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    MK.LAUNCHES = 0
    MK.PLAIN_CALLS = 0
    t0 = time.monotonic()
    eng = run(argv, out, err)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain = MK.LAUNCHES, MK.PLAIN_CALLS
    if launches <= 0 or plain != 0:
        fail(f"{' '.join(argv[-8:])}: kernel launches {launches}, plain "
             f"calls {plain}")
    return out.getvalue(), err.getvalue(), eng, launches, wall


def phase_modes(torch, MK, run, lane):
    """The 800k lane through the report with --syncmer 11 and --modimizer."""
    launches = {}
    for mode, flags in (("syncmer", ["--syncmer", "11"]),
                        ("modimizer", ["--modimizer"])):
        argv = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
                *flags, "--minCount", "2", "--maxCount", "64",
                "--friendShare", "8", "--readFQB", lane, "--hashInfo",
                "--codeClusters", "--clusterSplit", "--clusterReport"]
        out, err, eng, n, wall = run_counted(torch, MK, run, argv)
        walls = stage_walls(err)
        phases = {"count": walls["count"],
                  "filter+incidence": walls["filter"] + walls["incidence"],
                  "cluster": walls["cluster"], "split": walls["split"],
                  "report": walls["report"]}
        total = sum(phases.values())
        print(f"modes {mode}: kernel launches {n}, plain calls 0; walls (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
              + f"; sum {total:.3f} ({N_READS / total:.1f} reads/s); CLI "
              f"wall {wall:.3f}; {eng.table.n_filled} kmers, "
              f"{eng.inc.n_pairs} incidence pairs; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if "table slots" not in out or f"code {N_CODES - 1} nKmers" not in out:
            fail(f"{mode} lane output lacks --hashInfo or report lines")
        launches[mode] = n
        del eng  # the next run's peak memory must not hold this state
    return launches


def make_count_lane():
    """bench.py's make_lane: 262,144 reads of 150 bp from a 2 Mb random
    genome (seed 7), all under barcode 0 (BASELINE config #1)."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=1 << 18)
    return genome[starts[:, None] + np.arange(READ_LEN)[None, :]]


def phase_counts(torch, MK, run, tmp):
    """Config #1 occurrence table through the CLI on CUDA == c_ref --dump."""
    reads = make_count_lane()
    n = len(reads)
    lane = os.path.join(tmp, "count.fqb")
    write_fqb(lane, reads, np.zeros(n, np.int32), 1)
    table = os.path.join(tmp, "count_port.txt")
    argv = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "20",
            "--countMode", "occurrences", "--readFQB", lane, "--hashInfo",
            "--writeCounts", table]
    out, err, eng, launches, wall = run_counted(torch, MK, run, argv)
    count_s = stage_walls(err)["count"]
    exe = c_ref_exe(tmp)
    rb = os.path.join(tmp, "count_reads.bin")
    with open(rb, "wb") as f:
        np.array([n, READ_LEN], np.uint32).tofile(f)
        reads.tofile(f)
    dump = os.path.join(tmp, "count_c.bin")
    t0 = time.monotonic()
    subprocess.run([exe, rb, str(K), str(W), str(SEED), "22", "--dump", dump],
                   check=True, capture_output=True)
    c_secs = time.monotonic() - t0
    with open(dump, "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        c_hashes = np.fromfile(f, np.uint64, m)
        c_counts = np.fromfile(f, np.uint32, m)
    with open(table) as f:
        mine = f.read()
    if mine != "".join(f"{int(h):x}\t{int(c)}\n"
                       for h, c in zip(c_hashes, c_counts)):
        fail("config-#1 occurrence table != c_ref --dump")
    print(f"counts (config #1): {n} reads, {m} (hash, count) pairs equal to "
          f"c_ref; kernel launches {launches}; count wall {count_s:.3f} s "
          f"= {n / count_s:.1f} reads/s (first run in process); CLI wall "
          f"{wall:.3f} s; c_ref {c_secs:.3f} s single-thread on the host "
          f"CPU (build of its table included, run without --barcodes)")


def phase_reset(torch, MK, tmp):
    """Phase 19: config #1 through the library API: a fresh engine's table,
    then reset() and a recount of the same lane with the lane kept on the
    device; both byte-equal to each other and to phase 8's c_ref dump."""
    from hash10x_tpu_torch.engine import Engine, EngineConfig
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.io.fqb import load_fqb
    from hash10x_tpu_torch.table import sorted_table as st
    fqb = load_fqb(os.path.join(tmp, "count.fqb"))
    eng = Engine(EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                              count_mode="occurrences", table_bits=20),
                 "cuda", log=None)

    def table():
        h, c = st.compact(eng._flushed())
        return h.cpu().numpy().tobytes() + c.cpu().numpy().tobytes()
    eng.count(fqb)
    fresh = table()
    lane = eng._lane_cache[2]
    eng.reset()
    if eng.table is not None or eng.n_reads_counted or any(
            eng.stats.values()):
        fail("reset() left analysis state behind")
    MK.LAUNCHES = 0
    MK.PLAIN_CALLS = 0
    t0 = time.monotonic()
    eng.count(fqb)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain = MK.LAUNCHES, MK.PLAIN_CALLS
    if launches <= 0 or plain != 0:
        fail(f"reset() + recount: kernel launches {launches}, plain calls "
             f"{plain}")
    if eng._lane_cache[2] is not lane:
        fail("reset() dropped the device-resident lane")
    again = table()
    with open(os.path.join(tmp, "count_c.bin"), "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        c_h = np.fromfile(f, np.uint64, m).astype(np.int64)
        c_c = np.fromfile(f, np.uint32, m).astype(np.int32)
    if again != fresh:
        fail("reset() + recount table != the fresh engine's table")
    if again != c_h.tobytes() + c_c.tobytes():
        fail("reset() + recount table != c_ref --dump")
    print(f"reset: config #1 recount after reset() byte-equal to the fresh "
          f"engine's table and to c_ref ({m} (hash, count) pairs); kernel "
          f"launches {launches}, plain calls 0; recount wall {wall:.3f} s "
          f"(lane on the device); stats {eng.stats}")


def timed_passes(torch, eng, fqb):
    """reset(), then the count and filter+incidence walls of a pass."""
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    eng.count(fqb)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    eng.filter()
    eng.incidence(fqb)
    torch.cuda.synchronize()
    return {"count_s": t1 - t0, "filter_incidence_s": time.monotonic() - t1}


STEP_SETTINGS = (("S=16", {"flush_batches": 16}), ("S=5", {"flush_batches": 5}),
                 ("S=1", {"flush_batches": 1}),
                 ("S=16 compact off", {"kernel_compact": False}))


def phase_steps(torch, MK, ES, lane, main_text, main_dumps, tmp, C):
    """Phase 20: the 800k lane through the library API at each of
    STEP_SETTINGS (the CLI has no flag for them): report and dumps
    byte-identical to phase 4's; per setting the steps, replays and
    launches of a pass, the count and filter+incidence walls and the busy
    share; one replayed step against the same step run eagerly; the sketch
    at the stacked shape.  Returns the kernels-line tuple of that shape."""
    import dataclasses
    from hash10x_tpu_torch.bench import profiled_pass
    from hash10x_tpu_torch.engine import Engine, EngineConfig
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.io.fqb import load_fqb
    from hash10x_tpu_torch.utils.timing import kernel_device_ms as device_ms
    fqb = load_fqb(lane)
    spec = HashSpec(k=K, w=W, seed=SEED)
    want = "".join(line for line in main_text.splitlines(True)
                   if line.startswith("code "))

    def passes(eng):
        return timed_passes(torch, eng, fqb)

    engines, walls = {}, {}
    for name, kw in STEP_SETTINGS:
        eng = Engine(EngineConfig(spec=spec, table_bits=22, min_count=2,
                                  max_count=64, min_friend_share=8, **kw),
                     "cuda", log=None)
        MK.LAUNCHES = MK.PLAIN_CALLS = ES.REPLAYS = 0
        first = passes(eng)
        launches, plain, replays = MK.LAUNCHES, MK.PLAIN_CALLS, ES.REPLAYS
        steps = eng.stats["dispatches"]
        eng.cluster()
        eng.split()
        out = io.StringIO()
        eng.report(out)
        dumps = write_dumps(eng, tmp, "steps")
        if out.getvalue() != want or not all(
                same_files(a, b) for a, b in zip(dumps, main_dumps)):
            fail(f"steps {name}: report or dumps != phase 4's")
        if plain or replays != steps or launches <= 0:
            fail(f"steps {name}: {steps} steps, {replays} replays, "
                 f"{launches} launches, {plain} plain calls")
        print(f"steps {name}: report ({want.count(chr(10))} lines), counts "
              f"and clusters dumps byte-identical to phase 4; {steps} steps "
              f"(count and incidence), {replays} replays, kernel launches "
              f"{launches}, plain calls 0; first pass (captures included) "
              f"count {first['count_s']:.4f} s, filter+incidence "
              f"{first['filter_incidence_s']:.4f} s")
        engines[name] = eng
        walls[name] = []
    for _ in range(3):   # warm passes, the settings in turns
        for name, _ in STEP_SETTINGS:
            walls[name].append(passes(engines[name]))
    for name, _ in STEP_SETTINGS:
        eng = engines[name]
        prof = profiled_pass(torch.device("cuda"),
                             lambda: (passes(eng), None, None))
        med = {k: float(np.median([w[k] for w in walls[name]]))
               for k in walls[name][0]}
        print(f"steps {name} warm walls (median of 3 [min-max]): " + ", ".join(
            f"{k[:-2]} {med[k]:.4f} [{min(w[k] for w in walls[name]):.4f}-"
            f"{max(w[k] for w in walls[name]):.4f}] s" for k in med)
            + f"; traced pass: busy {prof['busy_ms']:.2f} ms, busy share "
            f"{prof['busy_share']:.4f} of its walls "
            f"{sum(prof['phase_walls_s'].values()):.4f} s; top device ms "
            + "; ".join(f"{n} {ms:.2f}" for n, ms in prof["top_device_ms"]))

    # one step, replayed and eager, at S = 16 and S = 1
    eng = engines["S=16"]
    seen = []
    real_call = ES.LaneSteps.__call__

    def spy(self, ss, om, retained=None):
        if not seen:
            seen.append((self, ss, om))
        return real_call(self, ss, om, retained)
    ES.LaneSteps.__call__ = spy
    try:
        eng.reset()
        eng.count(fqb)
    finally:
        ES.LaneSteps.__call__ = real_call
    steps, ss, om = seen[0]
    for S in (ss.S, 1):
        ssS = dataclasses.replace(ss, S=S)
        omS = np.ascontiguousarray(om[:, :S])
        om_dev = torch.from_numpy(omS).cuda()
        rep_ms = device_ms(lambda: steps(ssS, omS))
        # an eager step is ~100 launches: a few steps stay inside the
        # card's launch queue while the spin kernel holds it
        eager_ms = device_ms(lambda: ES.step(ssS, steps.lane, om_dev), 3)
        host = []
        for fn in (lambda: steps(ssS, omS),
                   lambda: ES.step(ssS, steps.lane, om_dev)):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            host.append((time.monotonic() - t0) / 20 * 1e3)
        print(f"steps: one {ss.keying} step of S={S} x {ss.bsz} reads "
              f"(C={ss.C}, {ss.slots} slots a batch): replay device "
              f"{rep_ms:.4f} ms, host {host[0]:.4f} ms/step; the same step "
              f"eager: device {eager_ms:.4f} ms (its kernels back to back), "
              f"host {host[1]:.4f} ms/step")
    del engines, eng, steps

    return time_stacked(torch, MK, spec, ss.S, C, "minimizer", {})


def time_stacked(torch, MK, spec, S, C, mode, kw):
    """The sketch at a stacked step's shape (S x 4,096 reads of 150 bp,
    compacted to C) in ``mode`` against its plain version (equal in every
    output), timed as in phase 3.  Returns the kernels-line tuple of that
    shape."""
    from hash10x_tpu_torch.utils.timing import kernel_device_ms as device_ms
    rng = np.random.default_rng(SEED + 2)
    B = S * PARITY_B
    codes, lengths = _batch(rng, B, READ_LEN, spec.k, spec.w)
    lengths[:] = READ_LEN
    c = torch.from_numpy(codes).cuda()
    ln = torch.from_numpy(lengths).cuda()
    kw = dict(kw, mode=mode, compact_to=C)
    got = MK.sketch(spec, c, ln, **kw)
    ref = MK.sketch_plain(spec, c, ln, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        fail(f"kernel != plain at the stacked shape {B} x {READ_LEN}, "
             f"{mode}")
    err = float((got[0] - ref[0]).abs().max())
    ms, plain_ms = time_kernel_plain(torch, MK, spec, c, ln, kw, 5, warm=1)
    dev_ms = device_ms(MK.launcher(spec, c, ln, **kw))
    shape = (B, READ_LEN, C, spec.k, mode, kw.get("syncmer_s", 0))
    print_times(f"sketch stacked {mode} B={B} L={READ_LEN} k={spec.k} "
                f"w={spec.w} C={C}", (ms, plain_ms, dev_ms), shape)
    return err, ms, plain_ms, dev_ms, shape


def phase_checkpoint(torch, MK, run, lane, tmp):
    """errorFix with rescue through the report and --writeHash; a fresh CLI
    resumes with --readHash and must print the same report."""
    ck = os.path.join(tmp, "lane.hash")
    params = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
              "--minCount", "2", "--maxCount", "64", "--friendShare", "8"]
    out1, err1, _, _, wall1 = run_counted(
        torch, MK, run, params + ["--errorFixReads", "2", "--readFQB", lane,
                                  "--errorFix", "1", "--codeClusters",
                                  "--clusterReport", "--writeHash", ck])
    if err1.count("[count:") != 2:  # the lane's count and the rescue pass
        fail("the errorFix rescue pass did not run")
    out2, err2 = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    run(params + ["--readHash", ck, "--clusterReport"], out2, err2)
    wall2 = time.monotonic() - t0
    if out2.getvalue() != out1 or f"code {N_CODES - 1} nKmers" not in out1:
        fail("the report after --readHash differs from the one before "
             "--writeHash")
    fix = [l for l in err1.splitlines() if l.startswith("[errorFix")][0]
    print(f"checkpoint: {fix.split(']')[0][1:]}; report "
          f"({out1.count(chr(10))} lines) byte-identical after --readHash; "
          f"first CLI {wall1:.3f} s, resume CLI {wall2:.3f} s, checkpoint "
          f"{os.path.getsize(ck + '.npz') / 1e6:.1f} MB")


def phase_cuda_vs_cpu_modes(run, tmp):
    """The 20k lane with one 3,000-read barcode: CUDA and CPU byte-identical
    under --syncmer 11, --modimizer and --countMode occurrences."""
    from hash10x_tpu_torch.io.fqb import load_fqb, save_fqb
    fqb = load_fqb(os.path.join(tmp, "ragged.fqb"))
    big = fqb.barcode_ids[0]
    fqb.barcode_ids[:3000] = big
    lane = os.path.join(tmp, "ragged_big.fqb")
    save_fqb(lane, fqb)
    for flags in (["--syncmer", "11"], ["--modimizer"],
                  ["--countMode", "occurrences"]):
        outs = []
        for dev in ("cuda", "cpu"):
            out = io.StringIO()
            files = [os.path.join(tmp, f"big_{dev}.{x}")
                     for x in ("counts", "clusters")]
            run(["--device", dev, "-k", str(K), "-w", str(W), "-r",
                 str(SEED), *flags, "--batchReads", "1024", "--friendShare",
                 "4", "--readFQB", lane, "--hashInfo", "--hashDist",
                 "--codeClusters", "--clusterSplit", "--clusterReport",
                 "--writeCounts", files[0], "--writeClusters", files[1]],
                out, io.StringIO())
            texts = [out.getvalue()]
            for f in files:
                with open(f) as fh:
                    texts.append(fh.read())
            outs.append(texts)
        if outs[0] != outs[1]:
            fail(f"CUDA and CPU runs differ with {' '.join(flags)}")
        print(f"cuda vs cpu {' '.join(flags)}: 20k lane with a 3,000-read "
              f"barcode at --batchReads 1024, stdout "
              f"({outs[0][0].count(chr(10))} lines) and dumps byte-identical")


CRIB_PARITY_B = 256


def _genome_rows(rng, B, L, k):
    """Crib-shaped rows: L = 32,768 genome bases with N blocks and scattered
    Ns, a row shorter than k, an empty row, a row of exactly k bases, an
    all-N row and ragged tails."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.0005] = 4
    for r in range(0, B, 3):                      # N blocks (gaps)
        s = int(rng.integers(0, L - 3000))
        codes[r, s:s + int(rng.integers(1, 3000))] = 4
    lengths = np.full(B, L, np.int32)
    lengths[1] = k - 1
    lengths[2] = 0
    lengths[3] = k
    codes[3, :k] = rng.integers(0, 4, size=k)     # its one k-mer is valid
    codes[4] = 4
    lengths[5:40] = rng.integers(k, L, size=len(lengths[5:40]))
    return codes, lengths


def phase_crib_parity(torch, MK, HashSpec, crib_rows):
    """The crib's route: kmer mode, dense, L = 32,768.  Kernel == plain bit
    for bit on all four outputs; kernel and plain ms per row group of the
    crib's CUDA height.  Returns (max_abs_err, ms, plain_ms)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    spec = HashSpec(k=K, w=W, seed=SEED)
    L = 1 << 15
    codes, lengths = _genome_rows(rng, CRIB_PARITY_B, L, K)
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    got = MK.sketch(spec, c, ln, mode="kmer")
    torch.cuda.synchronize()
    ref = MK.sketch_plain(spec, c, ln, mode="kmer")
    torch.cuda.synchronize()
    err = float((got[0] - ref[0]).abs().max())
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    n_valid = int(got[2].sum())
    print(f"parity kmer dense B={CRIB_PARITY_B} L={L} k={K} (N blocks, "
          f"rows shorter than k, one row of exactly k): "
          f"{'equal' if same else 'DIFFERENT'} (valid {n_valid}, exactly-k "
          f"row {int(got[2][3].sum())})")
    if not same or int(got[2][3].sum()) != 1 or int(got[2][1].sum()):
        fail("kernel != plain in kmer mode at L = 32,768")
    codes, lengths = _genome_rows(rng, crib_rows, L, K)
    lengths[:] = L
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    ms, plain_ms = time_kernel_plain(torch, MK, spec, c, ln,
                                     dict(mode="kmer"), n=3, warm=1)
    dev_ms = kernel_device_ms(
        torch, MK.launcher(spec, c, ln, mode="kmer"), n=5)
    print_times(f"sketch kmer dense B={crib_rows} L={L} k={K} (one crib "
                f"row group; plain over 2x3 calls, device over 5)",
                (ms, plain_ms, dev_ms), (crib_rows, L, L - K + 1, K, "kmer"))
    del c, ln, got, ref
    torch.cuda.empty_cache()
    return err, ms, plain_ms, dev_ms


def tile_geometry(P, k, w, mode):
    """(own positions per tile, halo) of csrc/minimizer.cu's geometry()."""
    halo = w - 1 if mode == "minimizer" else 0
    want = -(-P // -(-P // 1024))
    n = -(-(want + 2 * halo) // 32) | 1
    return 32 * n - 2 * halo, halo


def _tile_rows(rng, B, L, k, w, mode):
    """Rows aimed at the tile kernel's edges.  At every edge t0 between two
    tiles each row from 5 on gets one of: an N at the first base of the
    tile's left halo, an N at the last base of the previous tile's right
    halo, a run of exactly w - 1, w or w + 1 valid positions straddling
    t0, or a k-mer repeated w - 1 positions later (equal hashes at both
    ends of a window).  Row 0 is poly-A (every hash equal), rows 1-4 have
    k - 1, k, L and k + w - 2 bases; the rest are ragged, with scattered
    Ns."""
    P = L - k + 1
    T, halo = tile_geometry(P, k, w, mode)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.001] = 4
    lengths = np.where(rng.random(B) < 0.5, L,
                       rng.integers(0, L + 1, size=B)).astype(np.int32)
    for t0 in range(T, P, T):
        for r in range(5, B):
            kind = (r + t0 // T) % 6
            if kind < 2:
                i = t0 - halo if kind == 0 else t0 + halo + k - 2
                if 0 <= i < L:
                    codes[r, i] = 4
            elif kind < 5:
                run = max(w - 3 + kind, 1)            # w - 1, w, w + 1
                st = t0 - int(rng.integers(0, run + 1))
                end = min(st + run + k - 1, L)        # first base past it
                codes[r, max(st, 0):end] &= 3
                if st >= 1:
                    codes[r, st - 1] = 4
                if end < L:
                    codes[r, end] = 4
            else:
                p = max(t0 - int(rng.integers(0, w)), 0)
                q = p + w - 1
                if q + k <= L:
                    codes[r, p:p + k] &= 3
                    codes[r, q:q + k] = codes[r, p:p + k]
    codes[0] = 0
    lengths[:4] = [L, k - 1, k, L]
    lengths[4] = min(L, k + w - 2)
    return codes, lengths


def phase_tile_fuzz(torch, MK, HashSpec):
    """Seeded parity cases at the tile kernel's risks, every mode, dense and
    compacted: rows spanning many tiles (L = 32,768 in minimizer and
    syncmer modes), w = 1, k = 31, s = 1 and s = k - 1, m = 1 and 65521,
    compact rows that overflow C in their first tile, B not a multiple of
    the warps per block, w = P, the widest tile window (4096) and one past
    it (the wide route; phase_wide has its own cases), and rows at
    unaligned addresses.  Returns max_abs_err."""
    rng = np.random.default_rng(SEED + 4)
    wmax = MK.build().h10x_max_tile_w()
    cases = [  # (mode, k, w, kw, B, L, compact widths[, base offset])
        ("minimizer", 21, 11, {}, 64, 1 << 15, (0, 64, 8000)),
        ("syncmer", 21, 11, {"syncmer_s": 11}, 64, 1 << 15, (0, 64, 8000)),
        ("minimizer", 4, 1, {}, 257, 3000, (0, 16)),
        ("minimizer", 31, 64, {}, 257, 3000, (0, 32, 400)),
        ("minimizer", 21, 100, {}, 257, 3000, (0, 50)),
        ("minimizer", 21, wmax, {}, 33, 3 * wmax, (0, 8)),
        ("minimizer", 21, wmax + 1, {}, 33, 3 * wmax, (0, 8)),
        ("minimizer", 21, 11, {}, 4093, READ_LEN, (0, 8, 64)),
        ("minimizer", 21, 130, {}, 4093, READ_LEN, (0, 8)),
        ("kmer", 31, 11, {}, 1001, 2500, (0, 16)),
        ("modimizer", 21, 11, {"m": 1}, 1001, 2500, (0, 16)),
        ("modimizer", 16, 11, {"m": 65521}, 1001, 2500, (0, 16)),
        ("syncmer", 21, 11, {"syncmer_s": 1}, 1001, 2500, (0, 100)),
        ("syncmer", 21, 11, {"syncmer_s": 20}, 1001, 2500, (0, 100)),
        ("syncmer", 31, 11, {"syncmer_s": 30}, 513, 2500, (0, 100)),
    ]
    # rows at every offset mod 16 from a base that is itself unaligned, and
    # B * L not a multiple of 16: the first and last rows' partial chunks
    cases = [case + (0,) for case in cases] + [
        ("minimizer", 21, 11, {}, 1001, 151, (0, 8), 3),
        ("kmer", 21, 11, {}, 33, 2501, (0,), 7),
        ("syncmer", 21, 11, {"syncmer_s": 11}, 257, 1999, (0, 40), 13),
    ]
    max_err = 0.0
    for mode, k, w, kw, B, L, widths, off in cases:
        spec = HashSpec(k=k, w=w, seed=SEED)
        codes, lengths = _tile_rows(rng, B, L, k, w, mode)
        T, _ = tile_geometry(L - k + 1, k, w, mode)
        max_err = max(max_err, check_parity(
            torch, MK, spec, codes, lengths, widths, dict(mode=mode, **kw),
            f"tile fuzz {mode} k={k} w={w} {kw} B={B} L={L}",
            f"offset {off} (tile {T} positions)", off))
    return max_err


def check_parity(torch, MK, spec, codes, lengths, widths, kw, what,
                 note="", off=0):
    """Kernel == plain bit for bit on all four outputs at each compact
    width, with the rows starting ``off`` bytes into a device buffer.
    Returns max_abs_err."""
    dev = torch.device("cuda")
    B, L = codes.shape
    buf = torch.empty(off + B * L, dtype=torch.uint8, device=dev)
    c = buf[off:].view(B, L)
    c.copy_(torch.from_numpy(codes))
    ln = torch.from_numpy(lengths).to(dev)
    max_err = 0.0
    for C in widths:
        got = MK.sketch(spec, c, ln, compact_to=C, **kw)
        torch.cuda.synchronize()
        ref = MK.sketch_plain(spec, c, ln, compact_to=C, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"{what} C={C} {note}: {'equal' if same else 'DIFFERENT'} "
              f"(emitted {int(got[2].sum())}, overflow {int(got[3].sum())})")
        if not same:
            fail(f"kernel != plain: {what} C={C}")
    return max_err


WIDE_B, WIDE_L, WIDE_W = 4096, 1 << 15, 5000  # the crib's geometry
WIDE_SUBSET = 64     # rows of the full-card shape held against the plain
WIDE_CLI_W = 5000    # -w of the CLI check on the ragged lane


def _wide_rows(rng, B, L, k, w):
    """Rows aimed at the wide route's block edges (multiples of w): at each
    edge t0 a row from 5 on gets one of an N making position t0 the first
    invalid one, an N making t0 - 1 the last invalid one, or a run of
    w - 1, w or w + 1 valid positions straddling t0.  Row 0 is poly-A
    (every hash ties), rows 1-4 have k - 1, k, L and k + w - 2 bases; the
    rest are ragged, with scattered Ns."""
    P = L - k + 1
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.0005] = 4
    lengths = np.where(rng.random(B) < 0.5, L,
                       rng.integers(0, L + 1, size=B)).astype(np.int32)
    for t0 in range(w, P, w):
        for r in range(5, B):
            kind = (r + t0 // w) % 5
            if kind == 0:
                codes[r, t0 + k - 1] = 4
            elif kind == 1:
                codes[r, t0 - 1] = 4
            else:
                run = w - 3 + kind                    # w - 1, w, w + 1
                st = t0 - int(rng.integers(1, run))
                end = min(st + run + k - 1, L)        # first base past it
                codes[r, st:end] &= 3
                if st >= 1:
                    codes[r, st - 1] = 4
                if end < L:
                    codes[r, end] = 4
    codes[0] = 0
    lengths[:5] = [L, k - 1, k, L, min(L, k + w - 2)]
    return codes, lengths


def phase_wide(torch, MK, HashSpec):
    """The wide route (minimizer windows wider than the tile kernel's):
    kernel == plain bit for bit, dense and compacted, at w = 4,097, 5,000
    and 8,191 on rows of 3w positions aimed at the block edges, at w > P,
    at B not a multiple of the compaction's rows per block, at an
    unaligned base offset, and on a 64-row subset of the full-card shape
    (4,096 x 32,768, w = 5,000, dense and C = 64).  Times: the PERF row's
    shape (33 x 12,288, w = 4,097, dense; device, wrapper and plain), the
    full-card shape (device and wrapper, dense and C = 64), the tile kernel
    at w = 4,096 beside the wide route at w = 4,097 on it, and the CLI
    check's shape (1,024 reads of 150 bases, w = 5,000, the engine's C).
    Returns (max_abs_err, ms, plain_ms, device_ms, shape) at the CLI
    check's shape for the kernels line."""
    from hash10x_tpu_torch.kernels.minimizer import sketch_bound
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    wmax = MK.build().h10x_max_tile_w()
    cases = [  # (w, B, L, compact widths, base offset)
        (wmax + 1, 33, 3 * (wmax + 1) + K - 1, (0, 8, 64), 0),
        (5000, 37, 3 * 5000 + K - 1, (0, 8, 64), 0),
        (8191, 33, 3 * 8191 + K - 1, (0, 8), 0),
        (5000, 129, 3000, (0, 1, 8), 0),             # w > P: short runs
        (wmax + 1, 33, 3 * (wmax + 1) + K + 9, (0, 16), 5),
    ]
    max_err = 0.0
    for w, B, L, widths, off in cases:
        codes, lengths = _wide_rows(rng, B, L, K, w)
        max_err = max(max_err, check_parity(
            torch, MK, HashSpec(k=K, w=w, seed=SEED), codes, lengths,
            widths, {}, f"wide w={w} B={B} L={L}", f"offset {off}", off))

    def times(what, spec, c, ln, C, plain=True, n=5):
        dms = kernel_device_ms(torch, MK.launcher(spec, c, ln, compact_to=C),
                               n=n)
        ms, plain_ms = time_kernel_plain(torch, MK, spec, c, ln,
                                         dict(compact_to=C), n=max(n // 2, 3),
                                         warm=1, plain=plain)
        B, L = c.shape
        nbytes, ops, bound, by = sketch_bound(B, L, C or L - spec.k + 1,
                                              spec.k)
        print(f"{what} B={B} L={L} w={spec.w} C={C}: {dms:.5f} device ms "
              f"per launch (over {n}); wrapper {ms:.5f} ms/call, plain "
              f"{'not timed' if plain_ms is None else f'{plain_ms:.4f}'} "
              f"ms/call (CUDA events over 2x3 calls each); {nbytes} bytes, "
              f"{ops} operations, bound {bound:.5f} ms ({by}); bound share "
              f"{bound / dms:.4f}")
        return ms, plain_ms, dms

    # the PERF row's shape, as timed since the route was added
    spec = HashSpec(k=K, w=wmax + 1, seed=SEED)
    L = 3 * wmax
    codes, lengths = _tile_rows(rng, 33, L, K, wmax + 1, "minimizer")
    times("wide route", spec, torch.from_numpy(codes).to(dev),
          torch.from_numpy(lengths).to(dev), 0)

    # the full-card shape: genome rows (N blocks, short rows, ragged tails)
    codes, lengths = _genome_rows(rng, WIDE_B, WIDE_L, K)
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    del codes
    spec = HashSpec(k=K, w=WIDE_W, seed=SEED)
    for C in (0, 64):
        got = MK.sketch(spec, c, ln, compact_to=C)
        torch.cuda.synchronize()
        sub = slice(0, WIDE_SUBSET)
        ref = MK.sketch_plain(spec, c[sub], ln[sub], compact_to=C)
        torch.cuda.synchronize()
        same = all(torch.equal(a[sub], b) for a, b in zip(got, ref))
        max_err = max(max_err, float((got[0][sub] - ref[0]).abs().max()))
        print(f"wide w={WIDE_W} B={WIDE_B} L={WIDE_L} C={C}: rows "
              f"0-{WIDE_SUBSET - 1} {'equal' if same else 'DIFFERENT'} "
              f"(emitted {int(got[2].sum())} in all rows, overflow "
              f"{int(got[3].sum())})")
        if not same:
            fail(f"kernel != plain: wide full-card shape C={C}")
        del got, ref
        times("wide route", spec, c, ln, C, plain=False)
    lengths = torch.full_like(ln, WIDE_L)
    for w in (wmax, wmax + 1):
        times("tile kernel" if w <= wmax else "wide route",
              HashSpec(k=K, w=w, seed=SEED), c, lengths, 0, plain=False)
    del c, ln, lengths
    torch.cuda.empty_cache()

    # the CLI check's shape, for the kernels line
    spec = HashSpec(k=K, w=WIDE_CLI_W, seed=SEED)
    codes, lengths = _batch(rng, 1024, READ_LEN, K, WIDE_CLI_W)
    lengths[:] = READ_LEN
    C = 24  # Engine._compact_rows(130) at w = 5,000
    ms, plain_ms, dms = times(
        "wide route", spec, torch.from_numpy(codes).to(dev),
        torch.from_numpy(lengths).to(dev), C, n=20)
    return max_err, ms, plain_ms, dms, (1024, READ_LEN, C, K, "minimizer")


class StageLog(io.StringIO):
    """A stderr stream that records the kernel counters after each stage
    line, so launches inside one stage of a CLI run can be read off."""

    def __init__(self, MK):
        super().__init__()
        self.MK = MK
        self.marks = []   # (stage label, launches, plain calls)

    def write(self, text):
        if text.startswith("["):
            self.marks.append((text[1:text.index("]")], self.MK.LAUNCHES,
                               self.MK.PLAIN_CALLS))
        return super().write(text)

    def launches_in(self, prefix):
        for i, (label, n, _) in enumerate(self.marks):
            if label.startswith(prefix):
                return n - (self.marks[i - 1][1] if i else 0)
        fail(f"no {prefix} stage line")


def write_fasta(path, name, codes):
    from hash10x_tpu_torch.core.encode import codes_to_ascii
    with open(path, "wb") as f:
        f.write(b">" + name + b"\n" + codes_to_ascii(codes) + b"\n")


def phase_crib(torch, MK, run, tmp):
    """Phase 11: the diploid lane through the crib on CUDA."""
    from hash10x_tpu_torch.io.fqb import from_read_batch, save_fqb
    from hash10x_tpu_torch.io.sim import SimConfig, simulate
    t0 = time.monotonic()
    sim = simulate(SimConfig(genome_len=CRIB_GENOME, n_barcodes=N_CODES,
                             molecules_per_barcode=1, molecule_len=30_000,
                             reads_per_molecule=N_READS // N_CODES,
                             read_len=READ_LEN, het_rate=0.001))
    lane = os.path.join(tmp, "diploid.fqb")
    save_fqb(lane, from_read_batch(sim.reads))
    fas = [os.path.join(tmp, f"h{i + 1}.fa") for i in range(2)]
    write_fasta(fas[0], b"hap1", sim.genome)
    write_fasta(fas[1], b"hap2", sim.genome_hap1)
    n_het = int((sim.genome != sim.genome_hap1).sum())
    del sim
    print(f"crib lane: {N_READS} reads, {N_CODES} barcodes, two "
          f"{CRIB_GENOME / 1e6:g} Mb haplotypes with {n_het} het sites "
          f"(built and written in "
          f"{time.monotonic() - t0:.1f} s)")
    argv = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
            "--minCount", "2", "--maxCount", "64", "--friendShare", "8",
            "--readFQB", lane, "--codeClusters", "--cribBuild", *fas,
            "--cribReport"]
    out, err = io.StringIO(), StageLog(MK)
    torch.cuda.reset_peak_memory_stats()
    MK.LAUNCHES = 0
    MK.PLAIN_CALLS = 0
    t0 = time.monotonic()
    run(argv, out, err)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    crib_launches = err.launches_in("cribBuild")
    plain = MK.PLAIN_CALLS
    if crib_launches <= 0 or plain != 0:
        fail(f"cribBuild: kernel launches {crib_launches}, plain calls "
             f"{plain}")
    text = out.getvalue()
    totals = [l for l in text.splitlines() if l.startswith("crib totals")]
    overall = [l for l in text.splitlines()
               if l.startswith("crib overall purity")]
    if not totals or not overall:
        fail("crib report lacks its totals or its overall purity")
    purity = float(overall[0].split()[3])
    walls = stage_walls(err.getvalue())
    print(f"crib: {totals[0]}; {overall[0]}; kernel launches in cribBuild "
          f"{crib_launches} (row groups), plain calls 0; walls (s): "
          f"cribBuild {walls['cribBuild']:.3f}, cribReport "
          f"{walls['cribReport']:.3f}, count {walls['count']:.3f}, "
          f"cluster {walls['cluster']:.3f}; {text.count(chr(10))} report "
          f"lines; CLI wall {wall:.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if purity < 0.85:
        fail(f"crib overall purity {purity} < 0.85")
    return crib_launches


def molecules(err_text):
    line = [l for l in err_text.splitlines() if l.startswith("[cluster:")][0]
    return int(line.split()[1])


def phase_legacy(torch, MK, run, lane):
    """Phase 12: pair mode and capped friend mode on the 800k lane."""
    for name, flags in (("pair", ["--clusterMode", "pair", "--minShare",
                                  "2"]),
                        ("capped friend", ["--maxFriends", "256"])):
        argv = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
                "--minCount", "2", "--maxCount", "64", "--friendShare", "8",
                *flags, "--readFQB", lane, "--codeClusters",
                "--clusterSplit", "--clusterReport"]
        out, err, eng, n, wall = run_counted(torch, MK, run, argv)
        walls = stage_walls(err)
        phases = {"count": walls["count"],
                  "filter+incidence": walls["filter"] + walls["incidence"],
                  "cluster": walls["cluster"], "split": walls["split"],
                  "report": walls["report"]}
        total = sum(phases.values())
        print(f"legacy {name}: {molecules(err)} molecules over "
              f"{eng.inc.n_codes} codes, {eng.inc.n_pairs} incidence pairs; "
              f"kernel launches {n}, plain calls 0; walls (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
              + f"; sum {total:.3f}; CLI wall {wall:.3f}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        if f"code {N_CODES - 1} nKmers" not in out:
            fail(f"{name} lane output lacks report lines")
        del eng


def phase_cuda_vs_cpu_legacy(run, tmp):
    """Phase 13: CUDA and CPU byte-identical on phase 6's 20k lane in pair
    mode, capped friend mode and the crib (2 Mb haplotypes: phase 6's
    genome and a copy with SNPs at a 0.001 rate)."""
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)  # phase 6's
    hap2 = genome.copy()
    snp = np.random.default_rng(SEED + 3).random(len(genome)) < 0.001
    hap2[snp] = (hap2[snp] + 1) % 4
    fas = [os.path.join(tmp, f"small_h{i}.fa") for i in (1, 2)]
    write_fasta(fas[0], b"chr1", genome)
    write_fasta(fas[1], b"chr1b", hap2)
    lane = os.path.join(tmp, "ragged.fqb")
    for name, flags in (
            ("--clusterMode pair", ["--clusterMode", "pair", "--minShare",
                                    "2", "--codeClusters"]),
            ("--maxFriends 16", ["--maxFriends", "16", "--codeClusters"]),
            ("crib", ["--codeClusters", "--cribBuild", *fas,
                      "--cribReport"])):
        outs = []
        for dev in ("cuda", "cpu"):
            out = io.StringIO()
            dump = os.path.join(tmp, f"legacy_{dev}.clusters")
            run(["--device", dev, "-k", str(K), "-w", str(W), "-r",
                 str(SEED), "--batchReads", "1024", "--friendShare", "4",
                 "--readFQB", lane, *flags, "--clusterSplit",
                 "--clusterReport", "--writeClusters", dump], out,
                io.StringIO())
            with open(dump) as fh:
                outs.append((out.getvalue(), fh.read()))
        if outs[0] != outs[1]:
            fail(f"CUDA and CPU runs differ with {name}")
        print(f"cuda vs cpu {name}: 20k lane, stdout "
              f"({outs[0][0].count(chr(10))} lines) and cluster dump "
              "byte-identical")


def write_fastq(path, fqb, chunk=1 << 20):
    """The lane as FASTQ: each read is its barcode id as a 16 bp barcode
    (base 0 in the top bits, so the sorted keys are the ids) and its
    bases, unpacked from the .fqb's 2-bit words ``chunk`` reads at a time
    into fixed-length records."""
    letters = bytes(range(256)).replace(b"\0\1\2\3", b"ACGT")
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    L = fqb.read_len
    S = 16 + L
    with open(path, "wb") as f:
        for a in range(0, len(fqb), chunk):
            b = min(a + chunk, len(fqb))
            byte = fqb.packed[a:b].view(np.uint8)
            rec = np.empty((b - a, 3 + S + 3 + S + 1), np.uint8)
            rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
            rec[:, 3:19] = (fqb.barcode_ids[a:b, None].astype(np.uint32)
                            >> shifts) & 3
            for j in range(4):          # base 4i + j is bits 2j of byte i
                rec[:, 19 + j:3 + S:4] = (byte[:, :(L - j + 3) // 4]
                                          >> (2 * j)) & 3
            rec[:, 3 + S:6 + S] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, 6 + S:6 + 2 * S] = ord("I")
            rec[:, -1] = ord("\n")
            # codes 0-3 become ACGT; the literal bytes are all above 3
            f.write(rec.tobytes().translate(letters))


def phase_observe(torch, MK, run, tmp, main_text):
    """Phase 14: the observability flags and the native FASTQ loader."""
    import glob
    from hash10x_tpu_torch.io import fqb as FB
    from hash10x_tpu_torch.io import native_loader
    metrics = os.path.join(tmp, "metrics.jsonl")
    trace_dir = os.path.join(tmp, "trace")
    err = io.StringIO()
    run(["--metrics", metrics, "--devMem", "--profile", trace_dir,
         "-k", str(K), "-w", str(W), "-r", str(SEED), "--batchReads",
         "1024", "--friendShare", "4", "--readFQB",
         os.path.join(tmp, "ragged.fqb"), "--hashInfo", "--codeClusters",
         "--clusterSplit", "--clusterReport"], io.StringIO(), err)
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    if not recs or not all("hbm_in_use_mb" in r for r in recs):
        fail("--metrics --devMem: a JSONL line lacks hbm_in_use_mb")
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"--profile wrote {len(traces)} trace files")
    with open(traces[0]) as f:
        trace = f.read()
    if "sketch_kernel" not in trace:
        fail("the --profile trace does not name the sketch kernel")
    print(f"observe: {len(recs)} JSONL stages, all with hbm_in_use_mb "
          f"(max {max(r['hbm_in_use_mb'] for r in recs):.1f} MB); trace "
          f"{os.path.getsize(traces[0]) / 1e6:.1f} MB names sketch_kernel "
          f"{trace.count('sketch_kernel')} times")

    fq = os.path.join(tmp, "lane.fastq")
    t0 = time.monotonic()
    write_fastq(fq, FB.load_fqb(os.path.join(tmp, "lane.fqb")))
    print(f"fastq: {os.path.getsize(fq) / 1e9:.3f} GB written in "
          f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    if not native_loader.available():
        fail("the native FASTQ loader did not build on this host")
    build_s = time.monotonic() - t0
    t0 = time.monotonic()
    native = FB.fastq_to_fqb(fq)
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    plain = FB.fastq_to_fqb(fq, prefer_native=False)
    plain_s = time.monotonic() - t0
    same = all((getattr(native, f) == getattr(plain, f)).all()
               for f in ("packed", "lengths", "barcode_ids", "barcode_keys"))
    if not same or plain.nmask is not None or native.nmask is not None:
        fail("native loader Fqb != numpy parser Fqb")
    n_reads = len(native)
    del native, plain
    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    run(["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
         "--minCount", "2", "--maxCount", "64", "--friendShare", "8",
         "--readFastq", fq, "--hashInfo", "--hashDist", "--codeClusters",
         "--clusterSplit", "--clusterReport"], out, err)
    wall = time.monotonic() - t0
    if out.getvalue() != main_text:
        fail("--readFastq report != the .fqb report of phase 4")
    print(f"readFastq: native loader (built in {build_s:.3f} s) "
          f"{native_s:.3f} s vs numpy parser {plain_s:.3f} s for "
          f"{n_reads} reads, equal Fqb; CLI stdout "
          f"({main_text.count(chr(10))} lines) byte-identical to phase 4; "
          f"CLI wall {wall:.3f} s")


# -- phases 15-18: the sharded and multi-process paths --------------------------

SLOTS = re.compile(r"^table slots \d+ ", re.M)


def masked(text):
    """Stdout with the number after ``table slots`` masked: each path grows
    its table (or shards) on its own schedule."""
    return SLOTS.sub("table slots N ", text)


def shard_walls(err_text):
    """Seconds per stage (count, filter+incidence, cluster, split, report)
    from stage lines, sharded labels folded in ("count[sharded x4]" ->
    count); other stderr lines are skipped."""
    walls = {}
    for line in err_text.splitlines():
        if not line.startswith("[") or "] wall " not in line:
            continue
        label = line[1:].split(":")[0].split("[")[0].split(" ")[0]
        walls[label] = walls.get(label, 0.0) + float(
            line.split("] wall ")[1].split("s")[0])
    return {"count": walls.get("count", 0.0),
            "filter+incidence": walls.get("filter", 0.0)
            + walls.get("incidence", 0.0),
            "cluster": walls.get("cluster", 0.0),
            "split": walls.get("split", 0.0),
            "report": walls.get("report", 0.0)}


def print_walls(what, walls, extra=""):
    print(f"{what} walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items())
        + f"; sum {sum(walls.values()):.3f}{extra}")


def stage_lines(err_text):
    return [line for line in err_text.splitlines()
            if line.startswith("[") and "] wall " in line]


def write_dumps(eng, tmp, tag):
    """The engine's --writeCounts and --writeClusters text as files."""
    paths = [os.path.join(tmp, f"{tag}.{x}") for x in ("counts", "clusters")]
    with open(paths[0], "w") as f:
        eng.write_counts(f)
    with open(paths[1], "w") as f:
        eng.write_clusters(f)
    return paths


def same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def lane_argv(lane, *flags):
    return ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
            "--minCount", "2", "--maxCount", "64", "--friendShare", "8",
            *flags, "--readFQB", lane, "--hashInfo", "--hashDist",
            "--codeClusters", "--clusterSplit", "--clusterReport"]


def check_replays(what, eng, ES, launches, limit=None):
    """The engine's steps since its counts were set to 0 were each one
    CUDA graph replay holding one sketch launch: launches = replays + one
    warm-up launch per captured graph (and below ``limit``).  Returns
    (steps, replays, graphs)."""
    steps, replays = eng.stats["dispatches"], ES.REPLAYS
    graphs = list(eng._lane_cache[4]._graphs.values())
    if (replays != steps or any(g.launches != 1 for g in graphs)
            or launches != replays + len(graphs)
            or (limit is not None and launches >= limit)):
        fail(f"{what}: {steps} steps, {replays} replays of {len(graphs)} "
             f"graphs, {launches} kernel launches (limit {limit})")
    return steps, replays, len(graphs)


def phase_shards(torch, MK, ES, run, lane, tmp, main_text, main_dumps,
                 n_batches):
    """Phase 15: the 800k lane with --shards 4 and --shards 2 through the
    CLI on CUDA: stdout and both dumps byte-identical to phase 4's; every
    step of both passes one CUDA graph replay holding one sketch launch,
    fewer launches than one per batch and pass."""
    for n in (4, 2):
        dumps = [os.path.join(tmp, f"shards{n}.{x}")
                 for x in ("counts", "clusters")]
        argv = lane_argv(lane, "--shards", str(n)) + [
            "--writeCounts", dumps[0], "--writeClusters", dumps[1]]
        ES.REPLAYS = 0
        out, err, eng, launches, wall = run_counted(torch, MK, run, argv)
        steps, replays, graphs = check_replays(f"--shards {n}", eng, ES,
                                               launches, 2 * n_batches)
        del eng
        print(f"shards {n}: {steps} steps over {n_batches} batches per pass "
              f"(count and incidence), {replays} CUDA graph replays of "
              f"{graphs} captured graphs, kernel launches {launches} (one "
              f"per batch and pass: {2 * n_batches})")
        if masked(out) != masked(main_text):
            fail(f"--shards {n} stdout != phase 4's")
        for a, b in zip(dumps, main_dumps):
            if not same_files(a, b):
                fail(f"--shards {n} {os.path.basename(a)} != phase 4's")
        print("\n".join(f"shards {n} stage {line}"
                        for line in stage_lines(err)))
        print_walls(f"shards {n}", shard_walls(err),
                    f"; CLI wall {wall:.3f}; kernel launches {launches}, "
                    f"plain calls 0; peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        print(f"shards {n}: stdout ({out.count(chr(10))} lines), counts and "
              "clusters dumps byte-identical to phase 4")


def phase_lanes(torch, MK, run, lane, tmp, main_text, main_dumps):
    """Phase 16: lanes too small for the lane (the retry doubles them, the
    output is unchanged) and blocked label propagation (labels unchanged)."""
    out, err, eng, _, wall = run_counted(
        torch, MK, run, lane_argv(lane, "--shards", "4", "--laneCapacity",
                                  "4096"))
    grown = eng.cfg.lane_capacity
    del eng
    retries = [line for line in stage_lines(err) if "lane overflow" in line]
    if not retries or grown <= 4096:
        fail("--laneCapacity 4096 did not overflow and retry")
    if masked(out) != masked(main_text):
        fail("--laneCapacity retry changed the output")
    print("\n".join(f"lanes retry: {line}" for line in retries))
    print(f"lanes: --laneCapacity 4096 grew to {grown}; stdout "
          f"byte-identical to phase 4; CLI wall {wall:.3f}")
    clusters = os.path.join(tmp, "blocks.clusters")
    out, err, eng, _, wall = run_counted(
        torch, MK, run, lane_argv(lane, "--shards", "4", "--labelBlocks",
                                  str(1 << 20))
        + ["--writeClusters", clusters])
    del eng
    if masked(out) != masked(main_text) or not same_files(clusters,
                                                           main_dumps[1]):
        fail("--labelBlocks changed the labels")
    print_walls("lanes --labelBlocks 1048576", shard_walls(err),
                f"; CLI wall {wall:.3f}; report and clusters dump "
                "byte-identical to phase 4")


_HOST_MAIN = ("import sys\n"
              "from hash10x_tpu_torch.cli.main import run\n"
              "from hash10x_tpu_torch.kernels import minimizer as MK\n"
              "eng = run(sys.argv[1:], sys.stdout, sys.stderr)\n"
              "sys.stderr.write(f'launches {MK.LAUNCHES} plain calls "
              "{MK.PLAIN_CALLS} steps {eng.stats[\"dispatches\"]}\\n')\n")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_hosts(tmp, argv, n=2, timeout=600):
    """``n`` CLI processes joined over gloo on this card, each under a hard
    timeout; returns [(stdout, stderr, wall)] by process id."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOST_MAIN, "--hosts", str(n), "--hostId",
         str(i), "--coordinator", f"127.0.0.1:{port}"] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp,
        env=env) for i in range(n)]
    res = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            res.append((o, e, time.monotonic() - t0))
            if p.returncode != 0:
                fail(f"--hosts process exited {p.returncode}: {e[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def split_lane(tmp, reads, bc_ids):
    """The lane as two barcode-disjoint .fqb files (barcode parity), each
    with its own local barcode ids."""
    from hash10x_tpu_torch.core.encode import pack_2bit
    from hash10x_tpu_torch.io.fqb import Fqb, save_fqb
    for pid in range(2):
        sel = bc_ids % 2 == pid
        keys = np.unique(bc_ids[sel]).astype(np.uint32)
        save_fqb(os.path.join(tmp, f"half{pid}.fqb"), Fqb(
            packed=pack_2bit(reads[sel]),
            lengths=np.full(int(sel.sum()), READ_LEN, np.int32),
            barcode_ids=np.searchsorted(keys, bc_ids[sel]).astype(np.int32),
            barcode_keys=keys, read_len=READ_LEN))


def phase_hosts(lane, tmp, reads, bc_ids, main_text, n_batches):
    """Phase 17: two processes sharing the card over gloo (--hosts 2
    --shards 4), the whole lane in each and the lane split into two
    barcode-disjoint files: the coordinator's stdout is phase 4's, the other
    process prints nothing; each process sends eager stacked steps, one
    sketch launch each, fewer than one per batch and pass."""
    split_lane(tmp, reads, bc_ids)
    for src in (["--readFQB", lane],
                ["--readFQBShard", os.path.join(tmp, "half{host}.fqb")]):
        argv = [a for a in lane_argv(lane, "--shards", "4")
                if a not in ("--readFQB", lane)]
        i = argv.index("--hashInfo")
        argv = argv[:i] + src + argv[i:]
        res = run_hosts(tmp, argv)
        (out0, err0, _), (out1, err1, _) = res
        if masked(out0) != masked(main_text):
            fail(f"--hosts 2 {src[0]}: the coordinator's stdout != phase 4's")
        if out1.strip():
            fail(f"--hosts 2 {src[0]}: process 1 wrote to stdout")
        for pid, (_, e, wall) in enumerate(res):
            launch = [line for line in e.splitlines()
                      if line.startswith("launches ")]
            words = launch[0].split() if launch else []
            if (len(words) != 7 or words[1] == "0" or words[4] != "0"
                    or words[1] != words[6]
                    or int(words[1]) >= 2 * n_batches):
                fail(f"--hosts 2 process {pid}: {launch} (one launch per "
                     f"step, fewer than {2 * n_batches})")
            print("\n".join(f"hosts {src[0]} process {pid} stage {line}"
                            for line in stage_lines(e)))
            print_walls(f"hosts {src[0]} process {pid}", shard_walls(e),
                        f"; process wall {wall:.3f}; {launch[0]}")
        print(f"hosts {src[0]}: coordinator stdout byte-identical to "
              "phase 4, process 1 stdout empty")


def phase_cuda_vs_cpu_shards(run, tmp):
    """Phase 18: CUDA and CPU byte-identical with --shards 4 on the 20k
    lane of phase 6."""
    outs = []
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        files = [os.path.join(tmp, f"ragged4_{dev}.{x}")
                 for x in ("counts", "clusters")]
        run(["--device", dev, "--shards", "4", "-k", str(K), "-w", str(W),
             "-r", str(SEED), "--batchReads", "1024", "--friendShare", "4",
             "--readFQB", os.path.join(tmp, "ragged.fqb"), "--hashInfo",
             "--hashDist", "--codeClusters", "--clusterSplit",
             "--clusterReport", "--writeCounts", files[0],
             "--writeClusters", files[1]], out, io.StringIO())
        texts = [out.getvalue()]
        for f in files:
            with open(f) as fh:
                texts.append(fh.read())
        outs.append(texts)
    if outs[0] != outs[1]:
        fail("CUDA and CPU runs differ with --shards 4 on the ragged lane")
    print(f"cuda vs cpu --shards 4: 20k ragged lane, stdout "
          f"({outs[0][0].count(chr(10))} lines) and dumps byte-identical")


SHARD_STEP_FLUSH = (16, 5, 1)


def phase_shard_steps(torch, MK, ES, lane, main_text, main_dumps, tmp,
                      n_batches):
    """Phase 21: the 800k lane through the library API at --shards 4 (one
    card) with flush_batches 16, 5 and 1: report and dumps byte-identical
    to phase 4's; per setting the steps, replays and launches of the first
    count and incidence pass (every step one graph replay holding one
    sketch launch), and its count and filter+incidence walls (captures
    included) and those of two warm reset() passes."""
    from hash10x_tpu_torch.engine import Engine, EngineConfig
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.io.fqb import load_fqb
    fqb = load_fqb(lane)
    want = "".join(line for line in main_text.splitlines(True)
                   if line.startswith("code "))
    for fb in SHARD_STEP_FLUSH:
        eng = Engine(EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                                  table_bits=22, min_count=2, max_count=64,
                                  min_friend_share=8, n_shards=4,
                                  flush_batches=fb), "cuda", log=None)
        MK.LAUNCHES = MK.PLAIN_CALLS = ES.REPLAYS = 0
        first = timed_passes(torch, eng, fqb)
        launches, plain = MK.LAUNCHES, MK.PLAIN_CALLS
        if launches <= 0 or plain:
            fail(f"shard steps S={fb}: kernel launches {launches}, plain "
                 f"calls {plain}")
        steps, replays, graphs = check_replays(
            f"shard steps S={fb}", eng, ES, launches,
            2 * n_batches if fb > 1 else None)
        eng.cluster()
        eng.split()
        out = io.StringIO()
        eng.report(out)
        dumps = write_dumps(eng, tmp, "shard_steps")
        if out.getvalue() != want or not all(
                same_files(a, b) for a, b in zip(dumps, main_dumps)):
            fail(f"shard steps S={fb}: report or dumps != phase 4's")
        warm = [timed_passes(torch, eng, fqb) for _ in range(2)]
        print(f"shard steps --shards 4 flush_batches {fb}: report, counts "
              f"and clusters dumps byte-identical to phase 4; {steps} steps "
              f"over {n_batches} batches per pass (count and incidence), "
              f"{replays} replays of {graphs} graphs, kernel launches "
              f"{launches}, plain calls 0; walls (s) first pass (captures "
              f"included) count {first['count_s']:.4f} filter+incidence "
              f"{first['filter_incidence_s']:.4f}; warm passes "
              + "; ".join(f"count {w['count_s']:.4f} filter+incidence "
                          f"{w['filter_incidence_s']:.4f}" for w in warm))
        del eng


def phase_join_graphs(torch, MK, ES, tmp):
    """Phase 22: CUDA = CPU at -k 31 on phase 6's 20k ragged lane through
    the library API, on one GPU and at --shards 4.  At k = 31 the
    incidence keys by the retained join (no combined key fits) and the
    count pass's segmented dedup takes its extra sort (62-bit hashes leave
    no bits for the batch index).  On each Engine a second band
    (min_count 3) and incidence follow the first, so the join graph (one
    GPU) and the sharded pair graph (--shards 4) are captured again: the
    report and clusters dump of both bands and the counts dump are
    byte-identical between CUDA and the CPU and between one GPU and
    --shards 4.  Then the lane as one process's --readFQBShard file at
    --shards 4: the same first band, and no graph captured twice (the
    global-id lane and its graphs are cached with it)."""
    from hash10x_tpu_torch.engine import Engine, EngineConfig
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.io.fqb import load_fqb
    from hash10x_tpu_torch.table.incidence import combined_key_bits
    fqb = load_fqb(os.path.join(tmp, "ragged.fqb"))
    if combined_key_bits(31, fqb.n_barcodes):
        fail("-k 31: the ragged lane would take combined keys")
    texts = {}
    for shards in (1, 4):
        for dev in ("cuda", "cpu"):
            eng = Engine(EngineConfig(spec=HashSpec(k=31, w=W, seed=SEED),
                                      batch_reads=1024, min_friend_share=4,
                                      n_shards=shards), dev, log=None)
            MK.LAUNCHES = MK.PLAIN_CALLS = 0
            eng.count(fqb)
            out = []
            for lo in (2, 3):
                eng.filter(min_count=lo)
                before = list(eng._lane_cache[4]._graphs.values())
                eng.incidence(fqb)
                # pair graphs hold their retained band (src): the second
                # band's incidence must capture its own
                recaptured = sum(
                    g.src is not None and all(g is not b for b in before)
                    for g in eng._lane_cache[4]._graphs.values())
                eng.cluster()
                for write in (eng.report, eng.write_clusters):
                    buf = io.StringIO()
                    write(buf)
                    out.append(buf.getvalue())
            buf = io.StringIO()
            eng.write_counts(buf)
            out.append(buf.getvalue())
            texts[shards, dev] = out
            if dev == "cuda":
                if MK.LAUNCHES <= 0 or MK.PLAIN_CALLS or not recaptured:
                    fail(f"-k 31 --shards {shards}: kernel launches "
                         f"{MK.LAUNCHES}, plain calls {MK.PLAIN_CALLS}, "
                         f"{recaptured} pair graphs captured again")
                print(f"join graphs -k 31 --shards {shards}: kernel launches "
                      f"{MK.LAUNCHES}, plain calls 0, {recaptured} pair "
                      "graph(s) captured again for the second band")
            del eng
    first = texts[1, "cuda"]
    if any(t != first for t in texts.values()):
        fail("-k 31: CUDA, CPU, one GPU and --shards 4 differ")
    print(f"join graphs -k 31: 20k ragged lane, two bands, report "
          f"({first[0].count(chr(10))} and {first[2].count(chr(10))} "
          f"lines), clusters and counts dumps byte-identical on CUDA and "
          f"the CPU, one GPU and --shards 4")
    # the lane as this process's --readFQBShard file at one process: the
    # global-id lane and its graphs are cached with it, so the incidence
    # pass replays the count pass's lane and captures only its pair graphs
    eng = Engine(EngineConfig(spec=HashSpec(k=31, w=W, seed=SEED),
                              batch_reads=1024, min_friend_share=4,
                              n_shards=4), "cuda", log=None)
    MK.LAUNCHES = MK.PLAIN_CALLS = ES.REPLAYS = 0
    eng.count(fqb, local_shard=True)
    steps = eng._shard_lane_cache[5]
    eng.filter(min_count=2)
    eng.incidence(fqb, local_shard=True)
    eng.cluster()
    out = []
    for write in (eng.report, eng.write_clusters, eng.write_counts):
        buf = io.StringIO()
        write(buf)
        out.append(buf.getvalue())
    graphs = list(steps._graphs.values())
    if (eng._shard_lane_cache[5] is not steps or MK.PLAIN_CALLS
            or ES.REPLAYS != eng.stats["dispatches"]
            or any(g.launches != 1 for g in graphs)
            or MK.LAUNCHES != ES.REPLAYS + len(graphs)):
        fail(f"-k 31 --shards 4 local shard: {eng.stats['dispatches']} "
             f"steps, {ES.REPLAYS} replays of {len(graphs)} graphs, kernel "
             f"launches {MK.LAUNCHES}, plain calls {MK.PLAIN_CALLS}")
    if out != [first[0], first[1], first[4]]:
        fail("-k 31 --shards 4 local shard: report or dumps differ")
    print(f"join graphs -k 31 --shards 4 local shard lane: "
          f"{eng.stats['dispatches']} steps, {ES.REPLAYS} replays of "
          f"{len(graphs)} graphs (none captured twice), kernel launches "
          f"{MK.LAUNCHES}; report and dumps byte-identical")
    del eng


# -- phases 23-24: the lane at 20x its scale, the stress lane ----------------

SCALE_BAND = (2, 64)


def host_rss_gb():
    """(current, peak) resident host memory of this process in GB."""
    import resource
    cur = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                cur = int(line.split()[1]) / 1e6
    return cur, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class StageProbe:
    """Per-call wall, peak device memory (``max_memory_allocated``, reset
    at the start of each call), ``memory_reserved``, host RSS, table
    flushes, the count table's capacity after the call, and the seconds
    spent building the lane on the device and in the flushes, for the
    Engine's public commands while it is installed (the CLI calls them, so
    a CLI run reports per stage without a flag of its own).  The lane and
    flush seconds and the flushes come from the engine's ``stats`` (the
    program's spans ``lane``, host clock, and ``table.flush``, stream
    seconds); the wall is synchronised on both sides.  A command called
    inside another counts in the outer one."""

    METHODS = ("count", "info", "filter", "incidence", "cluster", "split",
               "report", "write_counts", "write_clusters", "save")

    def __init__(self, torch, Engine, extra=()):
        self.torch, self.Engine = torch, Engine
        self.extra = extra   # (module, function name) probed as stages too
        self.rows = []
        self._saved = []
        self._depth = 0

    def _patch(self, owner, name, fn):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def __enter__(self):
        for name in self.METHODS:
            self._patch(self.Engine, name,
                        self._wrap(name, getattr(self.Engine, name)))
        for owner, name in self.extra:
            self._patch(owner, name, self._wrap(name, getattr(owner, name)))
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            setattr(owner, name, real)

    def _wrap(self, name, real):
        torch = self.torch

        def probed(*a, **kw):
            if self._depth:
                return real(*a, **kw)
            eng = a[0] if a and isinstance(a[0], self.Engine) else None
            self._depth += 1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            s0 = eng.stats if eng is not None else {}
            t0 = time.monotonic()
            try:
                return real(*a, **kw)
            finally:
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                self._depth -= 1
                s1 = eng.stats if eng is not None else {}

                def diff(key):
                    return s1.get(key, 0) - s0.get(key, 0)
                t = eng.table if eng is not None else None
                self.rows.append({
                    "stage": name, "wall_s": wall,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "reserved_gb": torch.cuda.memory_reserved() / 1e9,
                    "rss_gb": host_rss_gb()[0],
                    "flushes": diff("flushes"),
                    "flush_s": diff("table.flush.device_s"),
                    "lane_s": diff("lane.host_s"),
                    "table_slots": t.capacity if t is not None else 0})
        return probed

    def print(self, what):
        for r in self.rows:
            print(f"{what} stage {r['stage']}: wall {r['wall_s']:.3f} s "
                  f"(lane setup {r['lane_s']:.3f} s), peak device memory "
                  f"{r['peak_gb']:.2f} GB, reserved {r['reserved_gb']:.2f} "
                  f"GB, host RSS {r['rss_gb']:.2f} GB, flushes "
                  f"{r['flushes']} ({r['flush_s']:.3f} s), count table "
                  f"{r['table_slots']} slots", flush=True)


def graph_pool_gb(torch):
    """Device memory reserved in private pools (the CUDA graphs' shared
    pool; ``torch.cuda.memory_snapshot``'s segments outside pool (0, 0))."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def make_lane20x(tmp):
    """The 16M-read / 1M-barcode lane (``bench.make_barcodes_lane_blocked``)
    written as an .fqb; prints its build wall and the host RSS it took."""
    from hash10x_tpu_torch.bench import LANE20X, make_barcodes_lane_blocked
    from hash10x_tpu_torch.io.fqb import save_fqb
    rss0 = host_rss_gb()
    t0 = time.monotonic()
    fqb = make_barcodes_lane_blocked()
    wall = time.monotonic() - t0
    rss1 = host_rss_gb()
    path = os.path.join(tmp, "lane20x.fqb")
    t0 = time.monotonic()
    save_fqb(path, fqb)
    print(f"lane20x: {len(fqb)} reads x {READ_LEN} bp, {fqb.n_barcodes} "
          f"barcodes, {LANE20X[2]}-base genome; generator {wall:.3f} s, "
          f"host RSS {rss0[0]:.2f} -> {rss1[0]:.2f} GB (process peak "
          f"{rss0[1]:.2f} -> {rss1[1]:.2f} GB); .fqb written in "
          f"{time.monotonic() - t0:.3f} s", flush=True)
    return path


def digest_and_remove(path):
    """(sha256 hex, bytes) of a file, which is then deleted."""
    import hashlib
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 24)
            if not block:
                break
            h.update(block)
            n += len(block)
    os.remove(path)
    return h.hexdigest(), n


def band_sum_of_counts_dump(path, lo, hi, device="cuda"):
    """The sum of the counts in a --writeCounts dump ("hash<TAB>count"
    lines) over the lines whose count lies in [lo, hi], parsed on
    ``device`` from the file's bytes a block of lines at a time: each
    count is read back from its line's newline, and one with more digits
    than ``hi`` is out of the band."""
    import torch
    D = len(str(hi))
    total = 0
    rest = b""
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 26)
            data = rest + block
            cut = data.rfind(b"\n") + 1
            rest = data[cut:]
            if cut:
                a = torch.frombuffer(bytearray(data[:cut]),
                                     dtype=torch.uint8).to(device)
                nl = torch.nonzero(a == 10).squeeze(1)
                val = torch.zeros_like(nl)
                open_ = torch.ones_like(nl, dtype=torch.bool)  # no tab yet
                for j in range(1, D + 2):
                    ch = a[torch.clamp(nl - j, min=0)].to(torch.int64)
                    open_ &= ch != 9
                    if j <= D:
                        val += torch.where(open_, (ch - 48) * 10 ** (j - 1),
                                           0)
                inside = ~open_ & (val >= lo) & (val <= hi)
                total += int(val[inside].sum())
            if not block:
                break
    if rest:
        fail(f"{path}: the last line has no newline")
    return total


def scale_argv(*flags):
    """Phase 23's parameters (band [2, 64], friend share 8) and ``flags``."""
    return ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
            "--minCount", str(SCALE_BAND[0]), "--maxCount",
            str(SCALE_BAND[1]), "--friendShare", "8", *flags]


def scale_report(lane, read="--readFQB"):
    """Phase 23's commands on ``lane``, through the cluster report."""
    return [read, lane, "--hashInfo", "--codeClusters", "--clusterSplit",
            "--clusterReport"]


LANE20X_RUNS = (("one GPU", []), ("--shards 4", ["--shards", "4"]),
                ("--shards 4 --labelBlocks", ["--shards", "4",
                                              "--labelBlocks",
                                              str(1 << 24)]))


def phase_scale(torch, MK, ES, run, tmp):
    """Phase 23: the lane20x through the CLI on CUDA, one GPU, --shards 4
    and --shards 4 --labelBlocks 16,777,216 (at least 8 label blocks):
    stdout (table slots masked) and both dumps byte-identical across the
    three runs; the incidence pairs equal the in-band sum of the counts
    dump; every batch through the kernel, each step one CUDA graph replay;
    per stage (StageProbe) wall, peak device memory, reserved memory,
    host RSS, flushes and table slots.  Returns (the lane's .fqb path,
    the one-GPU stdout with table slots masked, its kernel launches)."""
    import gc
    from hash10x_tpu_torch.cluster import sparse as SP
    from hash10x_tpu_torch.cluster import sparse_dist as SPD
    from hash10x_tpu_torch.engine import Engine
    lane = make_lane20x(tmp)
    first = None
    one_gpu_launches = 0
    for what, flags in LANE20X_RUNS:
        dumps = [os.path.join(tmp, f"lane20x.{x}")
                 for x in ("counts", "clusters")]
        argv = scale_argv(*flags, *scale_report(lane), "--writeCounts",
                          dumps[0], "--writeClusters", dumps[1])
        ES.REPLAYS = 0
        with StageProbe(torch, Engine) as probe:
            out, err, eng, launches, wall = run_counted(torch, MK, run, argv)
        n_batches = len(eng._lane_cache[3])
        steps, replays, graphs = check_replays(f"lane20x {what}", eng, ES,
                                               launches, 2 * n_batches)
        cstats = dict((SPD if flags else SP).STATS)
        pairs = eng.inc.n_pairs
        pool_gb = graph_pool_gb(torch)
        peak_rss = host_rss_gb()[1]
        if first is None:
            band = band_sum_of_counts_dump(dumps[0], *SCALE_BAND)
            if band != pairs:
                fail(f"lane20x: {pairs} incidence pairs != {band}, the "
                     "in-band sum of the counts dump")
            print(f"lane20x: incidence pairs {pairs} = the sum of the "
                  f"counts dump over the band {list(SCALE_BAND)}")
        t0 = time.monotonic()
        sums = [digest_and_remove(d) for d in dumps]
        hash_s = time.monotonic() - t0
        if "--labelBlocks" in flags and cstats.get("label_blocks", 0) < 8:
            fail(f"lane20x {what}: {cstats.get('label_blocks')} label "
                 "blocks (< 8)")
        probe.print(f"lane20x {what}")
        print(f"lane20x {what}: CLI wall {wall:.3f} s (includes the .fqb "
              f"load and the dumps); {steps} steps over {n_batches} "
              f"batches per pass, {replays} replays of {graphs} graphs, "
              f"kernel launches {launches}, plain calls 0; flushes "
              f"{eng.stats['flushes']}; count table "
              f"{eng.table.capacity} slots, {eng.table.n_filled} kmers; "
              f"{pairs} incidence pairs; {molecules(err)} molecules; "
              "cluster: " + ", ".join(f"{k} {v}" for k, v in
                                      cstats.items())
              + f"; dumps {sums[0][1]} + {sums[1][1]} bytes, hashed in "
              f"{hash_s:.3f} s; graph pool reserved {pool_gb:.2f} GB; host "
              f"RSS peak {peak_rss:.2f} GB (the process's so far)",
              flush=True)
        print("\n".join(f"lane20x {what} stage {line}"
                        for line in stage_lines(err)))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        if first is None:
            first = (masked(out), sums)
            one_gpu_launches = launches
            continue
        if masked(out) != first[0]:
            fail(f"lane20x {what}: stdout != the one-GPU run's")
        if [x[0] for x in sums] != [x[0] for x in first[1]]:
            fail(f"lane20x {what}: counts or clusters dump != the one-GPU "
                 "run's")
        print(f"lane20x {what}: stdout ({out.count(chr(10))} lines), counts "
              "and clusters dumps byte-identical to the one-GPU run",
              flush=True)
    return lane, first[0], one_gpu_launches


def phase_stress(torch, MK, device="cuda"):
    """Phase 24: the JAX package's stress lane
    (``tests_tpu/probe_edge_stress.py``: ``synth_incidence(50_000, 400_000,
    30)``, seed 5) through ``build_incidence`` and clustering at
    min_friend_share 4 on CUDA: ``cluster_codes_sparse`` with the default
    edge block and with 2^17-edge blocks (at least 8 blocks), and
    ``cluster_codes_sparse_dist`` at 4 shards with label blocks of 2^17
    pairs (at least 8); the three label arrays and the CPU's byte-equal.
    Cold and warm walls, peak device memory, pairs, friend keys, edges,
    rounds and the wall of each co-occurrence reduction."""
    from hash10x_tpu_torch.bench import synth_incidence
    from hash10x_tpu_torch.cluster import sparse as SP
    from hash10x_tpu_torch.cluster import sparse_dist as SPD
    from hash10x_tpu_torch.dist.group import ShardGroup
    from hash10x_tpu_torch.table.incidence import build_incidence
    ks, cs = synth_incidence(50_000, 400_000, 30)
    t0 = time.monotonic()
    inc = build_incidence(ks, cs, 400_000, 50_000, device)
    torch.cuda.synchronize()
    print(f"stress: {inc.n_pairs} pairs, build_incidence "
          f"{time.monotonic() - t0:.3f} s", flush=True)
    runs = {}
    for name, fn, stats, key in (
            ("default edge block", lambda: SP.cluster_codes_sparse(inc, 4),
             SP.STATS, "edge_blocks"),
            ("edge_block 2^17", lambda: SP.cluster_codes_sparse(
                inc, 4, edge_block=1 << 17), SP.STATS, "edge_blocks"),
            ("4 shards, label blocks 2^17",
             lambda: SPD.cluster_codes_sparse_dist(
                 inc, ShardGroup.of_process(4, device), min_friend_share=4,
                 flat=True, label_block_pairs=1 << 17), SPD.STATS,
             "label_blocks")):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            lab = fn()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        runs[name] = lab.cpu().numpy().tobytes()
        if name != "default edge block" and stats[key] < 8:
            fail(f"stress {name}: {stats[key]} blocks (< 8)")
        print(f"stress {name}: cold {walls[0]:.4f} s, warm {walls[1]:.4f} "
              f"s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
              + ", ".join(f"{k} {v}" for k, v in stats.items()), flush=True)
    t0 = time.monotonic()
    cpu = SP.cluster_codes_sparse(
        build_incidence(ks, cs, 400_000, 50_000, "cpu"), 4)
    cpu_s = time.monotonic() - t0
    if any(r != runs["default edge block"] for r in runs.values()) \
            or cpu.numpy().tobytes() != runs["default edge block"]:
        fail("stress: the label arrays differ")
    print(f"stress: labels ({inc.n_pairs} int64) byte-equal across the "
          f"default edge block, 2^17-edge blocks, 4 shards with label "
          f"blocks and the CPU (incidence + clustering on the CPU "
          f"{cpu_s:.3f} s)", flush=True)


# -- phases 25-26: the paths off the main path on lane20x ---------------------

FRIEND_SAMPLE = 4096   # codes whose sparse friend rows meet the dense ones
DENSE_ROWS = 128       # dense share rows (each n_codes int64) at once
CLUSTER_LIMIT_S = 60   # the capped-friend cluster stage at 1M barcodes
CRIB_HET = 0.001       # the diploid lanes' SNP rate (phase 11's)
CRIB_RECORDS = 20      # FASTA records per lane20x haplotype (100 Mb each)


def stage_row(probe, stage):
    rows = [r for r in probe.rows if r["stage"] == stage]
    if not rows:
        fail(f"no {stage} stage was probed")
    return rows[-1]


def free_device(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def check_friend_sample(torch, inc, thr, max_friends):
    """``cooccur.friends_table`` rows against the dense ``_friends`` rows
    on FRIEND_SAMPLE codes drawn from every k-mer size class (an equal
    share of each class, the rest at random); returns the codes per
    class."""
    from hash10x_tpu_torch.cluster import cooccur as CO
    table = CO.friends_table(inc, thr, max_friends, pad=True)
    sizes = torch.diff(inc.code_offsets).cpu().numpy()
    longest = torch.zeros(inc.n_codes, dtype=torch.int64, device=inc.device)
    longest.scatter_reduce_(0, inc.code_of_pair(),
                            torch.diff(inc.kmer_offsets)[inc.code_kmers],
                            "amax")
    longest = longest.cpu().numpy()
    active = np.flatnonzero(sizes > 0)
    kcs = np.array([CO._size_class(int(n)) for n in sizes[active]])
    rng = np.random.default_rng(SEED)
    classes = np.unique(kcs)
    quota = max(1, FRIEND_SAMPLE // len(classes))
    picked = [rng.permutation(active[kcs == kc])[:quota] for kc in classes]
    rest = np.setdiff1d(active, np.concatenate(picked))
    picked.append(rng.permutation(rest)[:max(
        0, FRIEND_SAMPLE - sum(len(p) for p in picked))])
    sample = np.concatenate(picked)
    per_class = {}
    for kc in classes:
        codes = sample[np.array([CO._size_class(int(sizes[c]))
                                 for c in sample]) == kc]
        per_class[int(kc)] = len(codes)
        C = CO._size_class(int(longest[codes].max()))
        for a in range(0, len(codes), DENSE_ROWS):
            chunk = torch.from_numpy(codes[a:a + DENSE_ROWS]).to(inc.device)
            _, _, cl = CO.batch_lists(inc, chunk, int(kc), C)
            dense = CO._friends(cl, chunk, inc.n_codes, thr, max_friends)
            if not torch.equal(dense, table[chunk]):
                fail(f"friends_table rows != the dense rows (size class "
                     f"{kc})")
    return per_class


def phase_paths(torch, MK, ES, run, tmp, lane=None, ref=None):
    """Phase 25: the paths off the main path on lane20x (phase 23's .fqb
    and one-GPU stdout, made anew when phase 23 did not run): capped
    friend (--maxFriends 256) on one GPU and at --shards 4, byte-identical,
    the cluster stage under CLUSTER_LIMIT_S, the sparse friend rows equal
    to the dense ones on FRIEND_SAMPLE codes; pair mode; a --writeHash /
    --readHash round trip in a fresh CLI process and --readFastq through
    the native loader, each stdout byte-identical to phase 23's one-GPU
    run; --modimizer and --syncmer 11 with every step a graph replay and
    the incidence pairs equal to the counts dump's in-band sum, and the
    kernel at their stacked shape.  Per stage (StageProbe) wall, peak and
    reserved device memory, host RSS.  Returns (launches and stacked
    kernels-line tuple per mode)."""
    import subprocess as sp
    from hash10x_tpu_torch.cluster import sparse as SP
    from hash10x_tpu_torch.engine import Engine
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.io import fqb as FB
    if lane is None:
        lane = make_lane20x(tmp)
        out, _, eng, _, _ = run_counted(torch, MK, run,
                                        scale_argv(*scale_report(lane)))
        ref = masked(out)
        del eng
        free_device(torch)
    n_lines = ref.count("\n")

    def probed(what, argv, extra=()):
        with StageProbe(torch, Engine, extra) as probe:
            out, err, eng, launches, wall = run_counted(torch, MK, run,
                                                        argv)
        probe.print(what)
        return out, err, eng, launches, wall, probe

    # capped friend, one GPU and --shards 4
    texts = []
    for what, flags in (("one GPU", []), ("--shards 4", ["--shards", "4"])):
        out, err, eng, n, wall, probe = probed(
            f"capped friend {what}",
            scale_argv("--maxFriends", "256", *flags, *scale_report(lane)))
        cl_s = stage_row(probe, "cluster")["wall_s"]
        print(f"capped friend {what}: {molecules(err)} molecules; cluster "
              f"stage {cl_s:.3f} s; friend keys "
              f"{SP.STATS.get('friend_keys')}, co-occurrence keys "
              f"{SP.STATS.get('cooccur_keys')}; CLI wall {wall:.3f} s",
              flush=True)
        if cl_s >= CLUSTER_LIMIT_S:
            fail(f"capped friend {what}: cluster stage {cl_s:.1f} s >= "
                 f"{CLUSTER_LIMIT_S} s")
        if not flags:
            t0 = time.monotonic()
            per_class = check_friend_sample(torch, eng.inc, 8, 256)
            print(f"capped friend: sparse friend rows == dense _friends "
                  f"rows on {sum(per_class.values())} codes (per size "
                  f"class {per_class}) in {time.monotonic() - t0:.3f} s",
                  flush=True)
        texts.append(masked(out))
        del eng
        free_device(torch)
    if texts[0] != texts[1]:
        fail("capped friend: --shards 4 stdout != the one-GPU run's")
    print(f"capped friend: --shards 4 stdout ({texts[0].count(chr(10))} "
          "lines) byte-identical to the one-GPU run", flush=True)

    # pair mode
    out, err, eng, n, wall, probe = probed(
        "pair", scale_argv("--clusterMode", "pair", "--minShare", "2",
                           *scale_report(lane)))
    print(f"pair: {molecules(err)} molecules; cluster stage "
          f"{stage_row(probe, 'cluster')['wall_s']:.3f} s; CLI wall "
          f"{wall:.3f} s", flush=True)
    if f"code {eng.inc.n_codes - 1} nKmers" not in out:
        fail("pair: the report lacks its last code's line")
    del eng
    free_device(torch)

    # checkpoint round trip: --writeHash here, --readHash in a fresh process
    ck = os.path.join(tmp, "lane20x.hash")
    out, err, eng, n, wall, probe = probed(
        "writeHash", scale_argv(*scale_report(lane), "--writeHash", ck))
    del eng
    free_device(torch)
    if masked(out) != ref:
        fail("writeHash run: stdout != phase 23's one-GPU run")
    size = os.path.getsize(ck + ".npz")
    argv = scale_argv("--readHash", ck, "--hashInfo", "--clusterReport")
    t0 = time.monotonic()
    r = sp.run([sys.executable, "-m", "hash10x_tpu_torch", *argv],
               cwd=ROOT, capture_output=True, text=True, timeout=900)
    load_wall = time.monotonic() - t0
    os.remove(ck + ".npz")
    if r.returncode:
        print(r.stderr[-4000:], file=sys.stderr)
        fail(f"--readHash exited {r.returncode}")
    if masked(r.stdout) != ref:
        fail("--readHash report != phase 23's one-GPU stdout")
    print(f"checkpoint: .npz {size} bytes; save "
          f"{stage_row(probe, 'save')['wall_s']:.3f} s (peak device "
          f"{stage_row(probe, 'save')['peak_gb']:.2f} GB); fresh CLI "
          f"--readHash --hashInfo --clusterReport {load_wall:.3f} s (stage "
          f"lines: " + "; ".join(stage_lines(r.stderr)) + f"); stdout "
          f"({n_lines} lines) byte-identical to phase 23's one-GPU run",
          flush=True)

    # FASTQ through the native loader
    fq = os.path.join(tmp, "lane20x.fastq")
    t0 = time.monotonic()
    write_fastq(fq, FB.load_fqb(lane))
    fq_s = time.monotonic() - t0
    fq_bytes = os.path.getsize(fq)
    out, err, eng, n, wall, probe = probed(
        "readFastq", scale_argv(*scale_report(fq, "--readFastq")),
        [(FB, "fastq_to_fqb")])
    del eng
    free_device(torch)
    os.remove(fq)
    if masked(out) != ref:
        fail("--readFastq stdout != phase 23's one-GPU run")
    load = stage_row(probe, "fastq_to_fqb")
    print(f"readFastq: {fq_bytes} bytes written in {fq_s:.3f} s; loaded "
          f"(native loader) in {load['wall_s']:.3f} s, host RSS "
          f"{load['rss_gb']:.2f} GB; CLI wall {wall:.3f} s; stdout ({n_lines} lines) "
          "byte-identical to phase 23's one-GPU run", flush=True)

    # modimizer and syncmer
    modes = {}
    for mode, flags, kw in (("modimizer", ["--modimizer"], {}),
                            ("syncmer", ["--syncmer", "11"],
                             {"syncmer_s": 11})):
        dump = os.path.join(tmp, f"lane20x_{mode}.counts")
        ES.REPLAYS = 0
        out, err, eng, n, wall, probe = probed(
            f"lane20x {mode}", scale_argv(
                *flags, "--readFQB", lane, "--codeClusters",
                "--clusterReport", "--writeCounts", dump))
        n_batches = len(eng._lane_cache[3])
        steps, replays, graphs = check_replays(f"lane20x {mode}", eng, ES,
                                               n, 2 * n_batches)
        pairs = eng.inc.n_pairs
        band = band_sum_of_counts_dump(dump, *SCALE_BAND)
        os.remove(dump)
        if band != pairs:
            fail(f"lane20x {mode}: {pairs} incidence pairs != {band}, the "
                 "in-band sum of the counts dump")
        C = eng._compact_rows(READ_LEN - K + 1)
        S = eng.cfg.flush_batches
        print(f"lane20x {mode}: {steps} steps over {n_batches} batches per "
              f"pass, {replays} replays of {graphs} graphs, kernel launches "
              f"{n}, plain calls 0; {eng.table.n_filled} kmers, {pairs} "
              f"incidence pairs = the counts dump's in-band sum; "
              f"{molecules(err)} molecules; CLI wall {wall:.3f} s",
              flush=True)
        del eng
        free_device(torch)
        spec = HashSpec(k=K, w=W, seed=SEED)
        modes[mode] = (n, time_stacked(torch, MK, spec, S, C, mode, kw))
    return modes


def phase_crib_scale(torch, MK, ES, run, tmp):
    """Phase 26: the diploid lane20x (``make_barcodes_lane_blocked(
    het_rate=CRIB_HET)``: each molecule from one of two 2 Gb haplotypes,
    each written as CRIB_RECORDS FASTA records) through --codeClusters
    --clusterReport --cribBuild h1.fa h2.fa --cribReport on one GPU: every
    genome row through the kernel's dense kmer mode (launches in cribBuild
    > 0, plain calls 0), overall purity >= 0.85, one crib line per
    molecule of the run's cluster report, crib totals summing to the
    retained k-mers.  Per stage (StageProbe, cribBuild and cribReport
    too) wall, peak and reserved device memory, host RSS.  Returns the
    kernel launches in cribBuild."""
    from hash10x_tpu_torch.bench import (make_barcodes_lane_blocked,
                                         write_fasta_records)
    from hash10x_tpu_torch.crib import crib as CR
    from hash10x_tpu_torch.engine import Engine
    from hash10x_tpu_torch.io.fqb import save_fqb
    t0 = time.monotonic()
    fqb, haps = make_barcodes_lane_blocked(het_rate=CRIB_HET,
                                           return_haplotypes=True)
    gen_s = time.monotonic() - t0
    lane = os.path.join(tmp, "diploid20x.fqb")
    save_fqb(lane, fqb)
    n_reads, n_codes = len(fqb), fqb.n_barcodes
    del fqb
    n_het = int((haps[0] != haps[1]).sum())
    fas = [os.path.join(tmp, f"h{i + 1}_20x.fa") for i in range(2)]
    t0 = time.monotonic()
    for fa, hap in zip(fas, haps):
        write_fasta_records(fa, hap, CRIB_RECORDS)
    fa_s = time.monotonic() - t0
    del haps
    print(f"crib lane20x: {n_reads} reads, {n_codes} barcodes, two "
          f"haplotypes of {CRIB_RECORDS} records ({os.path.getsize(fas[0])}"
          f" bytes of FASTA each) with {n_het} het sites; generator "
          f"{gen_s:.3f} s, FASTA written in {fa_s:.3f} s, host RSS "
          f"{host_rss_gb()[0]:.2f} GB", flush=True)
    argv = scale_argv("--readFQB", lane, "--codeClusters", "--clusterReport",
                      "--cribBuild", *fas, "--cribReport")
    out, err = io.StringIO(), StageLog(MK)
    with StageProbe(torch, Engine, [(CR, "build_crib"),
                                        (CR, "crib_report")]) as probe:
        MK.LAUNCHES = MK.PLAIN_CALLS = 0
        t0 = time.monotonic()
        eng = run(argv, out, err)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    for f in fas + [lane + ".npz"]:
        os.remove(f)
    probe.print("crib lane20x")
    crib_launches = err.launches_in("cribBuild")
    if crib_launches <= 0 or MK.PLAIN_CALLS != 0:
        fail(f"crib lane20x cribBuild: kernel launches {crib_launches}, "
             f"plain calls {MK.PLAIN_CALLS}")
    text = out.getvalue()
    totals = re.search(r"^crib totals (.*)$", text, re.M)
    overall = re.search(r"^crib overall purity (\S+) .*$", text, re.M)
    if not totals or not overall:
        fail("crib lane20x: the report lacks its totals or overall purity")
    total = sum(int(x) for x in totals.group(1).split()[1::2])
    n_kmers = eng.retained_hashes.shape[0]
    mols = molecules(err.getvalue())
    report_mols = sum(int(x) for x in re.findall(r" nClusters (\d+) ",
                                                 text))
    crib_lines = text.count(" cluster ")
    purity = float(overall.group(1))
    print(f"crib lane20x: {totals.group(0)}; {overall.group(0)}; "
          f"{crib_lines} crib lines = {report_mols} clusters of the "
          f"report = {mols} molecules; kernel launches in cribBuild "
          f"{crib_launches} (row groups), plain calls 0; cribBuild "
          f"{stage_row(probe, 'build_crib')['wall_s']:.3f} s, cribReport "
          f"{stage_row(probe, 'crib_report')['wall_s']:.3f} s; CLI wall "
          f"{wall:.3f} s", flush=True)
    if total != n_kmers:
        fail(f"crib lane20x: crib totals sum to {total}, not the "
             f"{n_kmers} retained k-mers")
    if not crib_lines == report_mols == mols:
        fail(f"crib lane20x: {crib_lines} crib lines, {report_mols} report "
             f"clusters, {mols} molecules")
    if purity < 0.85:
        fail(f"crib lane20x: overall purity {purity} < 0.85")
    del eng
    free_device(torch)
    return crib_launches


def run_only(torch, MK, ES, run, only):
    """``--only 23,24,25,26``: after the build, only the phases named."""
    with tempfile.TemporaryDirectory() as tmp:
        lane = ref = None
        if 23 in only:
            lane, ref, _ = phase_scale(torch, MK, ES, run, tmp)
        if 24 in only:
            phase_stress(torch, MK)
        if 25 in only:
            phase_paths(torch, MK, ES, run, tmp, lane, ref)
        if 26 in only:
            phase_crib_scale(torch, MK, ES, run, tmp)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, ROOT)
    from hash10x_tpu_torch import engine_steps as ES
    from hash10x_tpu_torch.cli.main import run
    from hash10x_tpu_torch.engine import Engine, EngineConfig
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.kernels import minimizer as MK
    from hash10x_tpu_torch.table import sorted_table as st

    smi = phase_device(torch)
    t_start = time.monotonic()
    only = set()
    if "--only" in sys.argv:
        only = {int(x) for x in
                sys.argv[sys.argv.index("--only") + 1].split(",")}

    def elapsed(what):
        print(f"elapsed after {what}: {time.monotonic() - t_start:.1f} s")
    t0 = time.monotonic()
    MK.build()
    print(f"build: {time.monotonic() - t0:.3f} s (nvcc {' '.join(MK.NVCC_FLAGS)})")

    def compact_rows_of(spec, mode="minimizer", kw=None):
        kw = kw or {}
        cfg = EngineConfig(spec=spec, mode=mode, modulus=kw.get("m", 0),
                           syncmer_s=kw.get("syncmer_s", 0))
        return Engine(cfg, "cuda", log=None)._compact_rows(
            READ_LEN - spec.k + 1)
    if only:
        return run_only(torch, MK, ES, run, only)
    compact_rows = compact_rows_of(HashSpec(k=K, w=W, seed=SEED))
    max_err, *main_times = phase_parity(torch, MK, HashSpec, compact_rows)
    modes, err_w = phase_mode_parity(torch, MK, HashSpec, compact_rows_of)
    max_err = max(max_err, err_w)
    from hash10x_tpu_torch.crib.crib import _ROWS
    crib = phase_crib_parity(torch, MK, HashSpec, _ROWS["cuda"])
    fuzz_err = phase_tile_fuzz(torch, MK, HashSpec)
    wide = phase_wide(torch, MK, HashSpec)
    elapsed("phases 1-3")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        reads, bc_ids = make_lane()
        lane = os.path.join(tmp, "lane.fqb")
        write_fqb(lane, reads, bc_ids, N_CODES)
        print(f"lane: {N_READS} reads x {READ_LEN} bp, {N_CODES} barcodes "
              f"(built in {time.monotonic() - t0:.1f} s)")
        eng, text, launches, n_batches = phase_main(torch, MK, ES, run,
                                                     lane)
        phase_c_ref(torch, st, run, eng, text, reads, bc_ids, tmp)
        phase_cuda_vs_cpu(run, tmp)
        wide_launches = phase_cuda_vs_cpu(run, tmp, WIDE_CLI_W, MK)
        main_dumps = write_dumps(eng, tmp, "main")
        elapsed("phases 4-6")
        del eng
        mode_launches = phase_modes(torch, MK, run, lane)
        phase_counts(torch, MK, run, tmp)
        phase_checkpoint(torch, MK, run, lane, tmp)
        phase_cuda_vs_cpu_modes(run, tmp)
        crib_launches = phase_crib(torch, MK, run, tmp)
        phase_legacy(torch, MK, run, lane)
        phase_cuda_vs_cpu_legacy(run, tmp)
        phase_observe(torch, MK, run, tmp, text)
        elapsed("phases 7-14")
        phase_shards(torch, MK, ES, run, lane, tmp, text, main_dumps,
                     n_batches)
        phase_lanes(torch, MK, run, lane, tmp, text, main_dumps)
        phase_hosts(lane, tmp, reads, bc_ids, text, n_batches)
        phase_cuda_vs_cpu_shards(run, tmp)
        elapsed("phases 15-18")
        phase_reset(torch, MK, tmp)
        elapsed("phase 19")
        stacked = phase_steps(torch, MK, ES, lane, text, main_dumps, tmp,
                              compact_rows)
        elapsed("phase 20")
        phase_shard_steps(torch, MK, ES, lane, text, main_dumps, tmp,
                          n_batches)
        elapsed("phase 21")
        phase_join_graphs(torch, MK, ES, tmp)
        elapsed("phase 22")
        lane20x, ref20x, scale_launches = phase_scale(torch, MK, ES, run,
                                                      tmp)
        elapsed("phase 23")
        phase_stress(torch, MK)
        elapsed("phase 24")
        paths = phase_paths(torch, MK, ES, run, tmp, lane20x, ref20x)
        os.remove(lane20x + ".npz")
        elapsed("phase 25")
        crib20x_launches = phase_crib_scale(torch, MK, ES, run, tmp)
        elapsed("phase 26")

    kernels = [kernel_entry(
        "seqhash_sketch", launches, max(max_err, fuzz_err), *main_times,
        (PARITY_B, READ_LEN, compact_rows, K, "minimizer"))]
    err, *times, shape = stacked
    kernels.append(kernel_entry("seqhash_sketch_stacked", launches, err,
                                *times, shape))
    # the same launch shape on the lane20x (phase 23's one-GPU run)
    kernels.append(kernel_entry("seqhash_sketch_stacked_lane20x",
                                scale_launches, err, *times, shape))
    for mode in ("modimizer", "syncmer"):  # emission :279-280 and :281-292
        err, *times, shape = modes[mode]
        kernels.append(kernel_entry(f"seqhash_sketch_{mode}",
                                    mode_launches[mode], err, *times, shape))
    crib_rows = _ROWS["cuda"]
    kernels.append(kernel_entry(
        "seqhash_sketch_kmer_crib", crib_launches, crib[0], *crib[1:],
        (crib_rows, 1 << 15, (1 << 15) - K + 1, K, "kmer")))
    err, *times, shape = wide
    kernels.append(kernel_entry("seqhash_sketch_minimizer_wide",
                                wide_launches, err, *times, shape))
    # the routes off the main path on lane20x (phases 25-26)
    for mode in ("modimizer", "syncmer"):
        n, (err, *times, shape) = paths[mode]
        kernels.append(kernel_entry(f"seqhash_sketch_{mode}_stacked_lane20x",
                                    n, err, *times, shape))
    kernels.append(kernel_entry(
        "seqhash_sketch_kmer_crib_lane20x", crib20x_launches, crib[0],
        *crib[1:], (crib_rows, 1 << 15, (1 << 15) - K + 1, K, "kmer")))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
