#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, kernel parity in
every sketch mode, the barcodes-mode main path and the modimizer, syncmer,
occurrence-count and checkpoint paths at full lane scale, and byte-level
checks against the C stand-in and the CPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

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
                (phase_tile_fuzz; it also times the w = 4,097 case on
                sketch_kernel_wide).  Each route (minimizer, modimizer,
                syncmer at B=4096, L=150; a crib row group) is timed three
                ways, each with CUDA events: the kernel's device time per
                launch (kernel_device_ms), the wrapper's time per call (the
                kernels line's "ms") and the plain version's, against its
                bound (sketch_bound)
  4. main     - the 800k-read / 50k-barcode lane of bench.py as an .fqb,
                through hash10x_tpu_torch.cli.main on CUDA; every batch must go
                through the kernel (launch counter > 0, plain calls == 0)
  5. c_ref    - native/c_ref/hash10x_ref.c on the same lane: equal count
                table, byte-identical report, and byte-identical cluster dump
                on a 50k-read sub-lane
  6. cpu      - the CLI on CUDA and on the CPU give byte-identical output on
                a 20k-read lane with N bases, ragged and short reads
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
                --writeClusters byte-identical to phase 4's; the same 392
                kernel launches, 0 plain calls; stage walls and lines
 16. lanes    - the lane with --shards 4 --laneCapacity 4096 (overflows: the
                pass runs again with doubled lanes, output unchanged), and
                with --labelBlocks 1048576 (labels unchanged)
 17. hosts    - two processes sharing the card over gloo (--hosts 2 --shards
                4, cuda:0), each under a hard timeout: with --readFQB of the
                lane and with --readFQBShard of the lane split into two
                barcode-disjoint files, the coordinator's stdout equals phase
                4's and the other process prints nothing; launches and walls
                per process
 18. cpu4     - CUDA and CPU byte-identical with --shards 4 on phase 6's lane
 19. reset    - config #1 through the library API on CUDA: a fresh Engine's
                count, then Engine.reset() and a recount of the same lane
                (the lane stays on the device): both tables byte-equal to
                each other and to phase 8's native/c_ref dump; kernel
                launches > 0 and plain calls 0 in the recount
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


def time_kernel_plain(torch, MK, spec, c, ln, kw, n, warm=3):
    """Kernel and plain ms per call on (c, ln): CUDA events over n calls
    after ``warm`` warm-ups, in the order kernel, plain, plain, kernel."""
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
    for fn, acc in ((MK.sketch, ms), (MK.sketch_plain, plain_ms),
                    (MK.sketch_plain, plain_ms), (MK.sketch, ms)):
        acc.append(timed(fn))
    return float(np.mean(ms)), float(np.mean(plain_ms))


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


def phase_main(torch, MK, run, lane):
    argv = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "22",
            "--minCount", "2", "--maxCount", "64", "--friendShare", "8",
            "--readFQB", lane, "--hashInfo", "--hashDist", "--codeClusters",
            "--clusterSplit", "--clusterReport"]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    MK.LAUNCHES = 0
    MK.PLAIN_CALLS = 0
    t0 = time.monotonic()
    eng = run(argv, out, err)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain = MK.LAUNCHES, MK.PLAIN_CALLS
    sys.stderr.write(err.getvalue())
    print(f"main path: kernel launches {launches}, plain calls {plain}")
    if launches <= 0 or plain != 0:
        fail("the main path did not run every batch through the kernel")
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
    return eng, text, launches


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


def phase_cuda_vs_cpu(run, tmp):
    """The CLI on CUDA and on the CPU (plain versions) on a small lane with
    N bases, ragged and short reads and reads without a barcode: stdout and
    both dump files must be byte-identical."""
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
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        files = [os.path.join(tmp, f"ragged_{dev}.{x}")
                 for x in ("counts", "clusters")]
        run(["--device", dev, "-k", str(K), "-w", str(W), "-r", str(SEED),
             "--batchReads", "1024", "--friendShare", "4", "--readFQB", lane,
             "--hashInfo", "--hashDist", "--codeClusters", "--clusterSplit",
             "--clusterReport", "--writeCounts", files[0],
             "--writeClusters", files[1]], out, io.StringIO())
        texts = [out.getvalue()]
        for f in files:
            with open(f) as fh:
                texts.append(fh.read())
        outs.append(texts)
    if outs[0] != outs[1]:
        fail("CUDA and CPU runs differ on the ragged N lane")
    print(f"cuda vs cpu: {n}-read ragged lane with N bases, stdout "
          f"({outs[0][0].count(chr(10))} lines) and dumps byte-identical")


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
    it (the scratch-ring kernel), and rows at unaligned addresses.  Returns
    max_abs_err."""
    from hash10x_tpu_torch.kernels.minimizer import sketch_bound
    dev = torch.device("cuda")
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
        buf = torch.empty(off + B * L, dtype=torch.uint8, device=dev)
        c = buf[off:].view(B, L)
        c.copy_(torch.from_numpy(codes))
        ln = torch.from_numpy(lengths).to(dev)
        T, _ = tile_geometry(L - k + 1, k, w, mode)
        for C in widths:
            got = MK.sketch(spec, c, ln, mode=mode, compact_to=C, **kw)
            torch.cuda.synchronize()
            ref = MK.sketch_plain(spec, c, ln, mode=mode, compact_to=C, **kw)
            torch.cuda.synchronize()
            max_err = max(max_err, float((got[0] - ref[0]).abs().max()))
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            print(f"tile fuzz {mode} k={k} w={w} {kw} B={B} L={L} C={C} "
                  f"offset {off} (tile {T} positions): "
                  f"{'equal' if same else 'DIFFERENT'} (emitted "
                  f"{int(got[2].sum())}, overflow {int(got[3].sum())})")
            if not same:
                fail(f"tile fuzz: kernel != plain for {mode} k={k} w={w} "
                     f"{kw} L={L} C={C}")
            if w > wmax and C == 0:
                # the thread-per-read sketch_kernel_wide: no lane runs it
                dms = kernel_device_ms(torch, MK.launcher(spec, c, ln),
                                       n=5)
                ms, plain_ms = time_kernel_plain(torch, MK, spec, c, ln, {},
                                                 n=3, warm=1)
                nbytes, ops, bound, by = sketch_bound(B, L, L - k + 1, k)
                print(f"sketch_kernel_wide w={w} B={B} L={L} dense: "
                      f"{dms:.4f} device ms per launch; wrapper {ms:.4f} "
                      f"ms/call, plain {plain_ms:.4f} ms/call (CUDA events "
                      f"over 2x3 calls each); {nbytes} bytes, {ops} "
                      f"operations, bound {bound:.5f} ms ({by}); bound "
                      f"share {bound / dms:.4f}")
        del buf, c, ln
    return max_err


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


def write_fastq(path, reads, bc_ids):
    """The lane as FASTQ: each read is its barcode id as a 16 bp 2-bit
    barcode (base 0 in the top bits, so the sorted keys are the ids) and
    its bases; fixed-length records, one vectorized write."""
    n, L = reads.shape
    shifts = 2 * (15 - np.arange(16))
    bc = (bc_ids[:, None].astype(np.int64) >> shifts) & 3
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seq = acgt[np.concatenate([bc, reads], axis=1)]
    S = 16 + L
    rec = np.empty((n, 3 + S + 3 + S + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + S] = seq
    rec[:, 3 + S:6 + S] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + S:6 + 2 * S] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def phase_observe(torch, MK, run, tmp, lane_reads, bc_ids, main_text):
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
    write_fastq(fq, lane_reads, bc_ids)
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
          f"{len(bc_ids)} reads, equal Fqb; CLI stdout "
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


def phase_shards(torch, MK, run, lane, tmp, main_text, main_dumps,
                 main_launches):
    """Phase 15: the 800k lane with --shards 4 and --shards 2 through the
    CLI on CUDA: stdout and both dumps byte-identical to phase 4's."""
    for n in (4, 2):
        dumps = [os.path.join(tmp, f"shards{n}.{x}")
                 for x in ("counts", "clusters")]
        argv = lane_argv(lane, "--shards", str(n)) + [
            "--writeCounts", dumps[0], "--writeClusters", dumps[1]]
        out, err, eng, launches, wall = run_counted(torch, MK, run, argv)
        del eng
        if launches != main_launches:
            fail(f"--shards {n}: {launches} kernel launches, phase 4 made "
                 f"{main_launches}")
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
              "from hash10x_tpu_torch.cli.main import main\n"
              "from hash10x_tpu_torch.kernels import minimizer as MK\n"
              "rc = main(sys.argv[1:])\n"
              "sys.stderr.write(f'launches {MK.LAUNCHES} plain calls "
              "{MK.PLAIN_CALLS}\\n')\n"
              "sys.exit(rc)\n")


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


def phase_hosts(lane, tmp, reads, bc_ids, main_text):
    """Phase 17: two processes sharing the card over gloo (--hosts 2
    --shards 4), the whole lane in each and the lane split into two
    barcode-disjoint files: the coordinator's stdout is phase 4's, the other
    process prints nothing."""
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
            if not launch or launch[0].split()[1] == "0" \
                    or launch[0].split()[-1] != "0":
                fail(f"--hosts 2 process {pid}: {launch}")
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, ROOT)
    from hash10x_tpu_torch.cli.main import run
    from hash10x_tpu_torch.engine import Engine, EngineConfig
    from hash10x_tpu_torch.hashspec import HashSpec
    from hash10x_tpu_torch.kernels import minimizer as MK
    from hash10x_tpu_torch.table import sorted_table as st

    smi = phase_device(torch)
    t_start = time.monotonic()

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
    compact_rows = compact_rows_of(HashSpec(k=K, w=W, seed=SEED))
    max_err, *main_times = phase_parity(torch, MK, HashSpec, compact_rows)
    modes, err_w = phase_mode_parity(torch, MK, HashSpec, compact_rows_of)
    max_err = max(max_err, err_w)
    from hash10x_tpu_torch.crib.crib import _ROWS
    crib = phase_crib_parity(torch, MK, HashSpec, _ROWS["cuda"])
    fuzz_err = phase_tile_fuzz(torch, MK, HashSpec)
    elapsed("phases 1-3")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        reads, bc_ids = make_lane()
        lane = os.path.join(tmp, "lane.fqb")
        write_fqb(lane, reads, bc_ids, N_CODES)
        print(f"lane: {N_READS} reads x {READ_LEN} bp, {N_CODES} barcodes "
              f"(built in {time.monotonic() - t0:.1f} s)")
        eng, text, launches = phase_main(torch, MK, run, lane)
        phase_c_ref(torch, st, run, eng, text, reads, bc_ids, tmp)
        phase_cuda_vs_cpu(run, tmp)
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
        phase_observe(torch, MK, run, tmp, reads, bc_ids, text)
        elapsed("phases 7-14")
        phase_shards(torch, MK, run, lane, tmp, text, main_dumps, launches)
        phase_lanes(torch, MK, run, lane, tmp, text, main_dumps)
        phase_hosts(lane, tmp, reads, bc_ids, text)
        phase_cuda_vs_cpu_shards(run, tmp)
        elapsed("phases 15-18")
        phase_reset(torch, MK, tmp)
        elapsed("phase 19")

    kernels = [kernel_entry(
        "seqhash_sketch", launches, max(max_err, fuzz_err), *main_times,
        (PARITY_B, READ_LEN, compact_rows, K, "minimizer"))]
    for mode in ("modimizer", "syncmer"):  # emission :279-280 and :281-292
        err, *times, shape = modes[mode]
        kernels.append(kernel_entry(f"seqhash_sketch_{mode}",
                                    mode_launches[mode], err, *times, shape))
    crib_rows = _ROWS["cuda"]
    kernels.append(kernel_entry(
        "seqhash_sketch_kmer_crib", crib_launches, crib[0], *crib[1:],
        (crib_rows, 1 << 15, (1 << 15) - K + 1, K, "kmer")))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
