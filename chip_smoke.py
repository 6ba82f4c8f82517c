#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, kernel parity, the
barcodes-mode main path at full lane scale, and a byte-level check against
the C stand-in.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   - the card's name and power limit (nvidia-smi) and torch's name
  2. build    - nvcc builds csrc/minimizer.cu for sm_90a (timed)
  3. parity   - the sketch kernel equals kernels.minimizer.sketch_plain bit for
                bit on ragged, N-salted, short, homopolymer and overflow
                batches; kernel and plain times at B=4096, L=150
  4. main     - the 800k-read / 50k-barcode lane of bench.py as an .fqb,
                through hash10x_tpu_torch.cli.main on CUDA; every batch must go
                through the kernel (launch counter > 0, plain calls == 0)
  5. c_ref    - native/c_ref/hash10x_ref.c on the same lane: equal count
                table, byte-identical report, and byte-identical cluster dump
                on a 50k-read sub-lane
  6. cpu      - the CLI on CUDA and on the CPU give byte-identical output on
                a 20k-read lane with N bases, ragged and short reads
The last two lines of stdout are a JSON line describing the kernel and the
JSON result line {"ok": true, "device": {...}}.
"""

import io
import json
import os
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


def _batch(rng, B, L, k, w, bad=0.0, ragged=False):
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    if bad:
        codes[rng.random(codes.shape) < bad] = 4
    lengths = (rng.integers(0, L + 1, size=B) if ragged
               else np.full(B, L)).astype(np.int32)
    codes[0] = 2                      # homopolymer
    codes[1, :L // 2] = 3
    lengths[2] = k + w - 2            # short read: 0 < P_i < w
    lengths[3] = k                    # exactly one k-mer
    lengths[4] = k - 1                # no k-mer
    return codes, lengths


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
    codes, lengths = _batch(rng, PARITY_B, READ_LEN, K, W)
    lengths[:] = READ_LEN
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lengths).to(dev)

    def timed(fn, n=50):
        for _ in range(3):
            fn(spec, c, ln, mode="minimizer", compact_to=compact_rows)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn(spec, c, ln, mode="minimizer", compact_to=compact_rows)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n
    ms, plain_ms = [], []
    for fn, acc in ((MK.sketch, ms), (MK.sketch_plain, plain_ms),
                    (MK.sketch_plain, plain_ms), (MK.sketch, ms)):
        acc.append(timed(fn))
    ms, plain_ms = float(np.mean(ms)), float(np.mean(plain_ms))
    print(f"sketch B={PARITY_B} L={READ_LEN} k={K} w={W} C={compact_rows}: "
          f"kernel {ms:.4f} ms/batch, plain {plain_ms:.4f} ms/batch "
          f"(CUDA events, mean of 2x50 launches each)")
    return max_err, ms, plain_ms


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
    walls = {}
    for line in err.getvalue().splitlines():
        label = line[1:line.index("]")].split(":")[0].split(" ")[0]
        walls[label] = walls.get(label, 0.0) + float(
            line.split("] wall ")[1].split("s")[0])
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
    t0 = time.monotonic()
    MK.build()
    print(f"build: {time.monotonic() - t0:.3f} s (nvcc {' '.join(MK.NVCC_FLAGS)})")

    probe = Engine(EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED)), "cuda",
                   log=None)
    compact_rows = probe._compact_rows(READ_LEN - K + 1)
    max_err, ms, plain_ms = phase_parity(torch, MK, HashSpec, compact_rows)

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

    print(json.dumps({"kernels": [{
        "name": "seqhash_sketch",
        "route": "cuda",
        "source": "hash10x_tpu_torch/csrc/minimizer.cu",
        "replaces": "hash10x_tpu/kernels/minimizer_pallas.py:403",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
