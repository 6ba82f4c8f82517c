"""The port's benchmark: the points of the JAX package's ``bench.py``, on one
CUDA card, through the library API.

    python -m hash10x_tpu_torch.bench

Points, in order (``RUNS`` = 5 warm runs per timed number, reported as the
median and [min, max] with the run count):

* ``engine_count_hot`` / ``engine_count_cold``: BASELINE config #1
  (``make_lane``: 262,144 reads of 150 bp from a 2 Mb genome, one barcode)
  counted in occurrences mode at table bits 20.  Hot is ``Engine.reset()``
  and a recount with the lane on the device; cold clears the lane cache
  first, so the host-to-device copy is inside the wall.  ``vs_baseline`` is
  the hot rate over ``native/c_ref``'s on the 16,384-read subset.
* ``engine_barcodes_800k_reads_50k_codes``: the config-#3-scale lane
  (800,000 reads, 50,000 barcodes x one 30 kb molecule of a 100 Mb genome)
  through count, filter + incidence, cluster, split and report at table
  bits 22 and band [2, 64]: one cold pass, then the warm passes; the warm
  walls attributed as ``Engine.stats`` counters x the launch floor; the C
  stand-in's full pipeline run after the port's passes (never beside them:
  the port is host-bound and would share the host); its molecule count
  decides ``correct``; a separate profiled warm pass gives the device's
  busy share and top operations.
* ``count_breakdown``: the card's launch floor (a one-element add and a
  synchronize, on the host clock), one 4,096-read batch's step (unpack,
  sketch kernel, dedup), the kernel alone (CUDA events) against
  ``sketch_bound``, and the flush merge of a 2^20 table and a 2^21 buffer
  against the byte bound of the buffer's radix sort and the merge.
* ``routing_ab_1chip``: the sharded count path at ``n_shards=1``
  (``Engine._count_sharded``) against the plain ``count``.
* ``cluster_200k_codes``: ``cluster_codes_sparse`` on a synthesized
  200,000-code incidence built with ``build_incidence`` on the card.
* ``shards_curve_one_card``: the count pass of a 16,384-read lane at 1, 2,
  4 and 8 shards stacked on the card, and sharded clustering at 2, 4 and 8.

Budget: ``H10X_BENCH_BUDGET_S`` seconds (default 1200) from the start; each
point runs only when the time left exceeds its estimate (measured on an
H100), and skipped points are named.  After every point the compact summary
line is printed again, so the last line always parses as JSON under 4 KB;
the full payload goes to ``chiprun_out/bench_torch_detail.json``.  With no
CUDA device the bench prints one JSON line and exits non-zero: it does not
run on the CPU.  The point functions take the device and the sizes, so
tests call them small on the CPU.  Once every point has run, the bench
exits 1 if any point raised (a point skipped for the budget does not
count).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import INT64_MAX
from .cluster import sparse as SP
from .cluster.sparse_dist import cluster_codes_sparse_dist
from .core.encode import pack_2bit, unpack_2bit_torch
from .dist.group import ShardGroup
from .engine import Engine, EngineConfig
from .hashspec import HashSpec
from .io.fqb import Fqb
from .kernels import minimizer as MK
from .table import sorted_table as st
from .table.incidence import build_incidence
from .utils.timing import kernel_device_ms

__all__ = ["make_lane", "make_barcodes_lane", "blocked_genome",
           "blocked_snps", "make_barcodes_lane_blocked",
           "write_fasta_records", "lane_fqb", "launch_floor_ms",
           "bench_engine", "bench_breakdown", "bench_barcodes",
           "bench_routing_ab", "bench_cluster", "bench_shards_curve",
           "Summary", "run_plan", "main"]

ROOT = Path(__file__).resolve().parent.parent
DETAIL = ROOT / "chiprun_out" / "bench_torch_detail.json"
C_SOURCE = ROOT / "native" / "c_ref" / "hash10x_ref.c"

N_READS = 1 << 18
READ_LEN = 150
BATCH = 1 << 12
K, W, SEED = 21, 11, 17
C_SUBSET = 1 << 14   # the C stand-in counts a subset (it is much slower)
BC_READS, BC_CODES = 800_000, 50_000
BC_GENOME = 100_000_000
MOLECULE = 30_000
RUNS = 5
RADIX_BITS = 8      # CUB's onesweep radix sort: 8-bit digits
SUMMARY_MAX = 4000  # bytes of the compact summary line


def _spec() -> HashSpec:
    return HashSpec(k=K, w=W, seed=SEED)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spread(values) -> dict:
    """Median, min and max of timed runs, and how many."""
    v = sorted(float(x) for x in values)
    return {"median": float(np.median(v)), "min": v[0], "max": v[-1],
            "runs": len(v)}


def timed(device: torch.device, fn) -> float:
    """Wall seconds of ``fn()`` with the device synchronised on both
    sides."""
    sync(device)
    t0 = time.monotonic()
    fn()
    sync(device)
    return time.monotonic() - t0


# -- inputs: the generators and seeds of the JAX package's bench.py ----------

def make_lane(n_reads: int = N_READS) -> np.ndarray:
    """Config #1: reads of a 2 Mb random genome (seed 7)."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=n_reads)
    return genome[starts[:, None] + np.arange(READ_LEN)]


def make_barcodes_lane(n_reads: int = BC_READS, n_codes: int = BC_CODES,
                       genome_len: int = BC_GENOME):
    """Config-#3 scale (seed 11): each barcode one 30 kb molecule of a
    random genome, its n_reads / n_codes reads drawn inside it.  Returns
    (reads (n, 150) uint8, barcode ids (n,) int32)."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    mol_starts = rng.integers(0, len(genome) - MOLECULE, size=n_codes)
    bc_ids = np.repeat(np.arange(n_codes, dtype=np.int32), n_reads // n_codes)
    offs = rng.integers(0, MOLECULE - READ_LEN, size=n_reads)
    starts = mol_starts[bc_ids] + offs
    return genome[starts[:, None] + np.arange(READ_LEN)], bc_ids


LANE20X = (16_000_000, 1_000_000, 2_000_000_000)   # reads, barcodes, genome
GENOME_BLOCK = 1 << 24   # bases drawn per seed of the blocked genome
READ_CHUNK = 1 << 17     # reads gathered and packed at once


def blocked_genome(genome_len: int, seed: int = 11) -> np.ndarray:
    """A random genome as uint8 base codes, drawn in fixed blocks of
    ``GENOME_BLOCK`` bases: block i is four 2-bit bases per byte of
    ``default_rng([seed, 1, i]).bytes``, so no temporary is wider than a
    block and the bases are a fixed function of the seed."""
    genome = np.empty(genome_len, np.uint8)
    for i, a in enumerate(range(0, genome_len, GENOME_BLOCK)):
        n = min(GENOME_BLOCK, genome_len - a)
        raw = np.frombuffer(np.random.default_rng([seed, 1, i])
                            .bytes((n + 3) // 4), np.uint8)
        bases = genome[a:a + n]
        for j in range(4):
            part = bases[j::4]
            np.bitwise_and(raw[:len(part)] >> (2 * j), 3, out=part)
    return genome


def blocked_snps(genome: np.ndarray, het_rate: float,
                 seed: int = 11) -> np.ndarray:
    """A second haplotype of ``genome``: a copy with a SNP at each base with
    probability ``het_rate``, drawn per ``GENOME_BLOCK``-base block from
    ``default_rng([seed, 2, i])``: the block's site count (binomial), the
    sites (uniform without replacement), then a shift of 1-3 per site."""
    hap = genome.copy()
    for i, a in enumerate(range(0, len(genome), GENOME_BLOCK)):
        n = min(GENOME_BLOCK, len(genome) - a)
        rng = np.random.default_rng([seed, 2, i])
        sites = a + np.sort(rng.choice(n, rng.binomial(n, het_rate),
                                       replace=False))
        shift = rng.integers(1, 4, size=len(sites), dtype=np.uint8)
        hap[sites] = (hap[sites] + shift) % 4
    return hap


def make_barcodes_lane_blocked(n_reads: int = LANE20X[0],
                               n_codes: int = LANE20X[1],
                               genome_len: int = LANE20X[2], seed: int = 11,
                               chunk: int = READ_CHUNK, het_rate: float = 0.0,
                               return_haplotypes: bool = False):
    """The bench lane's shape at any scale, built a block at a time: each
    of ``n_codes`` barcodes is one 30 kb molecule of a
    :func:`blocked_genome` with ``n_reads / n_codes`` 150 bp reads drawn
    inside it; reads come sorted by barcode.  Reads are gathered and 2-bit
    packed ``chunk`` at a time (a memory bound only: the output does not
    depend on it), so host memory holds the genome, the packed lane and
    one chunk.  Its random stream is not ``make_barcodes_lane``'s.

    With ``het_rate`` > 0 the sample is diploid: the second haplotype is
    :func:`blocked_snps` of the genome, and each molecule takes its reads
    from the haplotype ``default_rng([seed, 3])`` draws for it; at 0 no
    draw is made and the lane's bytes are the haploid lane's.  With
    ``return_haplotypes`` returns (Fqb, [haplotypes]) instead of the Fqb."""
    if n_reads % n_codes:
        raise ValueError("n_reads must be a multiple of n_codes")
    genome = blocked_genome(genome_len, seed)
    haps = [genome]
    if het_rate > 0:
        haps.append(blocked_snps(genome, het_rate, seed))
    rng = np.random.default_rng([seed, 0])
    mol_starts = rng.integers(0, genome_len - MOLECULE, size=n_codes)
    offs = rng.integers(0, MOLECULE - READ_LEN, size=n_reads,
                        dtype=np.int32)
    bc_ids = np.repeat(np.arange(n_codes, dtype=np.int32),
                       n_reads // n_codes)
    hap_of_mol = (np.random.default_rng([seed, 3]).integers(
        0, 2, size=n_codes) if het_rate > 0 else None)
    words = (READ_LEN + 15) // 16
    packed = np.empty((n_reads, words), np.uint32)
    windows = [np.lib.stride_tricks.sliding_window_view(h, READ_LEN)
               for h in haps]
    padded = np.zeros((chunk, 16 * words), np.uint8)
    for a in range(0, n_reads, chunk):
        b = min(a + chunk, n_reads)
        starts = mol_starts[bc_ids[a:b]] + offs[a:b]
        reads = padded[:b - a]
        reads[:, :READ_LEN] = windows[0][starts]
        if hap_of_mol is not None:
            on2 = np.flatnonzero(hap_of_mol[bc_ids[a:b]] == 1)
            reads[on2, :READ_LEN] = windows[1][starts[on2]]
        # pack_2bit's layout (base j at bits 2j of word j // 16), four
        # bases per byte, the bytes read as little-endian uint32 words
        q = reads.reshape(b - a, 4 * words, 4)
        byte = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) \
            | (q[..., 3] << 6)
        packed[a:b] = byte.view("<u4")
    fqb = Fqb(packed=packed, lengths=np.full(n_reads, READ_LEN, np.int32),
              barcode_ids=bc_ids,
              barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=READ_LEN)
    return (fqb, haps) if return_haplotypes else fqb


_ASCII = b"ACGT" + b"N" * 252   # base code -> letter, for bytes.translate


def write_fasta_records(path, genome: np.ndarray, n_records: int,
                        width: int = 60) -> None:
    """``genome`` (base codes) as ``n_records`` FASTA records of equal
    length (``chr1``, ``chr2``, ...; the last takes the remainder), as an
    assembly splits into chromosomes, ``width`` bases a line."""
    step = len(genome) // n_records
    with open(path, "wb") as f:
        for r in range(n_records):
            end = len(genome) if r == n_records - 1 else (r + 1) * step
            seq = np.frombuffer(genome[r * step:end].tobytes().translate(
                _ASCII), np.uint8)
            full = len(seq) // width * width
            body = np.empty((full // width, width + 1), np.uint8)
            body[:, :width] = seq[:full].reshape(-1, width)
            body[:, width] = ord("\n")
            f.write(b">chr%d\n" % (r + 1))
            f.write(body.data)
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")


def lane_fqb(reads: np.ndarray, bc_ids=None, n_codes: int = 1) -> Fqb:
    n = len(reads)
    return Fqb(packed=pack_2bit(reads),
               lengths=np.full(n, READ_LEN, np.int32),
               barcode_ids=(np.zeros(n, np.int32) if bc_ids is None
                            else bc_ids),
               barcode_keys=np.arange(n_codes, dtype=np.uint32),
               read_len=READ_LEN)


def synth_incidence(n_codes: int, n_kmers: int, per_code: int):
    """bench.py's synthesized incidence (seed 5): each code holds
    ``per_code`` k-mers drawn from two 64-wide spans.  Returns flat
    (k-mer ids, code ids)."""
    rng = np.random.default_rng(5)
    spans = rng.integers(0, n_kmers - 64, size=(n_codes, 2))
    ks, cs = [], []
    for j in range(2):
        offs = rng.integers(0, 64, size=(n_codes, per_code // 2))
        ks.append((spans[:, j:j + 1] + offs).reshape(-1))
        cs.append(np.repeat(np.arange(n_codes), per_code // 2))
    return np.concatenate(ks), np.concatenate(cs)


def _molecules(inc, labels: torch.Tensor) -> int:
    """Distinct (code, label) pairs: labels are canonical per-code ranks."""
    if inc.n_pairs == 0:
        return 0
    per_code = torch.zeros(inc.n_codes, dtype=torch.int64, device=inc.device)
    per_code.scatter_reduce_(0, inc.code_of_pair(), labels + 1, "amax")
    return int(per_code.sum())


# -- the C stand-in -----------------------------------------------------------

def c_ref_exe(tmp: str) -> str:
    """native/c_ref/hash10x_ref.c built with gcc into ``tmp``."""
    exe = os.path.join(tmp, "hash10x_ref")
    subprocess.run(["gcc", "-O3", "-march=native", "-o", exe, str(C_SOURCE)],
                   check=True, capture_output=True)
    return exe


def _write_reads(path: str, reads: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.array([len(reads), reads.shape[1]], np.uint32).tofile(f)
        reads.astype(np.uint8).tofile(f)


def _c_fields(out: str) -> dict:
    toks = out.split()
    return dict(zip(toks[::2], toks[1::2]))


def bench_c(exe: str, tmp: str, reads: np.ndarray, runs: int = RUNS) -> dict:
    """The C stand-in's count of the first ``C_SUBSET`` reads (no
    barcodes), its own timer: reads/s, median of ``runs``."""
    sub = reads[:C_SUBSET]
    path = os.path.join(tmp, "count_reads.bin")
    _write_reads(path, sub)
    secs = []
    for _ in range(runs):
        out = subprocess.run([exe, path, str(K), str(W), str(SEED), "22"],
                             check=True, capture_output=True, text=True,
                             timeout=600).stdout
        secs.append(float(_c_fields(out)["seconds"]))
    s = spread(secs)
    return {"reads_per_s": len(sub) / s["median"], "seconds": s,
            "n_reads": len(sub)}


def run_c_full(exe: str, tmp: str, reads: np.ndarray, bc_ids: np.ndarray,
               min_friend_share: int) -> dict:
    """The C stand-in's full pipeline on a barcodes lane (count, band
    [2, 64], friend clustering).  Table bits 24: it lists the distinct
    hashes in its 2^bits arrays, and 2^22 overflows them on the 800k
    lane."""
    rb = os.path.join(tmp, "bc_reads.bin")
    bb = os.path.join(tmp, "bc_codes.bin")
    _write_reads(rb, reads)
    bc_ids.astype(np.uint32).tofile(bb)
    t0 = time.monotonic()
    out = subprocess.run(
        [exe, rb, str(K), str(W), str(SEED), "24", "--barcodes", bb,
         "--minCount", "2", "--maxCount", "64", "--friendShare",
         str(min_friend_share), "--cluster"],
        check=True, capture_output=True, text=True, timeout=1800).stdout
    wall = time.monotonic() - t0
    vals = _c_fields(out)
    c_s = float(vals["seconds"]) + float(vals["cluster_seconds"])
    return {"c_molecules": int(vals["molecules"]),
            "c_full_pipeline_s": c_s, "c_process_wall_s": wall,
            "c_full_pipeline_reads_per_s": len(reads) / c_s}


# -- points -------------------------------------------------------------------

def launch_floor_ms(device: torch.device, runs: int = RUNS,
                    reps: int = 200) -> dict:
    """The card's launch-plus-sync floor: a one-element add, then
    ``synchronize``, on the host clock; ms per pair, ``reps`` per run."""
    x = torch.zeros(1, device=device)
    x.add_(1)
    sync(device)
    per = []
    for _ in range(runs):
        t0 = time.monotonic()
        for _ in range(reps):
            x.add_(1)
            sync(device)
        per.append((time.monotonic() - t0) / reps * 1e3)
    return spread(per)


def bench_engine(reads: np.ndarray, device: torch.device, runs: int = RUNS,
                 batch: int = BATCH, table_bits: int = 20):
    """The occurrences-mode count pass, hot and cold, alternating per run.
    Returns (hot point, cold point)."""
    fqb = lane_fqb(reads)
    n = len(reads)
    eng = Engine(EngineConfig(spec=_spec(), count_mode="occurrences",
                              table_bits=table_bits, batch_reads=batch),
                 device, log=None)

    def run():
        eng.reset()
        return timed(device, lambda: eng.count(fqb))
    run()   # builds the kernel, caches the lane
    hot, cold = [], []
    for _ in range(runs):
        eng._lane_cache = None
        cold.append(run())
        hot.append(run())
    h, c = spread(hot), spread(cold)
    base = {"n_reads": n, "n_kmers": eng.table.n_filled,
            "dispatches": eng.stats["dispatches"],
            "flushes": eng.stats["flushes"]}
    return ({"name": "engine_count_hot", "reads_per_s": n / h["median"],
             "wall_s": h, **base,
             "note": "reset() + recount, the lane on the device"},
            {"name": "engine_count_cold", "reads_per_s": n / c["median"],
             "wall_s": c, **base,
             "note": "lane cache cleared: the host-to-device copy of the "
                     "packed lane is inside the wall"})


def _flush_table(cap: int, bufc: int, device: torch.device):
    """bench.py:204's flush shapes: a table half full of sorted random keys
    at capacity ``cap`` and a full buffer of ``bufc`` random keys."""
    rng = np.random.default_rng(3)
    h = np.full(cap, INT64_MAX, np.int64)
    h[:cap // 2] = np.sort(rng.integers(0, 2 ** 62, size=cap // 2))
    c = np.zeros(cap, np.int32)
    c[:cap // 2] = 1
    buf = rng.integers(0, 2 ** 62, size=bufc).astype(np.int64)
    return st.SortedTable(torch.from_numpy(h).to(device),
                          torch.from_numpy(c).to(device),
                          torch.from_numpy(buf).to(device),
                          torch.ones(bufc, dtype=torch.int32, device=device),
                          buf_n=bufc, n_filled=cap // 2)


def bench_breakdown(reads: np.ndarray, device: torch.device,
                    floor: dict = None, runs: int = RUNS, batch: int = BATCH,
                    cap: int = 1 << 20, bufc: int = 1 << 21,
                    steps: int = 20) -> dict:
    """Per-stage attribution of the count pass: launch floor, one batch's
    step, the kernel alone, their difference, and the flush merge, each
    against its bound."""
    spec = _spec()
    P = READ_LEN - K + 1
    eng = Engine(EngineConfig(spec=spec, batch_reads=batch), device, log=None)
    C = eng._compact_rows(P)
    slots = eng._batch_slots(batch, P, batch * C)
    floor = floor or launch_floor_ms(device, runs)
    packed = torch.from_numpy(pack_2bit(reads[:batch]).view(np.int32)) \
        .to(device)
    lens = torch.full((batch,), READ_LEN, dtype=torch.int32, device=device)

    def step():
        codes = unpack_2bit_torch(packed, READ_LEN)
        h, _, emit, _ = MK.sketch(spec, codes, lens, compact_to=C)
        return st.dedup_weighted(torch.where(emit, h, INT64_MAX).reshape(-1),
                                 slots)

    def steps_ms():
        return timed(device, lambda: [step() for _ in range(steps)]) \
            * 1e3 / steps
    steps_ms()
    step_ms = spread([steps_ms() for _ in range(runs)])
    nbytes, ops, bound_ms, bound_by = MK.sketch_bound(batch, READ_LEN, C, K)
    point = {"name": "count_breakdown", "launch_floor_ms": floor,
             "step_ms_per_batch": step_ms, "batch_reads": batch,
             "compact_to": C, "dedup_slots": slots,
             "kernel_bound_ms": bound_ms, "kernel_bound_by": bound_by,
             "kernel_bytes": nbytes, "kernel_int32_ops": ops}
    if device.type == "cuda":
        codes = unpack_2bit_torch(packed, READ_LEN)
        launch = MK.launcher(spec, codes, lens, compact_to=C)
        kern = spread([kernel_device_ms(launch) for _ in range(runs)])
        point.update(
            kernel_only_ms_per_batch=kern,
            kernel_bound_share=bound_ms / kern["median"],
            dedup_share_ms_per_batch=step_ms["median"] - kern["median"])
    else:
        point.update(kernel_only_ms_per_batch=None,
                     kernel_bound_share=None, dedup_share_ms_per_batch=None)

    t = _flush_table(cap, bufc, device)
    st.flush_grow(t)
    flush = spread([timed(device, lambda: st.flush_grow(t)) * 1e3
                    for _ in range(runs)])
    # flush_grow sorts the buffer once (torch.sort: int64 keys and an
    # int64 index payload; CUB's radix sort makes 64 / RADIX_BITS digit
    # passes, each reading and writing every key and payload once), then
    # merges it into the sorted table: the table's n and the buffer's keys
    # (8 B) and counts (4 B) read once and the merged table written once
    # (the buffer's random keys are distinct)
    n_el = bufc
    n = cap // 2
    passes = 64 // RADIX_BITS
    sort_bytes = 1 * passes * n_el * (8 + 8) * 2
    merge_bytes = (n + bufc) * (8 + 4) * 2
    flush_bound_ms = (sort_bytes + merge_bytes) / MK.HBM_BYTES_PER_S * 1e3
    point.update(
        flush_merge_ms=flush,
        flush_sorted_elements=n_el, flush_sorts=1, flush_digit_passes=passes,
        flush_merge_bytes=merge_bytes,
        flush_bound_ms=flush_bound_ms, flush_bound_by="bytes",
        flush_bound_share=flush_bound_ms / flush["median"],
        flush_bound_model=(
            f"(1 sort of the buffer x {passes} digit passes x {n_el} "
            "elements x (8 B key + 8 B index payload) x 2 (read and write) "
            f"+ merge ({n} table + {bufc} buffer entries x 12 B x 2)) / "
            f"{MK.HBM_BYTES_PER_S / 1e12:.2f} TB/s"))
    return point


def bench_barcodes(n_reads: int, n_codes: int, device: torch.device,
                   floor_ms: float, runs: int = RUNS,
                   genome_len: int = BC_GENOME, c_exe: str = None,
                   tmp: str = None, profile: bool = True) -> dict:
    """The barcodes-mode lane through count, filter + incidence, cluster,
    split and report: one cold pass, ``runs`` warm passes, the C
    stand-in's full pipeline after them (with ``c_exe``), and one profiled
    warm pass (with ``profile``)."""
    reads, bc_ids = make_barcodes_lane(n_reads, n_codes, genome_len)
    fqb = lane_fqb(reads, bc_ids, n_codes)
    cfg = EngineConfig(spec=_spec(), count_mode="barcodes", table_bits=22,
                       batch_reads=BATCH, min_count=2, max_count=64)
    eng = Engine(cfg, device, log=None)

    def pipeline():
        walls, counters = {}, {}
        eng.reset()
        walls["count_s"] = timed(device, lambda: eng.count(fqb))
        counters["count"] = dict(eng.stats)
        eng.stats = {"dispatches": 0, "flushes": 0}
        walls["filter_incidence_s"] = timed(
            device, lambda: (eng.filter(), eng.incidence(fqb)))
        counters["incidence"] = dict(eng.stats)
        walls["cluster_s"] = timed(device, eng.cluster)
        walls["split_s"] = timed(device, eng.split)
        out = io.StringIO()
        walls["report_s"] = timed(device, lambda: eng.report(out))
        walls["reads_per_s_end_to_end"] = n_reads / sum(
            v for k, v in walls.items() if k.endswith("_s"))
        return walls, counters, out.getvalue()

    cold, _, want = pipeline()
    warm = []
    for _ in range(runs):
        walls, counters, text = pipeline()
        if text != want:
            raise RuntimeError("the report changed between passes")
        warm.append(walls)
    molecules = int(eng.split_origin.shape[0])
    phases = {k: spread([w[k] for w in warm]) for k in warm[0]}
    attribution = {}
    for stage, key in (("count", "count_s"),
                       ("incidence", "filter_incidence_s")):
        d, f = counters[stage]["dispatches"], counters[stage]["flushes"]
        floor_s = d * floor_ms / 1e3
        attribution[stage] = {
            "wall_s": phases[key]["median"], "dispatches": d, "flushes": f,
            "dispatches_x_launch_floor_s": floor_s,
            "share_of_wall": floor_s / phases[key]["median"]}
    point = {"n_reads": n_reads, "n_codes": n_codes,
             "n_pairs": eng.inc.n_pairs, "molecules": molecules,
             "cold": cold, "warm": phases,
             "reads_per_s_end_to_end": phases["reads_per_s_end_to_end"]
             ["median"],
             "attribution": attribution,
             "note": "cold is the first pass: the lane's host-to-device "
                     "copy and the allocator's first growth; warm passes "
                     "reset() and rerun with the lane on the device"}
    if profile:
        point["profile"] = profiled_pass(device, pipeline)
    if c_exe is not None:
        c = run_c_full(c_exe, tmp, reads, bc_ids, cfg.min_friend_share)
        point.update(c)
        point["vs_c_full_pipeline"] = (point["reads_per_s_end_to_end"]
                                       / c["c_full_pipeline_reads_per_s"])
        point["correct"] = c["c_molecules"] == molecules
    return point


def profiled_pass(device: torch.device, pipeline) -> dict:
    """One warm pass under torch.profiler: the device's busy time (the
    union of its kernel, copy and set intervals) over the pass's phase
    walls, and the five device operations with the most time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        walls, _, _ = pipeline()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    phase_sum = sum(v for k, v in walls.items() if k.endswith("_s"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"phase_walls_s": walls, "busy_ms": busy / 1e3,
            "busy_share": busy / 1e6 / phase_sum,
            "top_device_ms": [[name[:70], us / 1e3] for name, us in top],
            "note": "a separate traced pass; the walls of the point are "
                    "untraced"}


def bench_routing_ab(reads: np.ndarray, device: torch.device,
                     runs: int = RUNS, batch: int = BATCH) -> dict:
    """The sharded count path at n_shards=1 against the plain count on the
    same lane, alternating (plain, sharded, sharded, plain, ...)."""
    fqb = lane_fqb(reads)
    n = len(reads)

    def engine(n_shards):
        return Engine(EngineConfig(spec=_spec(), count_mode="occurrences",
                                   table_bits=20, batch_reads=batch,
                                   n_shards=n_shards), device, log=None)
    plain, sharded = engine(1), engine(1)

    def run_plain():
        plain.reset()
        return timed(device, lambda: plain.count(fqb))

    def run_sharded():
        sharded.reset()
        # n_shards=1 takes the plain path in count(): drive the sharded
        # pass directly
        return timed(device, lambda: sharded._count_sharded(fqb, False))
    run_plain()
    run_sharded()
    walls = {"plain": [], "sharded": []}
    for i in range(runs):
        order = ("plain", "sharded") if i % 2 == 0 else ("sharded", "plain")
        for side in order:
            walls[side].append(run_plain() if side == "plain"
                               else run_sharded())
    ph, pc = st.compact(plain._flushed())
    sh, sc = st.compact(sharded._flushed())
    if not (torch.equal(ph, sh) and torch.equal(pc, sc)):
        raise RuntimeError("the n_shards=1 sharded table != the plain table")
    p, s = spread(walls["plain"]), spread(walls["sharded"])
    n_batches = -(-n // batch)
    return {"name": "routing_ab_1chip", "reads_per_s": n / s["median"],
            "wall_s": s, "plain_reads_per_s": n / p["median"],
            "plain_wall_s": p, "tables_equal": True,
            "sharded_minus_plain_ms_per_batch":
                (s["median"] - p["median"]) * 1e3 / n_batches,
            "note": "the port's n_shards=1 sharded step does not run the "
                    "lane code (SortedCountStep skips the send lanes and "
                    "the all_to_all at n = 1, and H10X_FORCE_ROUTING is "
                    "not ported): the A/B measures the sharded table's "
                    "machinery (per-shard buffers, the drop and overflow "
                    "reductions), not routing"}


def bench_cluster(device: torch.device, n_codes: int = 200_000,
                  n_kmers: int = 2_000_000, per_code: int = 30,
                  runs: int = RUNS, name: str = "cluster_200k_codes") -> dict:
    """``cluster_codes_sparse(min_friend_share=4)`` on bench.py's
    synthesized incidence, built with ``build_incidence`` on the device:
    one cold call, then ``runs`` warm calls with equal labels."""
    ks, cs = synth_incidence(n_codes, n_kmers, per_code)
    holder = {}
    build_s = timed(device, lambda: holder.update(inc=build_incidence(
        ks, cs, n_kmers, n_codes, device)))
    inc = holder["inc"]

    def call():
        holder["labels"] = SP.cluster_codes_sparse(inc, min_friend_share=4)
    cold = timed(device, call)
    want = holder["labels"]
    warm = []
    for _ in range(runs):
        warm.append(timed(device, call))
        if not torch.equal(holder["labels"], want):
            raise RuntimeError("cluster labels changed between calls")
    return {"name": name, "n_codes": n_codes, "n_kmers": n_kmers,
            "n_pairs": inc.n_pairs, "molecules": _molecules(inc, want),
            "build_incidence_s": build_s, "wall_cold_s": cold,
            "wall_warm_s": spread(warm), "labels_equal": True,
            "note": "cold is the first call in the process"}


def bench_shards_curve(device: torch.device, n_reads: int = 1 << 14,
                       batch: int = 2048, shards=(1, 2, 4, 8),
                       cluster_shards=(2, 4, 8), cluster_size=(4096, 65536,
                                                              24),
                       runs: int = RUNS) -> dict:
    """Count-pass walls at each shard count stacked on one device (the
    sharded pass driven directly, so n = 1 runs the same code), and sharded
    clustering of a small synthesized incidence, labels equal to the
    single-device labels."""
    fqb = lane_fqb(make_lane(n_reads))
    curve, n_kmers = [], set()
    for s in shards:
        eng = Engine(EngineConfig(spec=_spec(), count_mode="occurrences",
                                  table_bits=20, batch_reads=batch,
                                  n_shards=s), device, log=None)

        def run():
            eng.reset()
            return timed(device, lambda: eng._count_sharded(fqb, False))
        run()
        w = spread([run() for _ in range(runs)])
        n_kmers.add(eng._dt.n_filled())
        curve.append({"n_shards": s, "reads_per_s": n_reads / w["median"],
                      "wall_s": w})
    if len(n_kmers) != 1:
        raise RuntimeError(f"shard counts disagree on the table: {n_kmers}")
    n_codes, nk, per_code = cluster_size
    inc = build_incidence(*synth_incidence(n_codes, nk, per_code), nk,
                          n_codes, device)
    want = SP.cluster_codes_sparse(inc, min_friend_share=4)
    clusters = [{"n_shards": 1, "wall_s": spread([timed(
        device, lambda: SP.cluster_codes_sparse(inc, min_friend_share=4))
        for _ in range(runs)])}]
    for s in cluster_shards:
        g = ShardGroup(s, device)
        walls = []
        for _ in range(runs):
            holder = {}
            walls.append(timed(device, lambda: holder.update(
                got=cluster_codes_sparse_dist(inc, g, min_friend_share=4,
                                              flat=True))))
            if not torch.equal(holder["got"], want):
                raise RuntimeError(f"{s}-shard labels != single-device "
                                   "labels")
        clusters.append({"n_shards": s, "wall_s": spread(walls)})
    return {"name": "shards_curve_one_card", "n_reads": n_reads,
            "batch_reads": batch, "n_kmers": n_kmers.pop(),
            "count_curve": curve, "cluster_curve": clusters,
            "cluster_pairs": inc.n_pairs, "labels_equal": True,
            "note": "every shard sits on the one card, so the curve shows "
                    "the cost of sharding (more, smaller launches and "
                    "sorts), not its gain"}


# -- the summary line ---------------------------------------------------------

def _brief(p: dict) -> dict:
    """A point's few key numbers for the compact summary line."""
    b = {"name": p["name"]}
    for k in ("reads_per_s", "reads_per_s_end_to_end", "vs_c_full_pipeline",
              "correct", "molecules", "c_molecules"):
        if k in p:
            b[k] = p[k]
    for k in ("wall_s", "wall_warm_s", "step_ms_per_batch",
              "kernel_only_ms_per_batch", "flush_merge_ms"):
        if isinstance(p.get(k), dict):
            b[k] = [p[k]["median"], p[k]["min"], p[k]["max"]]
    if "reduced" in p:
        b["reduced"] = p["reduced"]
    return b


def _round(x):
    if isinstance(x, float):
        return float(f"{x:.6g}")
    if isinstance(x, dict):
        return {k: _round(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_round(v) for v in x]
    return x


class Summary:
    """The points so far, the skipped ones, and the compact line printed
    after every point; the full payload goes to ``detail``."""

    def __init__(self, budget_s: float, device_info: dict,
                 detail: Path = DETAIL, out=sys.stdout):
        self.t0 = time.monotonic()
        self.budget_s = budget_s
        self.points, self.skipped, self.failed = [], [], []
        self.head = {"metric": "count_pass_reads_per_s", "value": 0,
                     "unit": "reads/s", "vs_baseline": 0}
        self.device_info = device_info
        self.detail = detail
        self.out = out

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def line(self, final: bool = False) -> str:
        line = dict(self.head, points_brief=[_brief(p) for p in self.points],
                    skipped=self.skipped, budget_s=self.budget_s,
                    elapsed_s=round(time.monotonic() - self.t0, 1),
                    device=self.device_info)
        if final:
            line["final"] = True
        text = json.dumps(_round(line), separators=(",", ":"))
        if len(text) > SUMMARY_MAX:
            line["points_brief"] = [{"name": p["name"]} for p in self.points]
            text = json.dumps(_round(line), separators=(",", ":"))
        return text

    def emit(self, final: bool = False) -> None:
        line = self.line(final)
        print(line, file=self.out, flush=True)
        payload = dict(json.loads(line), points=self.points)
        self.detail.parent.mkdir(parents=True, exist_ok=True)
        with open(self.detail, "w") as f:
            json.dump(_round(payload), f, indent=1)


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    name, power = r.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": power.strip(),
            "torch_name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# Seconds each point needs, about three times what it took on an NVIDIA
# H100 80GB HBM3 at 700 W (the full barcodes point 45 s, the C stand-in's
# 19 s included; the others 0.3-2.1 s).  The barcodes point takes the full
# lane when BARCODES_FULL seconds are left, else a quarter lane.
ESTIMATES = {"engine_barcodes": 60, "count_breakdown": 20,
             "routing_ab_1chip": 20, "cluster_200k_codes": 20,
             "shards_curve_one_card": 30}
BARCODES_FULL = 150


def run_plan(summary: Summary, plan, estimates=ESTIMATES) -> None:
    """Run each (name, point function) whose estimate fits the time left;
    a skipped point is named with its reason (the budget, or the error
    that stopped it; a point that raised is also named in
    ``summary.failed``), and the summary is printed after every point."""
    for name, fn in plan:
        left = summary.remaining()
        if left < estimates[name]:
            summary.skipped.append(
                {"name": name, "reason": f"budget: {left:.0f} s left < "
                                         f"~{estimates[name]} s"})
        else:
            try:
                summary.points.append(fn())
            except Exception as e:   # the other points still run
                traceback.print_exc()
                summary.failed.append(name)
                summary.skipped.append(
                    {"name": name,
                     "reason": f"{type(e).__name__}: {e}"[:200]})
        summary.emit()


def main() -> int:
    budget_s = float(os.environ.get("H10X_BENCH_BUDGET_S", "1200"))
    if not torch.cuda.is_available():
        print(json.dumps({"metric": "count_pass_reads_per_s", "value": 0,
                          "unit": "reads/s", "vs_baseline": 0,
                          "note": "no CUDA device (torch.cuda.is_available() "
                                  "is false): the bench measures the card "
                                  "and does not run on the CPU"}))
        return 1
    device = torch.device("cuda")
    summary = Summary(budget_s, card_info())
    with tempfile.TemporaryDirectory() as tmp:
        exe = c_ref_exe(tmp)
        reads = make_lane()
        c = bench_c(exe, tmp, reads)
        hot, cold = bench_engine(reads, device)
        hot["c_ref"] = c
        summary.head.update(value=hot["reads_per_s"],
                            vs_baseline=hot["reads_per_s"]
                            / c["reads_per_s"])
        summary.points += [hot, cold]
        summary.emit()
        floor = launch_floor_ms(device)

        def barcodes():
            if summary.remaining() > BARCODES_FULL:
                p = bench_barcodes(BC_READS, BC_CODES, device,
                                   floor["median"], c_exe=exe, tmp=tmp)
                p["name"] = "engine_barcodes_800k_reads_50k_codes"
            else:
                p = bench_barcodes(BC_READS // 4, BC_CODES // 4, device,
                                   floor["median"], c_exe=exe, tmp=tmp)
                p["name"] = "engine_barcodes_200k_reads_12k_codes_reduced"
                p["reduced"] = "quarter lane: the bench budget was short"
            return p

        plan = [("engine_barcodes", barcodes),
                ("count_breakdown",
                 lambda: bench_breakdown(reads, device, floor)),
                ("routing_ab_1chip", lambda: bench_routing_ab(reads, device)),
                ("cluster_200k_codes", lambda: bench_cluster(device)),
                ("shards_curve_one_card", lambda: bench_shards_curve(device))]
        run_plan(summary, plan)
    summary.emit(final=True)
    return 1 if summary.failed else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:   # always leave one honest JSON line
        traceback.print_exc()
        print(json.dumps({"metric": "count_pass_reads_per_s", "value": 0,
                          "unit": "reads/s", "vs_baseline": 0,
                          "note": f"bench failed: {type(e).__name__}: "
                                  f"{e}"[:300]}))
        sys.exit(1)
