"""Crib evaluation of the port (``hash10x_tpu_torch/crib/crib.py``) against
the JAX package's ``genome_kmer_counts``, ``build_crib`` and
``crib_report``, and the crib CLI lane against ``python -m hash10x_tpu``.
Every comparison is exact (tolerance: none); CLI text may differ only in the
number after ``table slots``."""

import io
import re

import numpy as np
import pytest
import torch

from hash10x_tpu.cli.main import main as jax_main
from hash10x_tpu.cluster import cooccur as JC
from hash10x_tpu.crib import crib as JCRIB
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.sim import SimConfig, simulate
from hash10x_tpu.table.incidence import build_incidence
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.cli.main import main
from hash10x_tpu_torch.core.encode import codes_to_ascii
from hash10x_tpu_torch.crib import crib as C
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.kernels import minimizer as MK

torch.set_num_threads(2)

K = 15
SLOTS = re.compile(r"^table slots \d+ ", re.M)


def write_fasta(path, records):
    with open(path, "wb") as f:
        for name, codes in records:
            f.write(b">" + name + b"\n" + codes_to_ascii(codes) + b"\n")


def _kmer_hashes(spec, codes):
    """Every valid canonical k-mer hash of one sequence (plain sketch)."""
    if len(codes) < spec.k:
        return np.zeros(0, np.int64)
    h, _, valid, _ = MK.sketch_plain(
        spec, torch.from_numpy(codes[None].astype(np.uint8)),
        torch.tensor([len(codes)], dtype=torch.int32), mode="kmer")
    return h[valid].numpy()


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Two haplotypes as multi-record FASTAs: a 70 kb record (three 32 kb
    rows and their k-1 overlaps) with an N block, a record shorter than k,
    one of exactly k bases, a repeat (MUL k-mers), SNPs (HET k-mers), and a
    second haplotype whose records are split differently.  The retained set
    is half of the genome k-mers plus absent hashes (ERR)."""
    tmp = tmp_path_factory.mktemp("crib")
    rng = np.random.default_rng(8)
    chr1 = rng.integers(0, 4, 70_000).astype(np.uint8)
    chr1[40_000:40_500] = 4                      # N block
    chr1[60_000:63_000] = chr1[5_000:8_000]      # repeat
    short = rng.integers(0, 4, K - 5).astype(np.uint8)
    exact = rng.integers(0, 4, K).astype(np.uint8)
    chr3 = rng.integers(0, 4, 5_000).astype(np.uint8)
    chr3[:50] = 4                                # leading Ns
    hap1 = [(b"chr1 assembled", chr1), (b"short", short), (b"exact", exact),
            (b"chr3", chr3)]
    h2 = chr1.copy()
    snps = rng.choice(70_000, size=60, replace=False)
    h2[snps] = (h2[snps] + 1) % 4
    hap2 = [(b"h2a", h2[:33_000]), (b"h2b", h2[33_000:]), (b"h2c", chr3)]
    fa1, fa2 = tmp / "h1.fa", tmp / "h2.fa"
    write_fasta(fa1, hap1)
    write_fasta(fa2, hap2)
    spec = HashSpec(k=K, w=1, seed=17)
    all_h = np.unique(np.concatenate([_kmer_hashes(spec, c)
                                      for _, c in hap1 + hap2]))
    keep = all_h[rng.random(len(all_h)) < 0.5]
    absent = rng.integers(0, 1 << (2 * K), size=200)
    retained = np.unique(np.concatenate([keep, absent])).astype(np.uint64)
    return dict(fa1=fa1, fa2=fa2, retained=retained,
                jspec=JHashSpec(k=K, w=1, seed=17), spec=spec)


def _same_crib(a, b):
    assert a.n_haps == b.n_haps
    assert a.labels.dtype == b.labels.dtype and (a.labels == b.labels).all()
    assert a.hap_counts.dtype == b.hap_counts.dtype
    assert (a.hap_counts == b.hap_counts).all()
    assert (a.positions == b.positions).all()
    assert (a.rec_starts == b.rec_starts).all()
    assert a.rec_names == b.rec_names


def test_genome_kmer_counts_matches_jax(genomes):
    g = genomes
    ret = convert.keys_from_numpy(g["retained"], "cpu")
    for fa in (g["fa1"], g["fa2"]):
        want = JCRIB.genome_kmer_counts(g["jspec"], g["retained"], fa,
                                        with_positions=True)
        got = C.genome_kmer_counts(g["spec"], ret, fa, with_positions=True)
        assert got[0].dtype == np.uint32
        for a, b in zip(got[:3], want[:3]):
            assert (a == b).all()
        assert got[3] == want[3]
        assert got[0].sum() > 0 and (got[1] >= 0).sum() > 0
    assert C.genome_kmer_counts(g["spec"], ret[:0], g["fa1"]).shape == (0,)


@pytest.mark.parametrize("n_haps", [1, 2])
def test_build_crib_matches_jax(genomes, n_haps):
    g = genomes
    paths = [g["fa1"], g["fa2"]][:n_haps]
    want = JCRIB.build_crib(g["jspec"], g["retained"], paths)
    got = C.build_crib(g["spec"], convert.keys_from_numpy(g["retained"],
                                                          "cpu"), paths)
    _same_crib(got, want)
    comp = got.composition()
    assert comp[C.ERR] >= 200 and comp[C.MUL] > 0
    if n_haps == 2:
        assert comp[C.HET1] > 0 and comp[C.HET2] > 0


@pytest.mark.parametrize("rows", [1, 32, 1024])
def test_crib_independent_of_row_height(genomes, rows):
    g = genomes
    ret = convert.keys_from_numpy(g["retained"], "cpu")
    paths = [g["fa1"], g["fa2"]]
    _same_crib(C.build_crib(g["spec"], ret, paths, rows=rows),
               C.build_crib(g["spec"], ret, paths, rows=2))


def test_crib_report_matches_jax(genomes, rng):
    """Same incidence, labels and crib: byte-identical report."""
    g = genomes
    jcrib = JCRIB.build_crib(g["jspec"], g["retained"], [g["fa1"], g["fa2"]])
    crib = C.Crib(labels=jcrib.labels, hap_counts=jcrib.hap_counts,
                  n_haps=jcrib.n_haps, positions=jcrib.positions,
                  rec_starts=jcrib.rec_starts, rec_names=jcrib.rec_names)
    n_kmers, n_codes = len(g["retained"]), 30
    pairs = rng.random((n_kmers, n_codes)) < 0.01
    k, c = np.nonzero(pairs)
    inc = build_incidence(k.astype(np.int32), c.astype(np.int32), n_kmers,
                          n_codes)
    labels = np.asarray(JC.cluster_codes(inc, mode="friend", max_friends=4,
                                         min_friend_share=1, flat=True))
    want, got = io.StringIO(), io.StringIO()
    JCRIB.crib_report(inc, labels, jcrib, want)
    C.crib_report(convert.incidence_from_numpy(inc, "cpu"),
                  convert.labels_from_numpy(labels, "cpu"), crib, got)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("\n") > n_codes and "crib overall" in \
        got.getvalue()


def test_crib_report_chrom_boundary_matches_jax():
    """tests/test_cli.py's boundary case: a cluster straddling two records
    names the smaller record on a tie and spans record-local positions."""
    n_k = 16
    positions = np.concatenate([np.arange(100, 108),
                                np.arange(200, 208)]).astype(np.int64)
    fields = dict(labels=np.full(n_k, C.HET1, np.uint8),
                  hap_counts=np.ones((1, n_k), np.uint32), n_haps=1,
                  positions=positions, rec_starts=np.array([0, 200], np.int64),
                  rec_names=["chr1", "chr2"])
    inc = build_incidence(np.arange(n_k, dtype=np.int32),
                          np.zeros(n_k, np.int32), n_kmers=n_k, n_codes=1)
    want, got = io.StringIO(), io.StringIO()
    JCRIB.crib_report(inc, np.zeros(n_k, np.int64), JCRIB.Crib(**fields),
                      want)
    C.crib_report(convert.incidence_from_numpy(inc, "cpu"),
                  torch.zeros(n_k, dtype=torch.int64), C.Crib(**fields), got)
    assert got.getvalue() == want.getvalue()
    line = [l for l in got.getvalue().splitlines()
            if l.startswith("code 0 cluster 0")][0]
    assert " chrom chr1 " in line and int(line.rsplit("span ", 1)[1]) < 10


def test_cli_crib_lane_matches_jax_cli(tmp_path):
    """tests/test_cli.py's diploid lane through both CLIs."""
    sim = simulate(SimConfig(genome_len=300_000, n_barcodes=150,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=40, read_len=120,
                             het_rate=0.005, seed=4))
    fa1, fa2 = tmp_path / "h1.fa", tmp_path / "h2.fa"
    write_fasta(fa1, [(b"hap0", sim.genome)])
    write_fasta(fa2, [(b"hap1", sim.genome_hap1)])
    lane = str(tmp_path / "lane.fqb")
    JFB.save_fqb(lane, JFB.from_read_batch(sim.reads))
    args = ["-k", "17", "-w", "7", "-B", "14", "--readFQB", lane + ".npz",
            "--friendShare", "20", "--codeClusters", "--cribBuild",
            str(fa1), str(fa2), "--cribReport"]
    outs, errs = [], []
    for fn, pre in ((jax_main, []), (main, ["--device", "cpu"])):
        out, err = io.StringIO(), io.StringIO()
        assert fn(pre + args, out=out, err=err) == 0
        outs.append(SLOTS.sub("table slots N ", out.getvalue()))
        errs.append(err.getvalue())
    assert outs[1] == outs[0]
    assert "crib totals" in outs[1] and "[cribBuild: 2 haplotype(s)]" in \
        errs[1]
    purity = float(outs[1].rsplit("purity ", 1)[1].split()[0])
    assert purity > 0.85, f"phasing purity {purity}"
    with pytest.raises(SystemExit, match="requires --cribBuild"):
        main(["--device", "cpu", "-k", "17", "-w", "7", "-B", "14",
              "--readFQB", lane + ".npz", "--cribReport"],
             out=io.StringIO(), err=io.StringIO())
