"""The paths off the main path, as they run on a lane of 16M reads and 1M
barcodes, held at small size against the JAX package and the port's
earlier forms:

* Capped-friend clustering (``--maxFriends``) takes each barcode's friends
  from the sparse co-occurrence counts (``cooccur.friends_table``), not
  from a dense (rows, n_codes) share row per barcode (O(n_codes^2): 10^12
  cells at 1M barcodes).  Labels equal the JAX ``cluster_codes`` and the
  friend rows equal the dense ``_friends`` rows, at friend shares 0 (where
  the dense rows fill up with codes that share nothing, the barcode itself
  included), 1 and 8, with ties in share.
* ``crib_report`` runs on the incidence's device and renders through
  ``utils/text.py``; the purity column's exact ties (d/ht = 9/16, 13/16,
  201/400) follow Python's rounding of the double.
* ``fasta_records`` reads blocks, not lines: the records equal the line
  reader's at every line width, with empty lines, headers with spaces and
  gzip.
* The blocked lane generator's diploid form (``het_rate``): at 0 the
  lane's bytes are the haploid lane's; above 0 a read differs from the
  haploid lane only at SNP sites of the second haplotype, and every read
  of a molecule comes from one haplotype.

Every comparison is exact (tolerance: none; all values are integers or
text)."""

import gzip
import hashlib
import io

import numpy as np
import pytest
import torch

from hash10x_tpu.cluster import cooccur as J
from hash10x_tpu.crib import crib as JCRIB
from hash10x_tpu.table.incidence import build_incidence
from hash10x_tpu_torch import bench as B
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.cluster import cooccur as C
from hash10x_tpu_torch.core.encode import unpack_2bit_torch
from hash10x_tpu_torch.crib import crib as CRIB
from hash10x_tpu_torch.io import fastq

torch.set_num_threads(2)


# -- capped-friend clustering -------------------------------------------------

def tied_incidence(seed):
    """40 codes over 63 k-mers in blocks: the codes of a block hold its
    k-mers with the same probability, so many share counts tie; code 37
    holds three k-mers no other code holds (a row of zero shares) and
    codes 36, 38 and 39 hold none."""
    rng = np.random.default_rng(seed)
    pairs = np.zeros((63, 40), bool)
    for blk in range(5):
        ks = slice(12 * blk, 12 * blk + 12)
        cs = slice(7 * blk, 7 * blk + 7)
        pairs[ks, cs] = rng.random((12, 7)) < 0.5
        pairs[ks, cs][:4] = True          # four k-mers every code holds
    pairs[:, 36:] = False
    pairs[60:, 37] = True
    k, c = np.nonzero(pairs)
    return build_incidence(k.astype(np.int32), c.astype(np.int32), 63, 40)


def dense_rows(inc, thr, max_friends):
    """``_friends`` rows for every code, from its k-mers' lists."""
    tinc = convert.incidence_from_numpy(inc, "cpu")
    K = int(np.diff(inc.code_offsets).max())
    C_ = int(np.diff(inc.kmer_offsets).max())
    rows = []
    for c in range(inc.n_codes):
        ks = inc.kmers_of(c)
        cl = torch.full((1, K, C_), -1, dtype=torch.int64)
        for i, k in enumerate(ks):
            lst = inc.codes_of(k)
            cl[0, i, :len(lst)] = torch.from_numpy(lst.astype(np.int64))
        rows.append(C._friends(cl, torch.tensor([c]), tinc.n_codes, thr,
                               max_friends))
    return torch.cat(rows)


@pytest.mark.parametrize("max_friends", [1, 3, 256])
@pytest.mark.parametrize("thr", [0, 1, 8])
def test_capped_friend_labels_match_jax(thr, max_friends):
    inc = tied_incidence(1)
    got = C.cluster_codes(convert.incidence_from_numpy(inc, "cpu"),
                          mode="friend", min_friend_share=thr,
                          max_friends=max_friends).numpy()
    want = np.asarray(J.cluster_codes(inc, mode="friend", flat=True,
                                      min_friend_share=thr,
                                      max_friends=max_friends))
    assert got.tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("max_friends", [1, 3, 256])
@pytest.mark.parametrize("thr", [0, 1, 8])
def test_friends_table_equals_dense_rows(thr, max_friends):
    inc = tied_incidence(2)
    tinc = convert.incidence_from_numpy(inc, "cpu")
    table = C.friends_table(tinc, thr, max_friends, pad=True)
    assert torch.equal(table, dense_rows(inc, thr, max_friends))
    narrow = C.friends_table(tinc, thr, max_friends)
    assert torch.equal(narrow, table[:, :narrow.shape[1]])
    assert (table[:, narrow.shape[1]:] == -1).all()
    if thr == 0:   # zero-share codes fill the rows, the code itself too
        assert narrow.shape[1] == min(max_friends, inc.n_codes)
        assert table[37, 0] == 0 and (37 in table[37].tolist()) == \
            (max_friends > 37)


def test_friends_table_fill_in_blocks(monkeypatch):
    """The zero-share fill gives the same rows one code per block."""
    inc = convert.incidence_from_numpy(tied_incidence(3), "cpu")
    whole = C.friends_table(inc, 0, 5)
    monkeypatch.setattr(C, "_FILL_CELLS", 1)
    assert torch.equal(C.friends_table(inc, 0, 5), whole)


# -- crib report --------------------------------------------------------------

def crib_lane():
    """Eight codes, one or two clusters each, with chosen HET1/HET2 counts
    (purity 9/16, 13/16 and 201/400 are exact ties at three decimals, 5/8
    and 1/2 exact values, one cluster has no HET k-mer), over three
    records; k-mers of every label, some without a position."""
    rng = np.random.default_rng(5)
    het = [(9, 7), (13, 3), (5, 3), (201, 199), (1, 1), (0, 0), (3, 13),
           (10, 30), (2, 6), (7, 9)]
    clusters = [(0, 0), (0, 1), (1, 0), (2, 0), (3, 0), (3, 1), (4, 0),
                (5, 0), (6, 0), (7, 0)]
    ks, cs, labs, lab_of_k = [], [], [], []
    for (code, cl), (a, b) in zip(clusters, het):
        n_other = int(rng.integers(1, 12))
        kl = ([CRIB.HET1] * a + [CRIB.HET2] * b
              + list(rng.choice([CRIB.HOM, CRIB.MUL, CRIB.ERR], n_other)))
        for lab in kl:
            ks.append(len(lab_of_k))
            cs.append(code)
            labs.append(cl)
            lab_of_k.append(lab)
    n_k = len(lab_of_k)
    rec_starts = np.array([0, 5_000, 12_000], np.int64)
    positions = rng.integers(0, 20_000, n_k).astype(np.int64)
    positions[rng.random(n_k) < 0.1] = -1
    crib = dict(labels=np.array(lab_of_k, np.uint8),
                hap_counts=np.ones((2, n_k), np.uint32), n_haps=2,
                positions=positions, rec_starts=rec_starts,
                rec_names=["chr1", "chr2_random", "chrX"])
    order = np.lexsort((ks, cs))
    inc = build_incidence(np.array(ks, np.int32), np.array(cs, np.int32),
                          n_k, 8)
    # labels aligned with the forward CSR (code-major, k-mer ascending)
    labels = np.array(labs, np.int64)[order]
    return inc, labels, crib


def test_crib_report_matches_jax_with_purity_ties():
    inc, labels, fields = crib_lane()
    want, got = io.StringIO(), io.StringIO()
    JCRIB.crib_report(inc, labels, JCRIB.Crib(**fields), want)
    n = CRIB.crib_report(convert.incidence_from_numpy(inc, "cpu"),
                         torch.from_numpy(labels), CRIB.Crib(**fields), got)
    assert got.getvalue() == want.getvalue()
    text = got.getvalue()
    assert n == 10 and text.count("\n") == 12
    # Python rounds the double half to even at the tie: 0.5625 -> 0.562
    assert "het1 9 het2 7 mul" in text and " purity 0.562 " in text
    assert " purity 0.812 " in text and " purity 0.625 " in text
    assert " purity - " in text and " chrom chr2_random " in text


@pytest.mark.parametrize("d,ht,want", [
    (9, 16, "0.562"), (13, 16, "0.812"), (201, 400, "0.502"),
    (5, 8, "0.625"), (1, 2, "0.500"), (2, 3, "0.667"), (1, 1, "1.000"),
    (0, 0, "-")])
def test_purity_column_is_the_fstring(d, ht, want):
    r = CRIB._purity_thousandths(torch.tensor([d]), torch.tensor([ht]))
    buf = io.StringIO()
    from hash10x_tpu_torch.utils.text import write_rows
    write_rows(buf, [("f3", r), b"\n"], 1, "cpu")
    assert buf.getvalue() == want + "\n"
    if ht:
        assert want == f"{d / ht:.3f}"


# -- FASTA reader -------------------------------------------------------------

def line_records(path):
    """The line-at-a-time reader ``fasta_records`` replaced."""
    name, chunks = None, []
    with fastq._open(path) as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].split(b" ")[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("width", [1, 60, 61, 0])
def test_fasta_records_match_the_line_reader(tmp_path, width, gz):
    rng = np.random.default_rng(width + gz)
    parts = [b"stray text before any header\n"]
    for r in range(4):
        parts.append(b">rec%d assembled from pieces\n" % r if r != 2
                     else b"> spaced name\n")
        seq = bytes(rng.choice(list(b"ACGTN"), int(rng.integers(0, 500))))
        w = width or max(len(seq), 1)
        lines = [seq[i:i + w] for i in range(0, len(seq), w)]
        lines.insert(len(lines) // 2, b"")          # an empty line
        parts.append(b"\n".join(lines) + b"\n")
    parts.append(b">last_without_newline\nACGT")
    data = b"".join(parts)
    path = tmp_path / ("g.fa.gz" if gz else "g.fa")
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(data)
    want = list(line_records(path))
    assert len(want) == 5 and want[2][0] == b""
    for block in (1, 7, 64, 1 << 26):
        assert list(fastq.fasta_records(path, block)) == want


def test_fasta_writer_round_trip(tmp_path):
    """``bench.write_fasta_records`` (the diploid lane's haplotypes as
    chromosome records) read back through ``fasta_records``."""
    genome = np.random.default_rng(4).integers(0, 4, 10_007).astype(np.uint8)
    path = tmp_path / "h.fa"
    B.write_fasta_records(path, genome, 3, width=61)
    recs = list(fastq.fasta_records(path, 100))
    assert [n for n, _ in recs] == [b"chr1", b"chr2", b"chr3"]
    assert [len(q) for _, q in recs] == [3335, 3335, 3337]
    back = b"".join(q for _, q in recs)
    assert back == np.frombuffer(b"ACGT", np.uint8)[genome].tobytes()
    assert max(len(x) for x in path.read_bytes().split(b"\n")) == 61


# -- the blocked generator's diploid lane -------------------------------------

READS, CODES, GENOME = 256 * 16, 256, 40_000_000


def test_het_rate_zero_keeps_the_lane_bytes():
    """The haploid lane's sha256 at this size, as the generator made it
    before it took ``het_rate``."""
    fqb = B.make_barcodes_lane_blocked(READS, CODES, GENOME, chunk=1000,
                                       het_rate=0.0)
    h = hashlib.sha256()
    for a in (fqb.packed, fqb.lengths, fqb.barcode_ids, fqb.barcode_keys):
        h.update(a.tobytes())
    assert h.hexdigest() == ("e8660c2c809945ff01b2440613aca0372a6a26293181"
                             "238f9e03c186333ee11f")


def test_het_rate_changes_only_snp_sites():
    hap = B.make_barcodes_lane_blocked(READS, CODES, GENOME, chunk=1000)
    dip, (g0, g1) = B.make_barcodes_lane_blocked(
        READS, CODES, GENOME, chunk=777, het_rate=0.01,
        return_haplotypes=True)
    snp = np.flatnonzero(g0 != g1)
    assert 0.009 < len(snp) / GENOME < 0.011
    assert np.array_equal(g0, B.blocked_genome(GENOME))
    assert np.array_equal(dip.barcode_ids, hap.barcode_ids)

    def bases(fqb):
        return unpack_2bit_torch(torch.from_numpy(fqb.packed.view(np.int32)),
                                 150).numpy()
    a, b = bases(hap), bases(dip)
    # the generator's starts, from its documented streams
    rng = np.random.default_rng([11, 0])
    mol = rng.integers(0, GENOME - B.MOLECULE, size=CODES)
    offs = rng.integers(0, B.MOLECULE - 150, size=READS, dtype=np.int32)
    pos = (mol[hap.barcode_ids] + offs)[:, None] + np.arange(150)
    assert np.array_equal(a, g0[pos])
    on2 = np.array([np.array_equal(b[i], g1[pos[i]]) and not
                    np.array_equal(b[i], g0[pos[i]]) for i in range(READS)])
    assert np.array_equal(b[~on2], g0[pos[~on2]])
    diff = a != b
    assert diff.any() and (g0[pos[diff]] != g1[pos[diff]]).all()
    # a molecule's reads come from one haplotype (reads without a SNP
    # match both: they may sit on either side)
    has_snp = (g0[pos] != g1[pos]).any(1)
    per_code = {}
    for i in np.flatnonzero(has_snp):
        per_code.setdefault(int(dip.barcode_ids[i]), set()).add(bool(on2[i]))
    assert all(len(v) == 1 for v in per_code.values())
    assert {True, False} <= set().union(*per_code.values())
