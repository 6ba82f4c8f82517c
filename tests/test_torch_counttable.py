"""The count-table path between the sketch and the clustering, port against
the JAX package: ``prune``/``prune_rescue``/``merge_counts``, checkpoints
(``Engine.save``/``load`` in both directions between the packages), the
CLI's new flags against ``python -m hash10x_tpu``, and the config-#1
occurrence table against the C stand-in ``native/c_ref``.

Every comparison is exact (tolerance: none).  CLI text may differ only in
the number after ``table slots``: each package grows its count table on its
own schedule."""

import io
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import hash10x_tpu.table.sorted_table as JST
from hash10x_tpu.cli.main import main as jax_main
from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.sim import SimConfig, simulate
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.cli import main as cli
from hash10x_tpu_torch.core.encode import pack_2bit
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io import fqb as FB
from hash10x_tpu_torch.io.fastq import ReadBatch
from hash10x_tpu_torch.table import sorted_table as st

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SLOTS = re.compile(r"^table slots \d+ ", re.M)
PARAMS = ["-B", "14", "-k", "21", "-w", "7", "-r", "17", "--minCount", "2",
          "--maxCount", "64", "--friendShare", "4"]


# -- table operations ------------------------------------------------------------

def _tables(rng, n=3000):
    """The same (hash, count) table in both packages; the JAX one is built
    anew by each call of the returned function (its operations donate)."""
    h = rng.choice(1 << 40, size=n, replace=False).astype(np.uint64)
    c = rng.integers(1, 6, size=n).astype(np.uint32)
    return (lambda: JST.merge_counts(JST.make_sorted_table(1 << 13, 1 << 10),
                                     h, c),
            convert.table_from_numpy(h, c, "cpu"), h, c)


def _same(jt, t):
    jh, jc = JST.compact(JST.flush(jt))
    th, tc = st.compact(t)
    return (th.numpy() == jh.astype(np.int64)).all() \
        and (tc.numpy() == jc).all()


def test_prune_matches_jax(rng):
    jt, t, _, _ = _tables(rng)
    for lo in (1, 2, 4, 9):
        assert _same(JST.prune(jt(), lo), st.prune(t, lo))
    assert st.prune(t, 9).n_filled == 0


def test_prune_rescue_matches_jax(rng):
    jt, t, h, _ = _tables(rng)
    occ_h = np.sort(rng.choice(h, size=1200, replace=False))
    occ_c = rng.integers(1, 5, size=1200).astype(np.uint32)
    jr, jn = JST.prune_rescue(jt(), occ_h, occ_c, 2, 3)
    tr, tn = st.prune_rescue(t, convert.keys_from_numpy(occ_h, "cpu"),
                             torch.from_numpy(occ_c.astype(np.int32)), 2, 3)
    assert tn == jn > 0 and _same(jr, tr)
    empty = torch.zeros(0, dtype=torch.int64)
    tr, tn = st.prune_rescue(t, empty, empty.to(torch.int32), 2, 3)
    assert tn == 0 and _same(JST.prune(jt(), 3), tr)


def test_merge_counts_matches_jax_and_keeps_buffer(rng):
    jt, t, h, _ = _tables(rng)
    oh = np.concatenate([h[:500], rng.choice(1 << 40, size=700)
                         .astype(np.uint64)])
    ow = rng.integers(1, 4, size=len(oh)).astype(np.uint32)
    t = st.append(st.grow_buf(t, 16), torch.tensor([5, 7, 7]))
    buf = t.buf
    merged = st.merge_counts(t, convert.keys_from_numpy(oh, "cpu"),
                             torch.from_numpy(ow.astype(np.int32)))
    assert merged.buf is buf and merged.buf_n == 0
    jm = JST.merge_counts(JST.append(jt(), np.array([5, 7, 7], np.uint64)),
                          oh, ow)
    assert _same(jm, merged)
    assert merged.n_filled <= 0.6 * merged.capacity


# -- checkpoints --------------------------------------------------------------------

def _sim(**kw):
    reads = simulate(SimConfig(**kw)).reads
    return (JFB.from_read_batch(reads),
            FB.from_read_batch(ReadBatch(reads.codes, reads.lengths,
                                         reads.barcodes)))


def _full(eng, lane):
    eng.count(lane)
    eng.filter()
    eng.incidence(lane)
    eng.cluster()
    eng.split()
    return eng


def _report(eng):
    buf = io.StringIO()
    eng.report(buf)
    eng.write_counts(buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One lane through the full pipeline in both packages, each saved."""
    tmp = tmp_path_factory.mktemp("ckpt")
    jfqb, fqb = _sim(genome_len=40_000, n_barcodes=5, molecules_per_barcode=2,
                     reads_per_molecule=60, seed=3)
    kw = dict(batch_reads=1024, min_count=2, max_count=200, table_bits=12)
    jeng = _full(JEngine(JConfig(spec=JHashSpec(k=13, w=7), **kw), log=None),
                 jfqb)
    eng = _full(Engine(EngineConfig(spec=HashSpec(k=13, w=7), **kw), "cpu",
                       log=None), fqb)
    jeng.save(tmp / "jax.hash.npz")
    eng.save(tmp / "port.hash")  # np.savez adds .npz
    return dict(tmp=tmp, jeng=jeng, eng=eng, kw=kw)


def _check_state(jeng, eng):
    """Port state == JAX state: table, band, incidence, labels, split."""
    assert _report(eng) == _report(jeng)
    assert eng.n_reads_counted == jeng.n_reads_counted
    assert (eng.retained_hashes.numpy()
            == np.asarray(jeng.retained_hashes).astype(np.int64)).all()
    assert (eng.retained_counts.numpy() == jeng.retained_counts).all()
    for a, b in ((eng.inc, jeng.inc), (eng.split_inc, jeng.split_inc)):
        assert (a.n_kmers, a.n_codes) == (b.n_kmers, b.n_codes)
        for f in ("code_offsets", "code_kmers", "kmer_offsets",
                  "kmer_codes"):
            assert (getattr(a, f).numpy() == getattr(b, f)).all(), f
    assert (eng.cluster_labels.numpy() == jeng.cluster_labels).all()
    assert (eng.split_origin.numpy() == jeng.split_origin).all()


def test_states_agree_before_saving(saved):
    _check_state(saved["jeng"], saved["eng"])


def test_port_loads_jax_checkpoint(saved):
    eng = Engine(EngineConfig(spec=HashSpec(k=13, w=7), **saved["kw"]),
                 "cpu", log=None)
    eng.load(saved["tmp"] / "jax.hash.npz")
    assert eng.inc.inv2fwd is None
    _check_state(saved["jeng"], eng)
    eng.cluster()  # re-clustering the loaded incidence rebuilds inv2fwd
    assert (eng.cluster_labels.numpy() == saved["jeng"].cluster_labels).all()


def test_jax_loads_port_checkpoint(saved):
    jeng = JEngine(JConfig(spec=JHashSpec(k=13, w=7), **saved["kw"]),
                   log=None)
    jeng.load(saved["tmp"] / "port.hash")
    _check_state(jeng, saved["eng"])
    z = np.load(saved["tmp"] / "port.hash.npz")
    j = np.load(saved["tmp"] / "jax.hash.npz")
    assert sorted(z.files) == sorted(j.files)
    for f in z.files:
        assert z[f].dtype == j[f].dtype, f
    assert bytes(z["meta"]) == bytes(j["meta"])


def test_load_replaces_state_and_checks_spec(saved):
    jfqb, fqb = _sim(genome_len=30_000, n_barcodes=3, molecules_per_barcode=2,
                     reads_per_molecule=40, seed=5)
    eng = Engine(EngineConfig(spec=HashSpec(k=13, w=7), **saved["kw"]),
                 "cpu", log=None)
    eng.count(fqb)
    eng.count(fqb)
    eng.load(saved["tmp"] / "port.hash.npz")
    _check_state(saved["jeng"], eng)
    other = Engine(EngineConfig(spec=HashSpec(k=13, w=9)), "cpu", log=None)
    with pytest.raises(ValueError, match="spec"):
        other.load(saved["tmp"] / "jax.hash.npz")


def test_save_range_checks():
    with pytest.raises(ValueError, match="int32"):
        convert.to_numpy(torch.tensor([1 << 31]), np.int32, "labels")
    assert convert.keys_to_numpy(torch.tensor([3, (1 << 63) - 1])).tolist() \
        == [3]


# -- CLI against the JAX CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """A 1,200-read molecule lane with one oversized barcode (300 reads)."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(1)
    n, L = 1200, 110
    genome = rng.integers(0, 4, size=300_000).astype(np.uint8)
    bc = np.concatenate([np.zeros(300, np.int32),
                         1 + np.repeat(np.arange(30, dtype=np.int32), 30)])
    mol = rng.integers(0, len(genome) - 8000, size=31)
    starts = mol[bc] + rng.integers(0, 8000 - L, size=n)
    reads = genome[starts[:, None] + np.arange(L)]
    path = str(tmp / "lane.fqb")
    FB.save_fqb(path, FB.Fqb(packed=pack_2bit(reads),
                             lengths=np.full(n, L, np.int32), barcode_ids=bc,
                             barcode_keys=np.arange(31, dtype=np.uint32),
                             read_len=L))
    return tmp, path


def _both(tmp, args):
    """stdout and the files named '@x' of both CLIs, 'table slots' masked."""
    outs = []
    for tag, fn, pre in (("jax", jax_main, []),
                         ("port", cli.main, ["--device", "cpu"])):
        argv = [a.replace("@", str(tmp / f"{tag}_")) for a in args]
        out = io.StringIO()
        assert fn(pre + argv, out=out, err=io.StringIO()) == 0
        dumps = [argv[i + 1] for i, a in enumerate(argv)
                 if a in ("--writeCounts", "--writeClusters")]
        outs.append([SLOTS.sub("table slots N ", out.getvalue())]
                    + [open(p).read() for p in dumps])
    return outs


@pytest.mark.parametrize("name,flags", [
    ("syncmer", ["--syncmer", "11"]),
    ("modimizer", ["--modimizer"]),
    ("allKmers", ["--allKmers", "-t", "4"]),
    ("occurrences", ["--countMode", "occurrences"]),
    ("errorFix", ["--errorFixReads", "2"]),
    ("w100", ["-w", "100"])])
def test_cli_modes_match_jax_cli(lane, name, flags):
    tmp, path = lane
    params = PARAMS + flags if name != "w100" else ["-B", "14"] + flags
    fix = ["--errorFix", "1"] if name == "errorFix" else []
    jo, to = _both(tmp, params + ["--batchReads", "256", "--readFQB", path]
                   + fix + ["--hashInfo", "--hashDist", "--codeClusters",
                            "--clusterSplit", "--clusterReport",
                            "--writeCounts", f"@{name}.counts",
                            "--writeClusters", f"@{name}.clusters"])
    assert to == jo
    assert "code 30 nKmers" in to[0] and to[1].count("\n") > 100


def test_cli_checkpoint_resume_matches_jax_cli(lane):
    """--writeHash then --readHash in a fresh CLI: the report after the load
    is byte-identical to the one before, in both packages, and each package
    resumes from the other's file."""
    tmp, path = lane
    first = _both(tmp, PARAMS + ["--errorFixReads", "2", "--readFQB", path,
                                 "--errorFix", "1", "--codeClusters",
                                 "--clusterReport", "--writeHash", "@ck"])
    assert first[0] == first[1]
    for src in ("jax", "port"):
        ck = str(tmp / f"{src}_ck")
        for fn, pre in ((jax_main, []), (cli.main, ["--device", "cpu"])):
            out = io.StringIO()
            fn(pre + PARAMS + ["--readHash", ck, "--clusterReport"], out=out,
               err=io.StringIO())
            assert out.getvalue() == first[1][0]
        out = io.StringIO()
        cli.main(["--device", "cpu"] + PARAMS + ["--readHash", ck,
                  "--codeClusters", "--clusterReport"], out=out,
                 err=io.StringIO())
        assert out.getvalue() == first[1][0]


def test_cli_write_fqb_round_trip(lane):
    tmp, path = lane
    copy = str(tmp / "copy.fqb")
    cli.run(["--device", "cpu", "--readFQB", path, "--writeFQB", copy],
            io.StringIO(), io.StringIO())
    a, b = FB.load_fqb(path), FB.load_fqb(copy)
    assert (a.packed == b.packed).all() and (a.lengths == b.lengths).all()
    assert (a.barcode_ids == b.barcode_ids).all()
    with pytest.raises(SystemExit, match="no reads loaded"):
        cli.run(["--device", "cpu", "--writeFQB", copy], io.StringIO(),
                io.StringIO())
    with pytest.raises(SystemExit, match="no reads loaded"):
        cli.run(["--device", "cpu", "--codeClusters"], io.StringIO(),
                io.StringIO())


def _jax_flags():
    """The flags of the JAX CLI's usage lines (indented lines that start
    with a dash)."""
    from hash10x_tpu.cli import main as jax_cli
    lines = [ln for ln in jax_cli.__doc__.splitlines()
             if ln[:1] == " " and ln.lstrip().startswith("-")]
    return sorted({f for ln in lines for f in re.findall(
        r"(?<![\w-])(--?[A-Za-z][A-Za-z0-9]*)", ln)})


def test_every_jax_flag_is_accepted(tmp_path):
    """Every flag of the JAX CLI's usage text is in the port's and runs
    there: it may fail on its dummy input, never as an unknown argument."""
    flags = _jax_flags()
    assert len(flags) > 40 and "--readFQBShard" in flags
    dummy = {"--countMode": ["barcodes"], "--clusterMode": ["friend"],
             "--coordinator": ["127.0.0.1:1"], "--hosts": ["2"],
             "--simulate": ["genome_len=5000,n_barcodes=2,molecule_len=1000,"
                            "reads_per_molecule=4,read_len=60"],
             "--readFastqPair": [str(tmp_path / "r1"), str(tmp_path / "r2")]}
    paths = {"--readFastq", "--readFQB", "--readFQBShard", "--writeFQB",
             "--writeHash", "--readHash", "--writeCounts", "--writeClusters",
             "--metrics", "--profile", "--cribBuild"}
    no_arg = {"--minimizer", "--modimizer", "--allKmers", "--devMem",
              "--hashInfo", "--hashDist", "--cluster", "--codeClusters",
              "--clusterSplit", "--clusterReport", "--cribReport"}
    for flag in flags:
        assert flag in cli.__doc__, flag
        if flag in ("--help", "-h"):
            out = io.StringIO()
            assert cli.main([flag], out=out) == 0 and "--shards" in \
                out.getvalue()
            continue
        args = dummy.get(flag) or ([str(tmp_path / flag.strip("-"))]
                                   if flag in paths else
                                   [] if flag in no_arg else ["2"])
        try:
            cli.run(["--device", "cpu", flag, *args], io.StringIO(),
                    io.StringIO())
        except SystemExit as e:
            assert "unknown argument" not in str(e), flag
        except (OSError, ValueError, RuntimeError):
            pass   # the command ran and refused its dummy input


# -- config #1 against the C stand-in ------------------------------------------------

def test_occurrence_table_matches_c_ref(tmp_path):
    """BASELINE config #1 in small: a pure occurrence count of reads all
    under barcode 0 (an oversized barcode at this batch size) equals
    native/c_ref run without --barcodes (tests/test_c_ref.py:111)."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=50_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - 100, size=2000)
    reads = genome[starts[:, None] + np.arange(100)]
    exe = str(tmp_path / "hash10x_ref")
    subprocess.run(["gcc", "-O2", "-o", exe,
                    os.path.join(ROOT, "native", "c_ref", "hash10x_ref.c")],
                   check=True, capture_output=True)
    rb, dump = tmp_path / "reads.bin", str(tmp_path / "counts.bin")
    with open(rb, "wb") as f:
        np.array(reads.shape, np.uint32).tofile(f)
        reads.tofile(f)
    subprocess.run([exe, str(rb), "21", "11", "17", "20", "--dump", dump],
                   check=True, capture_output=True)
    with open(dump, "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        c_hashes = np.fromfile(f, np.uint64, m)
        c_counts = np.fromfile(f, np.uint32, m)
    fqb = FB.Fqb(packed=pack_2bit(reads), lengths=np.full(2000, 100, np.int32),
                 barcode_ids=np.zeros(2000, np.int32),
                 barcode_keys=np.zeros(1, np.uint32), read_len=100)
    eng = Engine(EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                              count_mode="occurrences", batch_reads=512),
                 "cpu", log=None)
    eng.count(fqb)
    h, c = st.compact(eng._flushed())
    assert (convert.keys_to_numpy(h) == c_hashes).all()
    assert (c.numpy().astype(np.uint32) == c_counts).all()
    assert c.sum() > 2000 and eng.n_reads_counted == 2000
