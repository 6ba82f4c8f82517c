"""The sharded and multi-process CLI: ``python -m hash10x_tpu_torch --device
cpu --shards 4`` against ``python -m hash10x_tpu --shards 4`` on the
tests/test_cli.py lane (stdout, --hashDist, --writeCounts, --writeClusters
byte for byte; the number after ``table slots`` differs by design: each
package sizes its shards on its own schedule), --laneCapacity and
--labelBlocks, the errors, and two processes joined over gloo on the CPU
(the whole lane in each, and barcode-disjoint shard files).  Each process
of a multi-process run has a timeout of its own."""

import io
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hash10x_tpu.cli.main import main as jax_main
from hash10x_tpu_torch.cli.main import main, run
from hash10x_tpu_torch.core.encode import pack_2bit
from hash10x_tpu_torch.io.fqb import Fqb, load_fqb, save_fqb

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SLOTS = re.compile(r"^table slots \d+ ", re.M)
SIM = ("genome_len=200000,n_barcodes=150,molecules_per_barcode=2,"
       "molecule_len=4000,reads_per_molecule=30,read_len=120,seed=3")
PARAMS = ["-k", "17", "-w", "7", "-r", "11", "-B", "14", "--friendShare",
          "20", "--batchReads", "1024"]
TIMEOUT = 120   # seconds per process of a multi-process run


def _cmds(tmp, tag):
    return ["--simulate", SIM, "--hashInfo", "--hashDist", "--codeClusters",
            "--clusterSplit", "--clusterReport",
            "--writeCounts", str(tmp / f"{tag}.counts"),
            "--writeClusters", str(tmp / f"{tag}.clusters")]


def _texts(out, tmp, tag):
    files = [(tmp / f"{tag}.{x}").read_text() for x in ("counts", "clusters")]
    return [SLOTS.sub("table slots N ", out)] + files


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    out = io.StringIO()
    assert jax_main(PARAMS + ["--shards", "4"] + _cmds(tmp, "jax"), out=out,
                    err=io.StringIO()) == 0
    return tmp, _texts(out.getvalue(), tmp, "jax")


def port_cli(tmp, tag, *flags):
    out, err = io.StringIO(), io.StringIO()
    eng = run(["--device", "cpu"] + PARAMS + list(flags) + _cmds(tmp, tag),
              out, err)
    return _texts(out.getvalue(), tmp, tag), err.getvalue(), eng


def test_shards4_matches_jax_cli(jax4):
    tmp, want = jax4
    got, err, _ = port_cli(tmp, "port4", "--shards", "4")
    assert got == want
    assert "code 149 nKmers" in got[0] and got[1].count("\n") > 1000
    assert "\n2\t" in got[0]          # the --hashDist lines
    assert "[count[sharded x4]:" in err and "[incidence[sharded x4]:" in err


def test_lane_capacity_and_label_blocks_keep_output(jax4):
    tmp, want = jax4
    got, err, eng = port_cli(tmp, "lanes", "--shards", "4",
                             "--laneCapacity", "512")
    assert got == want
    assert "lane overflow" in err and "--laneCapacity 1024" in err
    assert eng.cfg.lane_capacity > 512          # the grown size stays
    got, _, eng = port_cli(tmp, "blocks", "--shards", "4", "--labelBlocks",
                           "500")
    assert got == want and eng.cfg.cluster_label_blocks == 500


@pytest.mark.parametrize("flags,match", [
    (["--shards", "3"], "power of two"),
    (["--shards", "8", "--batchReads", "1002"], "divisible by n_shards")])
def test_bad_shard_flags_raise(tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        run(["--device", "cpu"] + PARAMS + flags + _cmds(tmp_path, "bad"),
            io.StringIO(), io.StringIO())


def test_hosts_without_coordinator_raises():
    with pytest.raises(ValueError, match="coordinator"):
        run(["--device", "cpu", "--hosts", "2", "--hostId", "1"],
            io.StringIO(), io.StringIO())


# -- two processes over gloo on the CPU ---------------------------------------

MH_PARAMS = ["--device", "cpu", "-k", "13", "-w", "5", "-r", "17",
             "--batchReads", "128", "--minCount", "2", "--maxCount", "60",
             "--friendShare", "2"]
MH_TAIL = ["--hashDist", "--codeClusters", "--clusterReport"]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mh_lane(tmp_path_factory):
    """tests/test_multihost_cli.py's lane (512 reads, 32 barcodes), its
    barcode-disjoint halves (key parity, local ids) and overlapping
    halves."""
    tmp = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, size=50_000).astype(np.uint8)
    N, n_codes = 512, 32
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), N // n_codes)
    starts = rng.integers(0, len(genome) - 100, size=N)
    reads = np.stack([genome[s:s + 100] for s in starts])
    lane = str(tmp / "lane.fqb")
    save_fqb(lane, Fqb(packed=pack_2bit(reads),
                       lengths=np.full(N, 100, np.int32), barcode_ids=bc,
                       barcode_keys=np.arange(n_codes, dtype=np.uint32),
                       read_len=100))
    fqb = load_fqb(lane)
    for pid in range(2):
        for tag, keep in (("half", lambda k: k % 2 == pid),
                          ("over", lambda k: (k % 2 == pid) | (k < 4))):
            sel = np.isin(fqb.barcode_ids, np.nonzero(
                keep(fqb.barcode_keys.astype(np.int64)))[0])
            keys = np.unique(fqb.barcode_keys[fqb.barcode_ids[sel]])
            ids = np.searchsorted(keys, fqb.barcode_keys[fqb.barcode_ids[sel]])
            save_fqb(str(tmp / f"{tag}{pid}.fqb"), Fqb(
                packed=fqb.packed[sel], lengths=fqb.lengths[sel],
                barcode_ids=ids.astype(np.int32), barcode_keys=keys,
                read_len=fqb.read_len))
    out = io.StringIO()
    run(MH_PARAMS + ["--shards", "2", "--readFQB", lane] + MH_TAIL
        + ["--writeCounts", str(tmp / "single.counts")], out, io.StringIO())
    return tmp, lane, out.getvalue()


def spawn_two(args, env_vars=False):
    """Two CLI processes; with ``env_vars`` the process group comes from
    the H10X_* variables instead of the flags."""
    port = free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT)
        group = ["--hosts", "2", "--hostId", str(pid), "--coordinator",
                 f"127.0.0.1:{port}"]
        if env_vars:
            env.update(H10X_NUM_PROCESSES="2", H10X_PROCESS_ID=str(pid),
                       H10X_COORDINATOR=f"127.0.0.1:{port}")
            group = []
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hash10x_tpu_torch"] + group + args,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    res = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            res.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


@pytest.mark.parametrize("source,env_vars", [("full", False), ("half", True)])
def test_two_processes_match_single(mh_lane, source, env_vars):
    """Mirror of test_multihost_cli.py: the coordinator's stdout and
    --writeCounts equal the single-process --shards 2 run; process 1
    writes nothing."""
    tmp, lane, want = mh_lane
    counts = tmp / f"two_{source}.counts"
    src = (["--readFQB", lane] if source == "full" else
           ["--readFQBShard", str(tmp / "half{host}.fqb")])
    res = spawn_two(MH_PARAMS + src + MH_TAIL
                    + ["--writeCounts", str(counts)], env_vars=env_vars)
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
        assert "over 2 gloo processes" in err
    assert res[0][1] == want and "code 31 nKmers" in want
    assert res[1][1] == ""
    assert counts.read_text() == (tmp / "single.counts").read_text()


@pytest.fixture(scope="module")
def big_barcode_lane(tmp_path_factory):
    """tests/test_multihost_cli.py's oversized lane: barcode 0 holds 200
    reads (> the 64-row block of each process at --batchReads 128), seven
    more barcodes 16 each; as one file and as barcode-disjoint halves (the
    big barcode in half 0).  The single-device plain run's counts."""
    tmp = tmp_path_factory.mktemp("mh_big")
    rng = np.random.default_rng(33)
    genome = rng.integers(0, 4, size=30_000).astype(np.uint8)
    bc = np.concatenate([np.zeros(200, np.int32),
                         1 + np.repeat(np.arange(7, dtype=np.int32), 16)])
    starts = rng.integers(0, len(genome) - 100, size=len(bc))
    reads = np.stack([genome[s:s + 100] for s in starts])
    keys = np.arange(8, dtype=np.uint32)
    lane = str(tmp / "lane.fqb")
    save_fqb(lane, Fqb(packed=pack_2bit(reads),
                       lengths=np.full(len(bc), 100, np.int32),
                       barcode_ids=bc, barcode_keys=keys, read_len=100))
    for pid in range(2):
        sel = bc % 2 == pid
        k = np.unique(keys[bc[sel]])
        save_fqb(str(tmp / f"half{pid}.fqb"), Fqb(
            packed=pack_2bit(reads[sel]),
            lengths=np.full(int(sel.sum()), 100, np.int32),
            barcode_ids=np.searchsorted(k, bc[sel]).astype(np.int32),
            barcode_keys=k, read_len=100))
    run(BIG_PARAMS + ["--readFQB", lane, "--writeCounts",
                      str(tmp / "plain.counts")], io.StringIO(),
        io.StringIO())
    return tmp, lane


BIG_PARAMS = ["--device", "cpu", "-k", "13", "-w", "5", "-r", "17",
              "--batchReads", "128", "--minCount", "1", "--maxCount", "60"]


@pytest.mark.parametrize("source", ["full", "half"])
def test_two_processes_oversized_barcode(big_barcode_lane, source):
    """Mirror of test_multihost_cli.py's oversized-barcode tests: the big
    barcode streams through the side table (in the shard-file case as
    global batches of process 0 alone); counts equal the plain run's, and
    the checkpoint process 0 writes equals a single-process one."""
    tmp, lane = big_barcode_lane
    src = (["--readFQB", lane] if source == "full" else
           ["--readFQBShard", str(tmp / "half{host}.fqb")])
    out = tmp / f"{source}"
    res = spawn_two(BIG_PARAMS + src + [
        "--hashDist", "--writeCounts", f"{out}.counts",
        "--writeHash", f"{out}.npz"])
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    assert (tmp / f"{source}.counts").read_text() == \
        (tmp / "plain.counts").read_text()
    run(BIG_PARAMS + ["--shards", "2", "--readFQB", lane, "--writeHash",
                      str(tmp / "single.npz")], io.StringIO(), io.StringIO())
    a, b = np.load(f"{out}.npz"), np.load(str(tmp / "single.npz"))
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        assert (a[f] == b[f]).all(), f


def test_overlapping_shard_files_raise(mh_lane):
    tmp, _, _ = mh_lane
    res = spawn_two(MH_PARAMS + ["--readFQBShard", str(tmp / "over{host}.fqb")]
                    + MH_TAIL)
    for rc, _, err in res:
        assert rc != 0 and "share barcodes" in err


# -- sharded cluster modes, crib and sketch modes (the lazy sharded views) ----

@pytest.fixture(scope="module")
def diploid(tmp_path_factory):
    """A small diploid lane (tests/test_torch_crib.py's kind) and its two
    haplotype FASTAs."""
    from hash10x_tpu.io.sim import SimConfig, simulate
    from hash10x_tpu_torch.core.encode import codes_to_ascii
    from hash10x_tpu_torch.io.fqb import from_read_batch
    from hash10x_tpu_torch.io.fastq import ReadBatch
    tmp = tmp_path_factory.mktemp("dist_modes")
    sim = simulate(SimConfig(genome_len=120_000, n_barcodes=48,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=30, read_len=120,
                             het_rate=0.005, seed=4))
    fas = []
    for i, g in enumerate((sim.genome, sim.genome_hap1)):
        fa = tmp / f"h{i}.fa"
        fa.write_bytes(b">hap%d\n" % i + codes_to_ascii(g) + b"\n")
        fas.append(str(fa))
    r = sim.reads
    lane = str(tmp / "lane.fqb")
    save_fqb(lane, from_read_batch(ReadBatch(r.codes, r.lengths,
                                             r.barcodes)))
    return tmp, lane, fas


CLUSTER_TAIL = ["--codeClusters", "--clusterSplit", "--clusterReport"]


@pytest.mark.parametrize("shards,flags,tail", [
    ("4", ["--clusterMode", "pair", "--minShare", "2"], CLUSTER_TAIL),
    ("4", ["--maxFriends", "8"], CLUSTER_TAIL),
    ("2", [], ["--codeClusters", "--cribBuild", "H1", "H2", "--cribReport"]),
    ("2", ["--modimizer"], CLUSTER_TAIL)],
    ids=["pair-shards4", "maxFriends8-shards4", "crib-shards2",
         "modimizer-shards2"])
def test_sharded_modes_match_jax_cli(diploid, shards, flags, tail):
    """Pair mode, capped friends and the crib gather the sharded state
    through the engine's lazy views; the modimizer runs through sharded
    clustering.  stdout and --writeClusters equal the JAX CLI's at the same
    --shards."""
    tmp, lane, fas = diploid
    tail = [{"H1": fas[0], "H2": fas[1]}.get(a, a) for a in tail]
    args = ["-k", "17", "-w", "7", "-B", "14", "--batchReads", "1024",
            "--friendShare", "8", "--shards", shards, *flags,
            "--readFQB", lane, *tail]
    texts = []
    for tag, fn, pre in (("jax", jax_main, []),
                         ("port", main, ["--device", "cpu"])):
        out = io.StringIO()
        dump = tmp / f"{tag}_{'_'.join(flags) or 'crib'}.clusters"
        assert fn(pre + args + ["--writeClusters", str(dump)], out=out,
                  err=io.StringIO()) == 0
        texts.append((SLOTS.sub("table slots N ", out.getvalue()),
                      dump.read_text()))
    assert texts[1] == texts[0]
    assert texts[1][1].count("\n") > 1000
    if "--cribReport" in tail:
        assert "crib totals" in texts[1][0]
    else:
        assert "code 47 nKmers" in texts[1][0]


def test_help_names_the_sharded_flags():
    out = io.StringIO()
    assert main(["--help"], out=out) == 0
    for flag in ("--shards", "--laneCapacity", "--labelBlocks", "--hosts",
                 "--hostId", "--coordinator", "--readFQBShard", "H10X_"):
        assert flag in out.getvalue()
