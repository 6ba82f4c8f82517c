"""The pair and capped-friend cluster modes of the port
(``hash10x_tpu_torch/cluster/cooccur.py``) against the JAX package's
``cluster_codes`` and the union-find oracle, and through the engine and the
CLI against ``python -m hash10x_tpu``.  Every comparison is exact
(tolerance: none); CLI text may differ only in the number after
``table slots``."""

import io
import re

import numpy as np
import pytest
import torch

from hash10x_tpu.cli.main import main as jax_main
from hash10x_tpu.cluster import cooccur as J
from hash10x_tpu.oracle import cluster_ref as CO
from hash10x_tpu.table.incidence import build_incidence
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.cli.main import main
from hash10x_tpu_torch.cluster import cooccur
from hash10x_tpu_torch.core.encode import pack_2bit
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import Fqb, save_fqb

torch.set_num_threads(2)

SLOTS = re.compile(r"^table slots \d+ ", re.M)


def random_incidence(rng, n_kmers=50, n_codes=24, density=0.15):
    pairs = rng.random((n_kmers, n_codes)) < density
    k, c = np.nonzero(pairs)
    return build_incidence(k.astype(np.int32), c.astype(np.int32), n_kmers,
                           n_codes)


def oracle_flat(inc, mode, share, max_friends=256):
    hash_codes = {k: inc.codes_of(k).tolist() for k in range(inc.n_kmers)}
    out = []
    for c in range(inc.n_codes):
        ks = inc.kmers_of(c).tolist()
        out += (CO.cluster_barcode(ks, hash_codes, share) if mode == "pair"
                else CO.cluster_barcode_friend(ks, hash_codes, c, share,
                                               max_friends))
    return np.array(out, np.int64)


def port_flat(inc, **kw):
    return cooccur.cluster_codes(convert.incidence_from_numpy(inc, "cpu"),
                                 **kw).numpy()


def check_all(inc, mode, share, max_friends=256, **port_kw):
    """Port labels == JAX labels == oracle labels, flat."""
    kw = (dict(mode="pair", min_share=share) if mode == "pair" else
          dict(mode="friend", min_friend_share=share,
               max_friends=max_friends))
    got = port_flat(inc, **kw, **port_kw)
    jax = np.asarray(J.cluster_codes(inc, flat=True, **kw)).astype(np.int64)
    assert got.tolist() == jax.tolist()
    assert got.tolist() == oracle_flat(inc, mode, share, max_friends).tolist()
    return got


@pytest.mark.parametrize("min_share,density", [(1, 0.1), (2, 0.2), (3, 0.3),
                                               (1, 0.03), (2, 0.45),
                                               (3, 0.6)])
def test_pair_matches_jax_and_oracle(rng, min_share, density):
    inc = random_incidence(rng, density=density)
    check_all(inc, "pair", min_share)


@pytest.mark.parametrize("thr,density,max_friends",
                         [(1, 0.1, 256), (2, 0.2, 256), (3, 0.25, 4)])
def test_capped_friend_matches_jax_and_oracle(rng, thr, density,
                                              max_friends):
    inc = random_incidence(rng, density=density)
    check_all(inc, "friend", thr, max_friends)


def test_size_classes(rng):
    """Barcodes with k-mer sets of 1 to 130 span five size classes; a
    one-row byte budget forces one barcode per batch and a D sub-batch per
    row, which must not change a label."""
    ks, cs = [], []
    sizes = [1, 2, 3, 9, 17, 33, 65, 5, 8, 130, 12, 40]
    for c, n in enumerate(sizes):
        ks += rng.choice(300, size=n, replace=False).tolist()
        cs += [c] * n
    for k in range(300, 320):      # shared backbone k-mers for support
        for c in range(len(sizes)):
            if rng.random() < 0.5:
                ks.append(k)
                cs.append(c)
    inc = build_incidence(np.array(ks, np.int32), np.array(cs, np.int32),
                          320, len(sizes))
    pair = check_all(inc, "pair", 2)
    friend = check_all(inc, "friend", 3, 256)
    assert port_flat(inc, mode="pair", min_share=2,
                     max_batch_bytes=1).tolist() == pair.tolist()
    assert port_flat(inc, mode="friend", min_friend_share=3, max_friends=256,
                     max_batch_bytes=1).tolist() == friend.tolist()


def test_support_above_256_is_exact():
    """Supports of 299, 300 and 301 against min_share = 300 (a link needs
    support - 1 >= 300): a bfloat16 support would round 301 to 300 and
    drop the link, 299 would stay apart either way.  Barcode 0 holds three
    k-mer pairs; the pair whose lists share 301 codes (self included) is
    the only one that joins."""
    ks, cs = [], []
    n_codes = 310
    # k-mers 0,1: both in codes 0..300 (support 301)
    # k-mers 2,3: both in codes 0..299 (support 300)
    # k-mers 4,5: both in codes 0..298 (support 299)
    for pair_id, top in enumerate((301, 300, 299)):
        for k in (2 * pair_id, 2 * pair_id + 1):
            ks += [k] * top
            cs += list(range(top))
    inc = build_incidence(np.array(ks, np.int32), np.array(cs, np.int32), 6,
                          n_codes)
    got = check_all(inc, "pair", 300)
    assert got[:6].tolist() == [0, 0, 1, 2, 3, 4]
    bf16 = torch.tensor([301.0]).to(torch.bfloat16).float().item()
    assert bf16 != 301.0     # the hazard the float32 product avoids


# -- engine and CLI ----------------------------------------------------------

PARAMS = ["-k", "21", "-w", "7", "-r", "17", "-B", "14", "--minCount", "2",
          "--maxCount", "64", "--friendShare", "4"]


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cooccur")
    rng = np.random.default_rng(3)
    n_reads, n_codes, L = 2400, 40, 120
    genome = rng.integers(0, 4, size=200_000).astype(np.uint8)
    mol = rng.integers(0, len(genome) - 8_000, size=(n_codes, 2))
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), n_reads // n_codes)
    which = rng.integers(0, 2, size=n_reads)
    offs = rng.integers(0, 8_000 - L, size=n_reads)
    reads = genome[(mol[bc, which] + offs)[:, None] + np.arange(L)]
    path = str(tmp / "lane.fqb")
    save_fqb(path, Fqb(packed=pack_2bit(reads),
                       lengths=np.full(n_reads, L, np.int32), barcode_ids=bc,
                       barcode_keys=np.arange(n_codes, dtype=np.uint32),
                       read_len=L))
    return tmp, path + ".npz"


@pytest.mark.parametrize("name,flags", [
    ("pair", ["--clusterMode", "pair", "--minShare", "2"]),
    ("capped", ["--maxFriends", "16"])])
def test_cli_matches_jax_cli(lane, name, flags):
    tmp, path = lane
    outs = []
    for fn, pre in ((jax_main, []), (main, ["--device", "cpu"])):
        out = io.StringIO()
        dump = str(tmp / f"{name}_{len(pre)}.clusters")
        assert fn(pre + PARAMS + flags + [
            "--readFQB", path, "--hashInfo", "--codeClusters",
            "--clusterSplit", "--clusterReport", "--writeClusters", dump],
            out=out, err=io.StringIO()) == 0
        with open(dump) as f:
            outs.append((SLOTS.sub("table slots N ", out.getvalue()),
                         f.read()))
    assert outs[0] == outs[1]
    assert "code 39 nKmers" in outs[1][0] and outs[1][1].count("\n") > 1000


def test_engine_modes_and_flag_sync(lane):
    """Engine.cluster dispatches on the config; flags given after the first
    read command reach the live engine; min_share passed to cluster()
    overrides the config."""
    from hash10x_tpu_torch.cli.main import run
    from hash10x_tpu_torch.io.fqb import load_fqb
    _, path = lane
    fqb = load_fqb(path)
    eng = Engine(EngineConfig(spec=HashSpec(k=21, w=7, seed=17),
                              table_bits=14, min_friend_share=4), "cpu",
                 log=None)
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    labels = {}
    for mode, mf, share in (("friend", 0, 0), ("friend", 16, 0),
                            ("pair", 0, 0), ("pair", 0, 5)):
        eng.cfg.cluster_mode, eng.cfg.max_friends = mode, mf
        eng.cluster(min_share=share)
        labels[(mode, mf, share)] = eng.cluster_labels.clone()
    assert labels[("pair", 0, 0)].tolist() == cooccur.cluster_codes(
        eng.inc, mode="pair", min_share=2).tolist()
    assert labels[("pair", 0, 5)].tolist() == cooccur.cluster_codes(
        eng.inc, mode="pair", min_share=5).tolist()
    assert labels[("friend", 16, 0)].tolist() == cooccur.cluster_codes(
        eng.inc, mode="friend", min_friend_share=4, max_friends=16).tolist()
    late = run(["--device", "cpu"] + PARAMS + [
        "--readFQB", path, "--clusterMode", "pair", "--minShare", "5",
        "--maxFriends", "3", "--codeClusters"], io.StringIO(), io.StringIO())
    assert (late.cfg.cluster_mode, late.cfg.min_share,
            late.cfg.max_friends) == ("pair", 5, 3)
    assert late.cluster_labels.tolist() == labels[("pair", 0, 5)].tolist()
    with pytest.raises(ValueError, match="unknown cluster mode"):
        cooccur.cluster_codes(eng.inc, mode="triangle")
