"""The port's shard-resident incidence (``dist/sharded_inc.py``) and sharded
friend clustering (``cluster/sparse_dist.py``) against the JAX package's
(``hash10x_tpu/dist/sharded_inc.py``, ``hash10x_tpu/cluster/sparse_dist.py``)
and the port's single-device ``cluster/sparse.py``, at 1, 2 and 8 shards:
the code-range redistribution, the distributed transpose, co-occurrence
counts, labels (flat and blocked propagation), canonical labels and the
split.  Every comparison is exact (tolerance: none)."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from hash10x_tpu.cluster import sparse_dist as JSD
from hash10x_tpu.dist import sharded_inc as JSI
from hash10x_tpu.table.incidence import build_incidence
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.cluster import sparse as SP
from hash10x_tpu_torch.cluster import sparse_dist as SD
from hash10x_tpu_torch.dist import sharded_inc as SI
from hash10x_tpu_torch.dist.group import ShardGroup
from hash10x_tpu_torch.table.incidence import incidence_from_sorted_pairs

from test_sharded_inc import fake_low_sharded_table

torch.set_num_threads(2)
U64MAX = np.uint64(2**64 - 1)


def mesh_of(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("d",))


def random_pairs(rng, n_kmers=70, n_codes=28, density=0.18):
    grid = rng.random((n_kmers, n_codes)) < density
    k, c = np.nonzero(grid)
    pairs = np.sort(c.astype(np.int64) * n_kmers + k.astype(np.int64))
    jinc = build_incidence(k.astype(np.int32), c.astype(np.int32), n_kmers,
                           n_codes)
    return pairs, jinc, convert.incidence_from_numpy(jinc, "cpu")


def port_sharded(pairs, n, n_kmers, n_codes):
    """A ShardedIncidence built the engine's way: a low-bit pair table, then
    the code-range redistribution."""
    from hash10x_tpu_torch.dist.sharded_sorted import ShardedSortedTable
    from hash10x_tpu_torch.table import sorted_table as st
    g = ShardGroup(n, "cpu")
    t = ShardedSortedTable(g, 1, 1, routing="low")
    p = torch.from_numpy(pairs)
    for i in range(n):
        sel = p[(p & (n - 1)) == i]
        t.rows[i] = st.merge_counts(t.rows[i], sel, torch.ones_like(sel))
    return SI.build_sharded_incidence(t, n_kmers, n_codes)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_build_and_transpose_equal_jax(rng, n):
    pairs, jinc, inc = random_pairs(rng)
    sh = port_sharded(pairs, n, inc.n_kmers, inc.n_codes)
    jsh = JSI.build_sharded_incidence(
        fake_low_sharded_table(pairs.astype(np.uint64), mesh_of(n)),
        jinc.n_kmers, jinc.n_codes)
    assert sh.n_pairs == inc.n_pairs
    assert sh.gathered_pairs().tolist() == pairs.tolist()
    keys, counts = convert.sharded_incidence_to_numpy(sh)
    jkeys = np.asarray(jsh.keys)
    assert counts.tolist() == jsh.pair_counts.tolist()
    for s in range(n):
        assert keys[s][keys[s] != U64MAX].tolist() == \
            jkeys[s][jkeys[s] != U64MAX].tolist()
    assert sh.code_offsets.tolist() == jinc.code_offsets.tolist()
    host = sh.to_host()
    for f in ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
              "inv2fwd"):
        assert getattr(host, f).tolist() == \
            np.asarray(getattr(jinc, f)).tolist(), f
    # the distributed transpose carries exact global forward positions: in
    # shard order the kmer-major runs are the inverted CSR and its inv2fwd
    sh.build_inverted()
    inv_k = torch.cat(sh.inv_keys)
    inv_p = torch.cat(sh.inv_pos)
    assert (inv_k % inc.n_codes).tolist() == jinc.kmer_codes.tolist()
    assert inv_p.tolist() == np.asarray(jinc.inv2fwd).tolist()
    # round trip through convert
    back = convert.sharded_incidence_from_numpy(
        keys, counts, inc.n_kmers, inc.n_codes, ShardGroup(n, "cpu"))
    assert back.gathered_pairs().tolist() == pairs.tolist()


@pytest.mark.parametrize("n", [1, 2, 8])
def test_cooccurrence_dist_equals_single(rng, n):
    _, jinc, inc = random_pairs(rng, n_kmers=50, n_codes=24, density=0.2)
    k, s = SD.cooccurrence_counts_dist(inc, ShardGroup(n, "cpu"), chunk=256)
    k1, s1 = SP.cooccurrence_counts(inc)
    assert k.tolist() == k1.tolist() and s.tolist() == s1.tolist()
    jk, js = JSD.cooccurrence_counts_dist(jinc, mesh_of(n), chunk=256)
    nc = inc.n_codes
    mk = torch.cat([k, (k % nc) * nc + k // nc])
    order = torch.argsort(mk, stable=True)
    assert mk[order].tolist() == jk.astype(np.int64).tolist()
    assert torch.cat([s, s])[order].tolist() == js.tolist()


@pytest.mark.parametrize("n,thr", [(1, 2), (2, 2), (8, 2), (8, 3)])
def test_cluster_dist_equals_single_and_jax(rng, n, thr):
    """Mirror of test_sparse_dist.py::test_cluster_dist_equals_single."""
    _, jinc, inc = random_pairs(rng)
    got = SD.cluster_codes_sparse_dist(inc, ShardGroup(n, "cpu"),
                                       min_friend_share=thr, chunk=256)
    want = SP.cluster_codes_sparse(inc, min_friend_share=thr)
    jgot = JSD.cluster_codes_sparse_dist(jinc, mesh_of(n),
                                         min_friend_share=thr, chunk=256)
    offs = inc.code_offsets.tolist()
    for c in range(inc.n_codes):
        assert got[c].tolist() == want[offs[c]:offs[c + 1]].tolist()
        assert got[c].tolist() == jgot[c].tolist()


@pytest.mark.parametrize("n,block", [(2, 40), (8, 40), (8, 150)])
def test_cluster_dist_label_blocks_equal_single(rng, n, block):
    """Mirror of test_sparse_dist.py::
    test_cluster_dist_label_blocks_equals_single."""
    _, _, inc = random_pairs(rng)
    want = SP.cluster_codes_sparse(inc, min_friend_share=2)
    got = SD.cluster_codes_sparse_dist(inc, ShardGroup(n, "cpu"),
                                       min_friend_share=2, chunk=256,
                                       flat=True, label_block_pairs=block)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("n,block", [(2, 0), (8, 0), (8, 40)])
def test_sharded_incidence_cluster_split(rng, n, block):
    """The engine's path: labels shard-resident from a ShardedIncidence
    (flat and blocked), their canonical form, molecule stats and the split
    equal the single-device results."""
    pairs, _, inc = random_pairs(rng)
    sh = port_sharded(pairs, n, inc.n_kmers, inc.n_codes)
    labels = SD.cluster_codes_sparse_dist(sh, ShardGroup(n, "cpu"),
                                          min_friend_share=2, chunk=256,
                                          flat=True, label_block_pairs=block)
    assert isinstance(labels, SI.ShardedLabels)
    want = SP.cluster_codes_sparse(inc, min_friend_share=2)
    assert labels.to_host().tolist() == want.tolist()
    K = int(want.max()) + 1
    uniq, new_code, sizes = torch.unique(inc.code_of_pair() * K + want,
                                         return_inverse=True,
                                         return_counts=True)
    codes_m, labels_m, sizes_m = labels.molecule_stats(sh)
    assert labels.n_molecules == uniq.shape[0]
    assert codes_m.tolist() == (uniq // K).tolist()
    assert labels_m.tolist() == (uniq % K).tolist()
    assert sizes_m.tolist() == sizes.tolist()
    split = SI.split_sharded(sh, labels)
    pair2 = torch.sort(new_code * inc.n_kmers + inc.code_kmers).values
    assert split.gathered_pairs().tolist() == pair2.tolist()
    want_split = incidence_from_sorted_pairs(pair2, inc.n_kmers,
                                             uniq.shape[0])
    assert split.code_offsets.tolist() == want_split.code_offsets.tolist()


def test_cluster_dist_empty_and_no_friends(rng):
    jinc = build_incidence(np.zeros(0, np.int32), np.zeros(0, np.int32), 5, 3)
    inc = convert.incidence_from_numpy(jinc, "cpu")
    got = SD.cluster_codes_sparse_dist(inc, ShardGroup(8, "cpu"),
                                       min_friend_share=1)
    assert [g.tolist() for g in got] == [[], [], []]
    _, _, inc = random_pairs(rng, n_kmers=30, n_codes=10, density=0.3)
    got = SD.cluster_codes_sparse_dist(inc, ShardGroup(4, "cpu"),
                                       min_friend_share=10 ** 6)
    offs = inc.code_offsets.tolist()
    for c in range(inc.n_codes):
        assert got[c].tolist() == list(range(offs[c + 1] - offs[c]))
