"""The port's back half (incidence, friend clustering, split, report)
against the JAX Engine and the scalar oracle.  The JAX engine's filtered
count state is carried into the port with ``convert.py``, so every phase is
compared on identical inputs.  All comparisons are exact (integer CSR
fields, labels, text)."""

import io

import numpy as np
import pytest
import torch

from hash10x_tpu.core.encode import pack_2bit as jpack
from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io.fqb import Fqb as JFqb
from hash10x_tpu.oracle import cluster_ref as CR
from hash10x_tpu.table import sorted_table as JST
from hash10x_tpu_torch.cluster import sparse as SP
from hash10x_tpu_torch.convert import (engine_state_from_numpy,
                                       incidence_from_numpy)
from hash10x_tpu_torch.core.encode import pack_2bit
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import Fqb

torch.set_num_threads(2)

INC_FIELDS = ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
              "inv2fwd")


def _molecule_lane(seed, n_codes, reads_per_code, read_len=100,
                   genome_len=200_000, mol_len=8_000):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    mol_starts = rng.integers(0, genome_len - mol_len, size=n_codes)
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), reads_per_code)
    offs = rng.integers(0, mol_len - read_len, size=len(bc))
    reads = genome[(mol_starts[bc] + offs)[:, None] + np.arange(read_len)]
    kw = dict(lengths=np.full(len(bc), read_len, np.int32), barcode_ids=bc,
              barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=read_len)
    return JFqb(packed=jpack(reads), **kw), Fqb(packed=pack_2bit(reads), **kw)


def _jax_pipeline(jfqb, k, w, share):
    jeng = JEngine(JConfig(spec=JHashSpec(k=k, w=w, seed=17), table_bits=14,
                           min_friend_share=share), log=None)
    jeng.count(jfqb)
    jeng.filter()
    jeng.incidence(jfqb)
    return jeng


def _port_from(jeng, k, w, share):
    """A port engine holding the JAX engine's count table and band."""
    eng = Engine(EngineConfig(spec=HashSpec(k=k, w=w, seed=17),
                              table_bits=14, min_friend_share=share),
                 "cpu", log=None)
    h, c = JST.compact(jeng._flushed())
    engine_state_from_numpy(eng, h, c, jeng.retained_hashes,
                            jeng.retained_counts,
                            n_reads=jeng.n_reads_counted)
    return eng


def _assert_inc_equal(tinc, jinc):
    assert (tinc.n_kmers, tinc.n_codes) == (jinc.n_kmers, jinc.n_codes)
    for f in INC_FIELDS:
        a, b = getattr(tinc, f), getattr(jinc, f)
        if b is None:
            continue
        assert (a.numpy() == np.asarray(b)).all(), f


@pytest.fixture(scope="module")
def lane():
    jfqb, fqb = _molecule_lane(3, n_codes=60, reads_per_code=50)
    jeng = _jax_pipeline(jfqb, 21, 7, 4)
    jeng.cluster()
    jlabels = np.asarray(jeng.cluster_labels).copy()
    jeng.split()
    jrep = io.StringIO()
    jeng.report(jrep)
    return dict(jeng=jeng, fqb=fqb, jlabels=jlabels,
                jorigin=np.asarray(jeng.split_origin),
                jsplit=jeng.split_inc, jreport=jrep.getvalue())


def test_incidence_cluster_split_report_match_jax(lane):
    jeng = lane["jeng"]
    eng = _port_from(jeng, 21, 7, 4)
    eng.incidence(lane["fqb"])
    _assert_inc_equal(eng.inc, jeng.inc)
    assert eng.inc.n_pairs > 10_000
    eng.cluster()
    assert (eng.cluster_labels.numpy() == lane["jlabels"]).all()
    assert lane["jlabels"].max() > 0
    eng.split()
    assert (eng.split_origin.numpy() == lane["jorigin"]).all()
    _assert_inc_equal(eng.split_inc, lane["jsplit"])
    rep = io.StringIO()
    eng.report(rep)
    assert rep.getvalue() == lane["jreport"]
    # report straight after cluster (no split cache) is the same text
    eng.cluster()
    rep2 = io.StringIO()
    eng.report(rep2)
    assert rep2.getvalue() == lane["jreport"]


def test_labels_match_oracle_friend_clustering(lane):
    jinc = lane["jeng"].inc
    inc = incidence_from_numpy(jinc, "cpu")
    labels = SP.cluster_codes_sparse(inc, min_friend_share=4).numpy()
    hash_codes = {h: list(jinc.codes_of(h)) for h in range(jinc.n_kmers)}
    for c in range(jinc.n_codes):
        ks = list(jinc.kmers_of(c))
        exp = CR.cluster_barcode_friend(ks, hash_codes, c,
                                        min_friend_share=4, max_friends=0)
        got = labels[jinc.code_offsets[c]:jinc.code_offsets[c + 1]]
        assert got.tolist() == exp, f"code {c}"
    assert (labels == lane["jlabels"]).all()


def test_blocked_propagation_and_hand_built_incidence(lane):
    """Tiny edge blocks (many scatter blocks per round), a tiny
    co-occurrence chunk (many reductions), and an incidence without inv2fwd
    all give the same labels."""
    inc = incidence_from_numpy(lane["jeng"].inc, "cpu")
    ref = SP.cluster_codes_sparse(inc, min_friend_share=4)
    blocked = SP.cluster_codes_sparse(inc, min_friend_share=4, chunk=1000,
                                      edge_block=777)
    assert torch.equal(ref, blocked)
    inc.inv2fwd = None
    assert torch.equal(ref, SP.cluster_codes_sparse(inc, min_friend_share=4))


def test_cooccurrence_counts_match_oracle_shares(lane):
    jinc = lane["jeng"].inc
    keys, shares = SP.cooccurrence_counts(incidence_from_numpy(jinc, "cpu"))
    hash_codes = {h: list(jinc.codes_of(h)) for h in range(jinc.n_kmers)}
    got = dict(zip(keys.tolist(), shares.tolist()))
    n = jinc.n_codes
    for c in range(0, n, 7):
        exp = CR.barcode_shares(list(jinc.kmers_of(c)), hash_codes, c)
        for c2, s in exp.items():
            key = min(c, c2) * n + max(c, c2)
            assert got[key] == s


def test_new_incidence_clears_label_state(lane):
    jeng = lane["jeng"]
    eng = _port_from(jeng, 21, 7, 4)
    eng.incidence(lane["fqb"])
    eng.cluster()
    eng.split()
    eng.incidence(lane["fqb"])
    assert eng.cluster_labels is None and eng.split_inc is None
    assert eng.split_origin is None and eng._mol_cache is None
    with pytest.raises(RuntimeError):
        eng.report(io.StringIO())


@pytest.mark.parametrize("n_codes", [7, 8])
def test_incidence_either_side_of_int63_combined_key_limit(n_codes):
    """k=30: the port combines keys for <= 7 codes and joins per batch for
    8 (the JAX package combines up to 15); both give the JAX incidence."""
    from hash10x_tpu_torch.table.incidence import combined_key_bits
    assert bool(combined_key_bits(30, n_codes)) == (n_codes == 7)
    jfqb, fqb = _molecule_lane(5, n_codes=n_codes, reads_per_code=60,
                               genome_len=30_000, mol_len=3_000)
    jeng = _jax_pipeline(jfqb, 30, 5, 2)
    eng = _port_from(jeng, 30, 5, 2)
    eng.incidence(fqb)
    assert eng.inc.n_pairs > 500
    _assert_inc_equal(eng.inc, jeng.inc)
