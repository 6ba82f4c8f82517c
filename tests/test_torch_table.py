"""The port's sorted-run count table and incidence building blocks against
the JAX package's (``hash10x_tpu.table.sorted_table`` / ``incidence``) on
random keys with pads.  All comparisons are exact (integer keys, counts,
offsets)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hash10x_tpu.table import incidence as JI
from hash10x_tpu.table import sorted_table as JST
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch.convert import incidence_from_numpy, table_from_numpy
from hash10x_tpu_torch.table import incidence as TI
from hash10x_tpu_torch.table import sorted_table as TST

torch.set_num_threads(2)

U64MAX = np.uint64(2**64 - 1)
CPU = torch.device("cpu")


def _keys(rng, n, distinct, pad_frac=0.3, hi=1 << 42):
    pool = rng.integers(0, hi, size=distinct, dtype=np.int64)
    k = pool[rng.integers(0, distinct, size=n)]
    pad = rng.random(n) < pad_frac
    return np.where(pad, -1, k), pad


def _as_u64(k):
    return np.where(k < 0, U64MAX, k.astype(np.uint64))


def _as_i64(k):
    return torch.from_numpy(np.where(k < 0, INT64_MAX, k))


@pytest.mark.parametrize("slots", [4096, 300])
def test_dedup_pairs_weighted_matches_jax(rng, slots):
    h, pad = _keys(rng, 6000, 900)
    bc = rng.integers(-1, 40, size=6000).astype(np.int32)
    jk, jw, jo = (np.asarray(x) for x in JST.dedup_pairs_weighted(
        jnp.asarray(_as_u64(h)), jnp.asarray(bc), slots))
    tk, tw, to = TST.dedup_pairs_weighted(
        _as_i64(h), torch.from_numpy(bc.astype(np.int64)), slots)
    real = jk != U64MAX
    assert (tk.numpy()[real] == jk[real].astype(np.int64)).all()
    assert (tk.numpy()[~real] == INT64_MAX).all()
    assert (tw.numpy() == jw).all()
    assert int(to) == int(jo)
    assert (int(to) > 0) == (slots == 300)


def test_dedup_weighted_matches_jax(rng):
    h, _ = _keys(rng, 5000, 700)
    jk, jw, jo = (np.asarray(x) for x in
                  JST.dedup_weighted(jnp.asarray(_as_u64(h)), 512))
    tk, tw, to = TST.dedup_weighted(_as_i64(h), 512)
    real = jk != U64MAX
    assert (tk.numpy()[real] == jk[real].astype(np.int64)).all()
    assert (tw.numpy() == jw).all() and int(to) == int(jo) > 0


def test_merge_flush_histogram_compact_match_jax(rng):
    """Batches of pre-reduced keys appended through several flushes give
    the JAX table's (hash, count) set, histogram and band compaction."""
    jt = JST.make_sorted_table(1 << 14, 1 << 11)  # large enough not to spill
    tt = TST.make_sorted_table(1 << 8, 1 << 11, CPU)
    for _ in range(9):
        h, _ = _keys(rng, 1500, 2500)
        bc = rng.integers(0, 30, size=1500).astype(np.int32)
        jk, jw, _ = JST.dedup_pairs_weighted(jnp.asarray(_as_u64(h)),
                                             jnp.asarray(bc), 1024)
        jt = JST.append_pairs(jt, jk, jw)
        tk, tw, _ = TST.dedup_pairs_weighted(
            _as_i64(h), torch.from_numpy(bc.astype(np.int64)), 1024)
        tt = TST.append_pairs(tt, tk, tw)
    jt = JST.flush_grow(jt)
    tt = TST.flush_grow(tt)
    jh, jc = JST.compact(jt)
    th, tc = TST.compact(tt)
    assert tt.n_filled == len(jh) and tt.capacity >= tt.n_filled / 0.6
    assert (th.numpy() == jh.astype(np.int64)).all()
    assert (tc.numpy() == jc).all()
    jhist = np.asarray(JST.count_histogram(jt.hashes, jt.counts, 8))
    thist = TST.count_histogram(tt.hashes, tt.counts, 8).numpy()
    assert (jhist == thist).all()
    for lo, hi in ((2, 5), (3, 0)):
        jh, jc = JST.compact(jt, lo, hi)
        th, tc = TST.compact(tt, lo, hi)
        assert (th.numpy() == jh.astype(np.int64)).all()
        assert (tc.numpy() == jc).all()
    with pytest.raises(ValueError):
        TST.compact(TST.append(tt, _as_i64(h[:10])))


def test_table_from_numpy_round_trip(rng):
    h = np.unique(rng.integers(0, 1 << 40, size=3000)).astype(np.uint64)
    c = rng.integers(1, 90, size=len(h)).astype(np.uint32)
    hp = np.concatenate([h[::-1], np.full(50, U64MAX, np.uint64)])
    cp = np.concatenate([c[::-1], np.zeros(50, np.uint32)])
    t = table_from_numpy(hp, cp, CPU)
    th, tc = TST.compact(t)
    assert (th.numpy() == h.astype(np.int64)).all() and (tc.numpy() == c).all()
    assert (t.hashes[t.n_filled:] == INT64_MAX).all()
    ids, found = TST.lookup_ids(th, _as_i64(np.array([int(h[7]), 1, -1])))
    assert ids.tolist() == [7, -1, -1] and found.tolist() == [True, False, False]


@pytest.mark.parametrize("k,n_codes", [(30, 7), (30, 8), (21, 5000)])
def test_combined_key_bits_int63(k, n_codes):
    """One bit less than the uint64 gate: at k=30 the int63 limit is
    2^3 - 1 = 7 codes (the JAX gate allows 15)."""
    hb = TI.combined_key_bits(k, n_codes)
    assert hb == (2 * k if n_codes <= (1 << (63 - 2 * k)) - 1 else 0)
    assert JI.combined_key_bits(k, n_codes) == (
        2 * k if n_codes <= (1 << (64 - 2 * k)) - 1 else 0)


def test_incidence_csr_matches_jax(rng):
    """Per-batch pair keys, the combined-key finalize and the double CSR
    (inv2fwd included) equal the JAX functions on one random pair set."""
    n_codes = 40
    retained = np.unique(rng.integers(0, 1 << 40, size=500)).astype(np.uint64)
    hs = np.concatenate([retained[rng.integers(0, len(retained), 4000)],
                         rng.integers(0, 1 << 40, 500).astype(np.uint64)])
    bc = rng.integers(-1, n_codes, size=len(hs)).astype(np.int32)
    nk = len(retained)
    jp = np.asarray(JI.pair_keys_jit(jnp.asarray(retained), jnp.asarray(hs),
                                     jnp.asarray(bc), jnp.uint64(nk)))
    tp = TI.pair_keys(torch.from_numpy(retained.astype(np.int64)),
                      torch.from_numpy(hs.astype(np.int64)),
                      torch.from_numpy(bc.astype(np.int64)), nk).numpy()
    real = jp != U64MAX
    assert (tp[real] == jp[real].astype(np.int64)).all()
    assert (tp[~real] == INT64_MAX).all()

    pairs = np.unique(jp[real])
    hb = 2 * 20
    comb = np.unique(bc[bc >= 0].astype(np.uint64) << np.uint64(hb)
                     | hs[bc >= 0])
    jf, jn = JI.finalize_combined_pairs(jnp.asarray(comb),
                                        jnp.asarray(retained),
                                        jnp.uint64(nk), hb)
    tf = TI.finalize_combined_pairs(torch.from_numpy(comb.astype(np.int64)),
                                    torch.from_numpy(retained.astype(np.int64)),
                                    nk, hb)
    assert (tf.numpy() == np.asarray(jf)[:int(jn)].astype(np.int64)).all()
    assert (tf.numpy() == pairs.astype(np.int64)).all()

    jinc = JI.incidence_from_sorted_pairs(pairs, n_kmers=nk, n_codes=n_codes)
    tinc = TI.incidence_from_sorted_pairs(
        torch.from_numpy(pairs.astype(np.int64)), nk, n_codes)
    for f in ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
              "inv2fwd"):
        assert (getattr(tinc, f).numpy() == getattr(jinc, f)).all(), f
    back = incidence_from_numpy(jinc, CPU)
    for f in ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
              "inv2fwd"):
        assert torch.equal(getattr(back, f), getattr(tinc, f)), f
