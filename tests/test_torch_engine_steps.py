"""The engine's multi-batch device steps (``engine_steps``, the port of the
JAX engine's ``_fused_count_scan`` / ``_fused_pair_scan``) against the JAX
package.

* The segmented dedup (``dedup_weighted_segmented``,
  ``dedup_pairs_weighted_segmented``) equals S separate calls of the port's
  and of the JAX package's per-batch dedup, entry for entry, with pad
  batches and a batch past its slots, with the batch index folded into the
  key and with the extra sort.
* The port's engine at ``flush_batches`` 1, 2, 3, 16 and ``kernel_compact``
  on and off gives the JAX engine's count table (``write_counts`` text) in
  both count modes, and its incidence (retained set, pairs, both CSR
  halves) with combined keys (k = 21) and with the retained join (k = 31,
  where the combined key does not fit and the count pass takes the extra
  sort), on a lane with N bases, short and empty reads, reads without a
  barcode and one barcode larger than a batch.  The JAX engine runs on the
  CPU as ``tests/test_engine_kernel.py`` runs it (its Pallas kernel in
  interpret mode where a batch allows it).
* Overflow raises: a too-small compaction width (as
  ``test_engine_compaction_overflow_raises`` holds the JAX engine to) and
  too few slots per batch; ``emission_cap_factor=0`` (full-width slots)
  gives the JAX table.

Every comparison is exact (tolerance: none; keys, counts and offsets are
integers)."""

import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.fastq import ReadBatch as JReadBatch
from hash10x_tpu.table import sorted_table as JST
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io import fqb as FB
from hash10x_tpu_torch.io.fastq import ReadBatch
from hash10x_tpu_torch.table import sorted_table as st
from hash10x_tpu_torch.table.incidence import combined_key_bits

torch.set_num_threads(2)

U64MAX = np.uint64(2**64 - 1)
BATCH = 256
FIELDS = ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
          "inv2fwd")


# -- the segmented dedup ------------------------------------------------------

def _stacked(rng, S, N, key_bits):
    """S rows of N keys below 2**key_bits drawn from a small pool (repeats
    within and across rows), INT64_MAX pads; row 1 all pads; barcodes in
    [-1, 6)."""
    pool = rng.integers(0, 1 << key_bits, size=N // 3, dtype=np.int64)
    h = pool[rng.integers(0, len(pool), size=(S, N))]
    h[rng.random((S, N)) < 0.3] = INT64_MAX
    if S > 1:
        h[1] = INT64_MAX
    bc = rng.integers(-1, 6, size=(S, N)).astype(np.int64)
    return h, bc


def _u64(h):
    return np.where(h == INT64_MAX, U64MAX, h.astype(np.uint64))


def _jax_row(kind, h, bc, slots):
    if kind == "weighted":
        out = JST.dedup_weighted(jnp.asarray(_u64(h)), slots)
    else:
        out = JST.dedup_pairs_weighted(jnp.asarray(_u64(h)),
                                       jnp.asarray(bc.astype(np.int32)),
                                       slots)
    k, w, o = (np.asarray(x) for x in out)
    return np.where(k == U64MAX, INT64_MAX, k.astype(np.int64)), w, int(o)


@pytest.mark.parametrize("S", [1, 4, 5])
@pytest.mark.parametrize("key_bits", [20, 62])   # folded / extra sort
@pytest.mark.parametrize("kind", ["weighted", "pairs"])
def test_segmented_dedup_equals_separate_calls(kind, key_bits, S):
    rng = np.random.default_rng(S * 100 + key_bits)
    N, slots = 600, 150
    h, bc = _stacked(rng, S, N, key_bits)
    th, tbc = torch.from_numpy(h), torch.from_numpy(bc)
    if kind == "weighted":
        got = st.dedup_weighted_segmented(th, slots, key_bits)
        rows = [st.dedup_weighted(th[j], slots) for j in range(S)]
    else:
        got = st.dedup_pairs_weighted_segmented(th, tbc, slots, key_bits)
        rows = [st.dedup_pairs_weighted(th[j], tbc[j], slots)
                for j in range(S)]
    keys, wts, over = (x.numpy() for x in got)
    assert keys.shape == wts.shape == (S * slots,)
    assert keys.tolist() == torch.cat([r[0] for r in rows]).tolist()
    assert wts.tolist() == torch.cat([r[1] for r in rows]).tolist()
    assert over.tolist() == [int(r[2]) for r in rows]
    assert int(over[0]) > 0   # row 0 overflows
    jax = [_jax_row(kind, h[j], bc[j], slots) for j in range(S)]
    assert keys.tolist() == np.concatenate([r[0] for r in jax]).tolist()
    assert wts.tolist() == np.concatenate([r[1] for r in jax]).tolist()
    assert over.tolist() == [r[2] for r in jax]
    if S > 1:   # the all-pad batch keeps its slots empty
        assert (keys[slots:2 * slots] == INT64_MAX).all()
        assert (wts[slots:2 * slots] == 0).all()


# -- the engine against the JAX engine -----------------------------------------

@functools.lru_cache(maxsize=None)
def _lane_arrays():
    """3,000 reads of 100 bp from a 40 kb genome: 60 barcodes of ~40 reads
    and one of 600 (larger than a 256-read batch), 0.5% N bases, 4% short
    reads, 1% empty, 2% without a barcode."""
    rng = np.random.default_rng(10)
    L, n_small, n_big = 100, 2400, 600
    genome = rng.integers(0, 4, size=40_000).astype(np.uint8)
    n = n_small + n_big
    starts = rng.integers(0, len(genome) - L, size=n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[rng.random(codes.shape) < 0.005] = 4
    lengths = np.full(n, L, np.int32)
    short = rng.random(n) < 0.04
    lengths[short] = rng.integers(15, L, size=int(short.sum()))
    lengths[rng.random(n) < 0.01] = 0
    keys = np.concatenate([np.full(n_big, 7, np.uint32),
                           rng.integers(100, 160, size=n_small)
                           .astype(np.uint32) * 13])
    return codes, lengths, keys


def _lanes():
    codes, lengths, keys = _lane_arrays()
    fqb = FB.from_read_batch(ReadBatch(codes, lengths, keys))
    jfqb = JFB.from_read_batch(JReadBatch(codes, lengths, keys))
    no_bc = np.random.default_rng(2).random(len(fqb)) < 0.02
    fqb.barcode_ids[no_bc] = -1
    jfqb.barcode_ids[no_bc] = -1
    return jfqb, fqb


def _kw(count_mode):
    return dict(table_bits=12, batch_reads=BATCH, count_mode=count_mode,
                min_count=2, max_count=60)


def _text(eng):
    buf = io.StringIO()
    eng.write_counts(buf)
    return buf.getvalue()


@functools.lru_cache(maxsize=None)
def _jax_run(k, count_mode, incidence):
    """The JAX engine's count table text and, with ``incidence``, its
    retained set and incidence arrays."""
    jfqb, _ = _lanes()
    jeng = JEngine(JConfig(spec=JHashSpec(k=k, w=11, seed=17),
                           **_kw(count_mode)), log=None)
    jeng.count(jfqb)
    out = {"counts": _text(jeng)}
    if incidence:
        jeng.filter()
        jeng.incidence(jfqb)
        out["retained"] = jeng.retained_hashes.astype(np.int64).tolist()
        out["inc"] = {f: np.asarray(getattr(jeng.inc, f)).tolist()
                      for f in FIELDS}
        out["n_pairs"] = jeng.inc.n_pairs
    return out


def _engine(k, count_mode, **cfg):
    return Engine(EngineConfig(spec=HashSpec(k=k, w=11, seed=17),
                               **_kw(count_mode), **cfg), "cpu", log=None)


def _n_steps(eng, fqb, split_groups):
    spans = eng._lane(fqb)[1]
    return len(list(eng._step_groups(spans, split_groups))), spans


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("flush_batches", [1, 2, 3, 16])
@pytest.mark.parametrize("count_mode", ["barcodes", "occurrences"])
def test_count_steps_match_jax(count_mode, flush_batches, compact):
    _, fqb = _lanes()
    eng = _engine(21, count_mode, flush_batches=flush_batches,
                  kernel_compact=compact)
    assert (eng._compact_rows(80) > 0) == compact
    eng.count(fqb)
    assert _text(eng) == _jax_run(21, count_mode, False)["counts"]
    n_steps, spans = _n_steps(eng, fqb, count_mode == "barcodes")
    assert sum(gid is not None for *_, gid in spans) == 3   # 600 reads
    assert eng.stats["dispatches"] == n_steps
    if flush_batches == 1:
        assert n_steps == len(spans)
    else:
        assert n_steps < len(spans)


@pytest.mark.parametrize("flush_batches", [1, 3, 16])
@pytest.mark.parametrize("k", [21, 31])   # combined keys / retained join
def test_incidence_steps_match_jax(k, flush_batches):
    _, fqb = _lanes()
    assert (combined_key_bits(k, fqb.n_barcodes) > 0) == (k == 21)
    want = _jax_run(k, "barcodes", True)
    eng = _engine(k, "barcodes", flush_batches=flush_batches)
    eng.count(fqb)
    assert _text(eng) == want["counts"]
    eng.filter()
    assert eng.retained_hashes.tolist() == want["retained"]
    d0 = eng.stats["dispatches"]
    eng.incidence(fqb)
    assert eng.inc.n_pairs == want["n_pairs"] > 1000
    for f in FIELDS:
        assert getattr(eng.inc, f).tolist() == want["inc"][f], f
    assert eng.stats["dispatches"] - d0 == _n_steps(eng, fqb, False)[0]


def test_step_shapes_are_powers_of_two(monkeypatch):
    """Steps carry at most flush_batches batches, each step's S is its
    batch count rounded up to a power of two, and oversized-barcode batches
    (barcodes mode) go one per step."""
    from hash10x_tpu_torch import engine_steps as ES
    _, fqb = _lanes()
    seen = []
    real = ES.LaneSteps.__call__

    def spy(self, ss, om, retained=None):
        seen.append((ss.S, int((om[1] > 0).sum())))
        return real(self, ss, om, retained)
    monkeypatch.setattr(ES.LaneSteps, "__call__", spy)
    eng = _engine(21, "barcodes", flush_batches=6)
    eng.count(fqb)
    n_spans = len(eng._lane(fqb)[1])
    assert all(S in (1, 2, 4, 8) and n <= min(S, 6) for S, n in seen)
    assert sum(n for _, n in seen) == n_spans
    assert sum(S == 1 for S, _ in seen) >= 3   # the 600-read barcode
    assert (8, 6) in seen


def test_compaction_overflow_raises(monkeypatch):
    _, fqb = _lanes()
    eng = _engine(21, "occurrences")
    eng.count(fqb)
    monkeypatch.setattr(Engine, "_compact_rows", lambda self, P: 8)
    with pytest.raises(RuntimeError, match="overflow"):
        _engine(21, "occurrences").count(fqb)
    eng.filter()
    with pytest.raises(RuntimeError, match="overflow"):
        eng.incidence(fqb)


def test_slot_overflow_raises_and_full_width_slots_match_jax(monkeypatch):
    _, fqb = _lanes()
    eng = _engine(21, "barcodes", emission_cap_factor=0)
    assert eng._batch_slots(BATCH, 80, 12345) == 12345
    eng.count(fqb)
    assert _text(eng) == _jax_run(21, "barcodes", False)["counts"]
    monkeypatch.setattr(Engine, "_batch_slots", lambda self, b, P, n: 64)
    with pytest.raises(RuntimeError, match="overflow"):
        _engine(21, "barcodes").count(fqb)
