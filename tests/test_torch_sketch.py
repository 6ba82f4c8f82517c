"""The port's sketch (core/seqhash.py and kernels/minimizer.sketch_plain,
the CUDA kernel's plain version) against the JAX package's jnp sketch, its
Pallas kernel (interpret mode off-TPU, as tests/test_kernel.py runs it) and
the scalar oracle.  Every comparison is exact: hashes, strands, emission
sets, order and overflow counts are integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hash10x_tpu.core import encode as JE
from hash10x_tpu.core import seqhash_jnp as J
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.kernels import minimizer_pallas as MP
from hash10x_tpu.oracle import seqhash_ref as O
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch.core import encode as E
from hash10x_tpu_torch.core import seqhash as S
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.kernels import minimizer as MK

torch.set_num_threads(2)

U64MAX = np.uint64(2**64 - 1)


def _lane(rng, k, w, B=64, L=80):
    """Ragged reads with Ns, a short read (0 < P_i < w), a one-k-mer read,
    an empty read and homopolymer runs."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[0] = 2
    codes[1, 10:50] = 0
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:2] = L
    lengths[2] = k + w - 2
    lengths[3] = k
    lengths[4] = 0
    return codes, lengths


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("k,w", [(4, 3), (15, 1), (16, 5), (17, 7), (21, 11),
                                 (31, 2)])
def test_sketch_matches_jnp_and_oracle(rng, k, w):
    codes, lengths = _lane(rng, k, w)
    h2, f2, e2 = (x.numpy() for x in
                  S.sketch(HashSpec(k=k, w=w, seed=17), _torch(codes),
                           _torch(lengths)))
    jspec = JHashSpec(k=k, w=w, seed=17)
    h1, f1, e1 = (np.asarray(x) for x in J.sketch(jspec, codes, lengths))
    valid = h1 != U64MAX
    assert (e1 == e2).all()
    assert (h1[valid].astype(np.int64) == h2[valid]).all()
    assert (h2[~valid] == INT64_MAX).all()
    assert (f1[valid] == f2[valid]).all() and not f2[~valid].any()
    for r in range(12):
        exp = O.minimizers(jspec, list(codes[r, :lengths[r]]))
        got = [(p, int(h2[r, p]), bool(f2[r, p]))
               for p in range(h2.shape[1]) if e2[r, p]]
        assert got == exp, f"read {r}"


def test_kmer_mode_matches_jnp(rng):
    codes, lengths = _lane(rng, 21, 11)
    h2, f2, e2 = (x.numpy() for x in
                  S.sketch(HashSpec(k=21, w=11, seed=17), _torch(codes),
                           _torch(lengths), mode="kmer"))
    h1, f1, e1 = (np.asarray(x) for x in
                  J.sketch(JHashSpec(k=21, w=11, seed=17), codes, lengths,
                           mode="kmer"))
    assert (e1 == e2).all()
    assert (h1[e1].astype(np.int64) == h2[e1]).all()
    assert (f1[e1] == f2[e1]).all()


@pytest.mark.parametrize("mode,kw", [("modimizer", {"m": 7}),
                                     ("syncmer", {"syncmer_s": 11})])
def test_plain_modes_match_jnp(rng, mode, kw):
    """The modimizer and syncmer masks (plain form; tests/test_torch_modes.py
    holds the kernel's plain version to the Pallas kernel in these modes)."""
    codes, lengths = _lane(rng, 21, 11)
    h2, _, e2 = (x.numpy() for x in
                 S.sketch(HashSpec(k=21, w=11, seed=17), _torch(codes),
                          _torch(lengths), mode=mode, **kw))
    h1, _, e1 = (np.asarray(x) for x in
                 J.sketch(JHashSpec(k=21, w=11, seed=17), codes, lengths,
                          mode=mode, **kw))
    assert (e1 == e2).all()
    assert (h1[e1].astype(np.int64) == h2[e1]).all()


def test_compact_plain_matches_pallas_compaction(rng):
    """sketch_plain(compact_to=C) == the Pallas kernel's in-kernel
    compaction: same emissions in the same (ascending position) order, the
    same strands, INT64_MAX pads, and exact per-read overflow (C=8, w=3
    forces it).  B=1024 with no short reads, the Pallas kernel's domain."""
    k, w, C = 21, 3, 8
    codes = rng.integers(0, 4, size=(1024, 128)).astype(np.uint8)
    lengths = rng.integers(k + w - 1, 129, size=1024).astype(np.int32)
    lengths[:8] = 0
    h1, f1, e1, ov1 = (np.asarray(x) for x in MP.sketch_minimizer_compact(
        JHashSpec(k=k, w=w, seed=17), jnp.asarray(codes),
        jnp.asarray(lengths), C))
    h2, f2, e2, ov2 = (x.numpy() for x in MK.sketch_plain(
        HashSpec(k=k, w=w, seed=17), _torch(codes), _torch(lengths),
        compact_to=C))
    assert ov2.dtype == np.int32 and (ov1 == ov2).all() and ov2.max() > 0
    assert (e1 == e2).all()
    assert (h1[e1].astype(np.int64) == h2[e2]).all()
    assert (f1[e1] == f2[e2]).all()
    assert (h2[~e2] == INT64_MAX).all()


def test_dense_plain_matches_pallas(rng):
    codes = rng.integers(0, 4, size=(1024, 96)).astype(np.uint8)
    lengths = rng.integers(31, 97, size=1024).astype(np.int32)
    h1, f1, e1 = (np.asarray(x) for x in MP.sketch_minimizer(
        JHashSpec(k=21, w=11, seed=17), jnp.asarray(codes),
        jnp.asarray(lengths)))
    h2, f2, e2, ov = (x.numpy() for x in MK.sketch_plain(
        HashSpec(k=21, w=11, seed=17), _torch(codes), _torch(lengths)))
    assert (e1 == e2).all() and not ov.any()
    assert (h1[e1].astype(np.int64) == h2[e2]).all()
    assert (f1[e1] == f2[e2]).all()


def test_keys_are_int64_with_int64_max_pads(rng):
    codes, lengths = _lane(rng, 21, 11)
    for C in (0, 16):
        outs = MK.sketch_plain(HashSpec(k=21, w=11, seed=17), _torch(codes),
                               _torch(lengths), compact_to=C)
        assert all(x.dtype != torch.uint64 for x in outs)
        h, f, e, ov = outs
        assert h.dtype == torch.int64 and f.dtype == torch.bool
        assert e.dtype == torch.bool and ov.dtype == torch.int32
        assert (h[~e] == INT64_MAX).all() if C else (h[e] < INT64_MAX).all()
        assert (h[e] >= 0).all() and (h[e] < (1 << 42)).all()


def test_wrapper_takes_plain_version_only_on_cpu(rng):
    codes, lengths = _lane(rng, 21, 11)
    spec = HashSpec(k=21, w=11, seed=17)
    before = (MK.LAUNCHES, MK.PLAIN_CALLS)
    got = MK.sketch(spec, _torch(codes), _torch(lengths), compact_to=16)
    exp = MK.sketch_plain(spec, _torch(codes), _torch(lengths), compact_to=16)
    assert all(torch.equal(a, b) for a, b in zip(got, exp))
    assert (MK.LAUNCHES, MK.PLAIN_CALLS) == (before[0], before[1] + 1)
    meta = torch.empty((4, 80), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        MK.sketch(spec, meta, torch.empty(4, dtype=torch.int32,
                                          device="meta"))


def test_unpack_2bit_torch_matches_numpy(rng):
    codes = rng.integers(0, 4, size=(16, 70)).astype(np.uint8)
    codes[3, 5] = 4
    codes[9, 69] = 4
    packed, nm = E.pack_2bit(codes), E.nmask_from_codes(codes)
    got = E.unpack_2bit_torch(_torch(packed.view(np.int32)), 70,
                              _torch(nm.view(np.int32))).numpy()
    assert (got == JE.unpack_2bit(packed, 70, nm)).all()
    assert (got == codes).all()
