"""The torch port's hashing contract equals the JAX package's: HashSpec
constants and the glibc random() stream are copied, not imported, so they
are held equal here.  Comparisons are exact (integers)."""

import numpy as np
import pytest
import torch

from hash10x_tpu.glibc_random import GlibcRandom as JGlibcRandom
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu_torch.core import seqhash
from hash10x_tpu_torch.glibc_random import GlibcRandom
from hash10x_tpu_torch.hashspec import HashSpec

torch.set_num_threads(1)


@pytest.mark.parametrize("k,w,seed", [(4, 3, 17), (15, 1, 7), (16, 5, 0),
                                      (21, 11, 17), (21, 11, 2**31 + 5),
                                      (31, 2, 17), (31, 7, 123)])
def test_hashspec_equal(k, w, seed):
    a, b = HashSpec(k=k, w=w, seed=seed), JHashSpec(k=k, w=w, seed=seed)
    for f in ("k", "w", "seed", "mask", "shift1", "factor1", "shift2",
              "factor2", "pattern_rc"):
        assert getattr(a, f) == getattr(b, f), f
    assert HashSpec.from_json(b.to_json()) == a


@pytest.mark.parametrize("k,seed", [(31, 17), (21, 17), (4, 3)])
def test_int64_hash_equals_hash_func(k, seed):
    """The int64 path (two's-complement multiply, arithmetic shift, mask)
    equals HashSpec.hash_func on random 2k-bit codes."""
    spec = HashSpec(k=k, w=2, seed=seed)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << (2 * k), size=5000, dtype=np.int64)
    got = seqhash.hash_codes(spec, torch.from_numpy(x)).numpy()
    exp = [JHashSpec(k=k, w=2, seed=seed).hash_func(int(v)) for v in x]
    assert got.tolist() == exp


def test_factor1_at_or_above_2_63():
    """glibc random() yields 31 bits, so every derived factor1 is below
    2^63; a factor1 >= 2^63 must still hash right as its int64 view."""
    spec = HashSpec(k=31, w=2, seed=17)
    big = (1 << 63) | spec.factor1
    object.__setattr__(spec, "factor1", big)
    assert seqhash.to_int64(big) < 0
    rng = np.random.default_rng(6)
    x = rng.integers(0, 1 << 62, size=5000, dtype=np.int64)
    got = seqhash.hash_codes(spec, torch.from_numpy(x)).numpy()
    M64 = (1 << 64) - 1
    assert got.tolist() == [((int(v) * big) & M64) >> spec.shift1 for v in x]


@pytest.mark.parametrize("seed", [0, 1, 17, 2**31 - 1, 2**31, 2**32 - 1])
def test_glibc_random_stream_equal(seed):
    a, b = GlibcRandom(seed), JGlibcRandom(seed)
    assert [a.random() for _ in range(64)] == [b.random() for _ in range(64)]
