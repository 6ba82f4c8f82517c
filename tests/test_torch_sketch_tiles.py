"""The halo rule that the sketch kernel's tiles rest on (csrc/minimizer.cu).

The kernel cuts each row into tiles of T k-mer positions and decides every
position of a tile from the tile's bases plus a halo, without a word from
the tiles beside it.  That is right because a position's hash, strand and
emission depend only on

* minimizer mode: the positions up to w - 1 before it and up to w - 1 after
  it (its w-windows, their validity, and whether its run of valid positions
  is shorter than w), each with its k bases;
* kmer, modimizer and syncmer modes: its own k bases.

Here every seeded row is cut into tiles; each tile's sub-row (its own
positions widened by that halo and clipped to the row) goes through the
plain version, and at the tile's own positions the outputs must equal the
whole row's.  The whole row is held against the JAX package's jnp sketch.
With the halo one base short the outputs differ somewhere: the bound is
tight.  Every comparison is exact (integers and booleans)."""

import numpy as np
import pytest
import torch

from hash10x_tpu.core import seqhash_jnp as J
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.kernels import minimizer as MK

torch.set_num_threads(2)

U64MAX = np.uint64(2**64 - 1)
T = 37  # own positions per tile: odd, so edges fall everywhere mod 32


def _kw(mode, k):
    return {"syncmer_s": max(1, k // 2)} if mode == "syncmer" else {}


def _halo(mode, k, w):
    """(bases before the first own position, bases after the last own
    position's first base) that a tile needs."""
    pos = w - 1 if mode == "minimizer" else 0
    return pos, pos + k - 1


def _rows(rng, k, w, B=24, L=400):
    """Ragged rows with scattered Ns and N blocks; at each tile edge t0 a
    row gets one of: an N at the first base of the tile's left halo, an N
    just past the previous tile's right halo, or a run of w - 1, w or w + 1
    valid positions straddling t0.  Row 0 is poly-A (all hashes tie); rows
    1-4 hold k - 1, k, L and k + w - 2 bases (a run shorter than w)."""
    P = L - k + 1
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    for r in range(5, B, 4):
        s = int(rng.integers(0, L - 40))
        codes[r, s:s + int(rng.integers(1, 40))] = 4
    left, right = _halo("minimizer", k, w)
    for t0 in range(T, P, T):
        for r in range(5, B):
            kind = (r + t0 // T) % 5
            if kind == 0 and t0 - left >= 0:
                codes[r, t0 - left] = 4
            elif kind == 1 and t0 + right < L:
                codes[r, t0 + right] = 4
            elif kind >= 2:
                run = max(w - 3 + kind, 1)          # w - 1, w, w + 1
                st = t0 - int(rng.integers(0, run + 1))
                end = min(st + run + k - 1, L)      # first base past the run
                codes[r, max(st, 0):end] &= 3
                if st >= 1:
                    codes[r, st - 1] = 4
                if end < L:
                    codes[r, end] = 4
    codes[0] = 0
    lengths = np.where(rng.random(B) < 0.5, L,
                       rng.integers(0, L + 1, size=B)).astype(np.int32)
    lengths[:5] = [L, k - 1, k, L, min(L, k + w - 2)]
    return codes, lengths


def _plain(spec, codes, lengths, mode):
    h, f, e, _ = MK.sketch_plain(spec, torch.from_numpy(codes),
                                 torch.from_numpy(lengths), mode=mode,
                                 **_kw(mode, spec.k))
    return h.numpy(), f.numpy(), e.numpy()


def _tiled(spec, codes, lengths, mode, left, right):
    """The (hashes, forward, emit) grid put together from the tiles' own
    positions, each tile sketched alone on its sub-row of bases
    [t0 - left, t1 + right) clipped to [0, length)."""
    B, L = codes.shape
    P = L - spec.k + 1
    width = T + left + right + 1  # holds the own positions for right >= k - 2
    sub_codes, sub_lens, spans = [], [], []
    for r in range(B):
        n = min(max(int(lengths[r]), 0), L)
        for t0 in range(0, P, T):
            t1 = min(t0 + T, P)
            lo = max(t0 - left, 0)
            hi = max(min(t1 + right, n), lo)
            row = np.full(width, 4, np.uint8)
            row[:hi - lo] = codes[r, lo:hi]
            sub_codes.append(row)
            sub_lens.append(hi - lo)
            spans.append((r, t0, t1, lo))
    h, f, e = _plain(spec, np.stack(sub_codes),
                     np.asarray(sub_lens, np.int32), mode)
    out = [np.empty((B, P), x.dtype) for x in (h, f, e)]
    for i, (r, t0, t1, lo) in enumerate(spans):
        for grid, sub in zip(out, (h, f, e)):
            grid[r, t0:t1] = sub[i, t0 - lo:t1 - lo]
    return out


@pytest.mark.parametrize("w", [1, 11, 64, 100])
@pytest.mark.parametrize("k", [4, 21, 31])
@pytest.mark.parametrize("mode", ["kmer", "minimizer", "modimizer",
                                  "syncmer"])
def test_tiles_with_halo_equal_the_whole_row(rng, mode, k, w):
    spec = HashSpec(k=k, w=w, seed=17)
    codes, lengths = _rows(rng, k, w)
    whole = _plain(spec, codes, lengths, mode)
    tiled = _tiled(spec, codes, lengths, mode, *_halo(mode, k, w))
    for a, b in zip(whole, tiled):
        assert (a == b).all()
    h, f, e = whole
    assert e.any()
    h1, f1, e1 = (np.asarray(x) for x in J.sketch(
        JHashSpec(k=k, w=w, seed=17), codes, lengths, mode=mode,
        **_kw(mode, k)))
    valid = h1 != U64MAX
    assert (e1 == e).all()
    assert (h1[valid].astype(np.int64) == h[valid]).all()
    assert (h[~valid] == INT64_MAX).all()
    assert (f1[valid] == f[valid]).all() and not f[~valid].any()


def _edge_rows(rng, k, B=64, L=600):
    """Rows whose runs end or start at tile edges, where a short halo shows:
    even rows end a run at each edge's first own position t0 (an N at base
    t0 + k), odd rows start one at the previous tile's last own position
    (an N at base t0 - 2)."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    for t0 in range(T, L - k + 1, T):
        codes[0::2, min(t0 + k, L - 1)] = 4
        codes[1::2, t0 - 2] = 4
    return codes, np.full(B, L, np.int32)


@pytest.mark.parametrize("mode,side", [("minimizer", "left"),
                                       ("minimizer", "right"),
                                       ("kmer", "right"),
                                       ("modimizer", "right"),
                                       ("syncmer", "right")])
def test_a_halo_one_base_short_differs(rng, mode, side):
    k, w = 21, 11
    spec = HashSpec(k=k, w=w, seed=17)
    codes, lengths = _edge_rows(rng, k)
    whole = _plain(spec, codes, lengths, mode)
    left, right = _halo(mode, k, w)
    tiled = _tiled(spec, codes, lengths, mode, left, right)
    assert all((a == b).all() for a, b in zip(whole, tiled))
    short = (left - 1, right) if side == "left" else (left, right - 1)
    tiled = _tiled(spec, codes, lengths, mode, *short)
    assert any((a != b).any() for a, b in zip(whole, tiled))
