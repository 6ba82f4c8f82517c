"""The block decomposition that the sketch kernel's wide route rests on
(minimizer windows wider than ``h10x_max_tile_w``; csrc/minimizer.cu).

The route cuts each row into blocks of w k-mer positions from position 0
and runs two scans of the (hash, position) pairs in lexicographic order:
an inclusive prefix arg-lexmin and a suffix arg-lexmin, each restarting at
every block start and every run break (an invalid position).  A window of
w valid positions starting at s then has its leftmost minimum at
lexmin(suffix[s], prefix[s + w - 1]); a run [s, re) shorter than w at
lexmin(suffix[s], prefix[re - 1]), since it spans at most two blocks.
Every window start s (valid, s <= max(run end - w, run start)) marks its
argmin; the marks are the emissions, compacted in position order.

``wide_route`` below is that decomposition in plain torch.  It is held,
exactly, against the JAX package's jnp sketch and ``MK.sketch_plain`` at
many w (the decomposition does not depend on w, so small rows test it),
and at w = 4,097 and 5,000 against ``sketch_plain`` and the scalar oracle.
Without the run reset some case differs: the reset is needed."""

import numpy as np
import pytest
import torch

from hash10x_tpu.core import seqhash_jnp as J
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.oracle import seqhash_ref
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch.core import seqhash
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.kernels import minimizer as MK

torch.set_num_threads(2)

U64MAX = np.uint64(2**64 - 1)
K = 21
L_SMALL = 120           # P = 100 k-mer positions
P_SMALL = L_SMALL - K + 1


def _lexmin(h1, a1, h2, a2):
    take = (h2 < h1) | ((h2 == h1) & (a2 < a1))
    return torch.where(take, h2, h1), torch.where(take, a2, a1)


def _seg_scan(h, bound, reverse):
    """Inclusive arg-lexmin of (h, position) over [bound[p], p], or over
    [p, bound[p]] when ``reverse``, by doubling."""
    B, P = h.shape
    pos = torch.arange(P).expand(B, P)
    v, a = h.clone(), pos.clone()
    d = 1
    while d < P:
        src = pos + d if reverse else pos - d
        ok = src <= bound if reverse else src >= bound
        src = src.clamp(0, P - 1)
        v2 = torch.where(ok, v.gather(1, src), v)
        a2 = torch.where(ok, a.gather(1, src), a)
        v, a = _lexmin(v, a, v2, a2)
        d *= 2
    return v, a


def wide_route(spec, codes, lengths, compact_to=0, run_reset=True):
    """The wide route's function by its block decomposition: the outputs of
    ``MK.sketch_plain(..., mode="minimizer", compact_to=...)``."""
    h, fwd, valid = seqhash.kmer_grid(spec, codes, lengths)
    B, P = h.shape
    w = spec.w
    pos = torch.arange(P).expand(B, P)
    after_gap = torch.cat([torch.ones(B, 1, dtype=torch.bool), ~valid[:, :-1]],
                          dim=1)
    before_gap = torch.cat([~valid[:, 1:], torch.ones(B, 1, dtype=torch.bool)],
                           dim=1)
    run_start = torch.cummax(torch.where(valid & after_gap, pos, -1), 1).values
    run_last = torch.cummin(torch.where(valid & before_gap, pos, P).flip(1),
                            1).values.flip(1)
    block_first = pos // w * w
    block_last = (block_first + w - 1).clamp(max=P - 1)
    lo, hi = block_first, block_last
    if run_reset:
        lo, hi = torch.maximum(lo, run_start), torch.minimum(hi, run_last)
    pre_h, pre_a = _seg_scan(h, lo, reverse=False)
    suf_h, suf_a = _seg_scan(h, hi, reverse=True)

    start = valid & (pos <= torch.maximum(run_last + 1 - w, run_start))
    last = torch.minimum(pos + w - 1, run_last).clamp(0, P - 1)
    _, arg = _lexmin(suf_h, suf_a, pre_h.gather(1, last), pre_a.gather(1, last))
    emit = torch.zeros(B, P, dtype=torch.bool)
    rows, cols = torch.nonzero(start, as_tuple=True)
    emit[rows, arg[rows, cols]] = True

    if not compact_to:
        return h, fwd, emit, torch.zeros(B, dtype=torch.int32)
    C = compact_to
    out_h = torch.full((B, C), INT64_MAX, dtype=torch.int64)
    out_f = torch.zeros((B, C), dtype=torch.bool)
    over = torch.zeros(B, dtype=torch.int32)
    for b in range(B):
        idx = torch.nonzero(emit[b]).flatten()
        n = min(len(idx), C)
        out_h[b, :n] = h[b, idx[:n]]
        out_f[b, :n] = fwd[b, idx[:n]]
        over[b] = max(len(idx) - C, 0)
    return out_h, out_f, out_h != INT64_MAX, over


def _rows(rng, k, w, L, B=24):
    """Ragged rows with scattered Ns; at each block edge t0 (a multiple of
    w) a row gets one of: an N base at the block's first position, an N at
    the previous block's last position, or a run of w - 1, w or w + 1 valid
    positions straddling t0.  Row 0 is poly-A (all hashes tie), rows 1-4
    hold k - 1, k, L and k + w - 2 bases (a run shorter than w)."""
    P = L - k + 1
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    for t0 in range(w, P, w):
        for r in range(5, B):
            kind = (r + t0 // w) % 5
            if kind < 2:
                codes[r, t0 - kind + (k - 1 if kind == 0 else 0)] = 4
            else:
                run = w - 3 + kind                  # w - 1, w, w + 1
                st = t0 - int(rng.integers(1, max(run, 2)))
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


def _torch(codes, lengths):
    return torch.from_numpy(codes), torch.from_numpy(lengths)


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compact_to", [0, 1, 40])
@pytest.mark.parametrize("w", [2, 3, 7, 31, 64, P_SMALL - 1, P_SMALL,
                               P_SMALL + 5])
def test_blocks_equal_jax_and_plain(rng, w, compact_to):
    spec = HashSpec(k=K, w=w, seed=17)
    codes, lengths = _rows(rng, K, w, L_SMALL)
    c, ln = _torch(codes, lengths)
    got = wide_route(spec, c, ln, compact_to)
    _assert_same(got, MK.sketch_plain(spec, c, ln, compact_to=compact_to))
    assert got[2].any()
    if compact_to == 1:
        assert int(got[3].sum()) > 0     # compact rows overflow
    if compact_to:
        return
    h, f, e, _ = (x.numpy() for x in got)
    h1, f1, e1 = (np.asarray(x) for x in J.sketch(
        JHashSpec(k=K, w=w, seed=17), codes, lengths))
    valid = h1 != U64MAX
    assert (e1 == e).all()
    assert (h1[valid].astype(np.int64) == h[valid]).all()
    assert (h[~valid] == INT64_MAX).all()
    assert (f1[valid] == f[valid]).all() and not f[~valid].any()


def _wide_rows(rng, k, w):
    """Rows of w + 50 k-mer positions (the block edge at position w): one
    random, poly-A, runs of w - 1, w and w + 1 straddling the edge, an N at
    the edge and at the first block's last position, and k + w - 2 bases."""
    L = k - 1 + w + 50
    codes = rng.integers(0, 4, size=(8, L)).astype(np.uint8)
    codes[1] = 0
    for r, run in ((2, w - 1), (3, w), (4, w + 1)):
        st = int(rng.integers(1, 49))
        codes[r, st - 1] = 4
        codes[r, st + run + k - 1] = 4
    codes[5, w + k - 1] = 4          # position w invalid, w - 1 still valid
    codes[6, w - 1] = 4              # positions w - k .. w - 1 invalid
    lengths = np.full(8, L, np.int32)
    lengths[7] = k + w - 2
    return codes, lengths


@pytest.mark.parametrize("w", [4097, 5000])
def test_wide_windows_equal_plain_and_oracle(rng, w):
    spec = HashSpec(k=K, w=w, seed=17)
    codes, lengths = _wide_rows(rng, K, w)
    c, ln = _torch(codes, lengths)
    for C in (0, 2, 64):
        got = wide_route(spec, c, ln, C)
        _assert_same(got, MK.sketch_plain(spec, c, ln, compact_to=C))
        if C == 2:
            assert int(got[3].sum()) > 0
    h, f, e, _ = wide_route(spec, c, ln)
    jspec = JHashSpec(k=K, w=w, seed=17)
    for r in range(len(codes)):
        want = seqhash_ref.minimizers(jspec, list(codes[r, :lengths[r]]))
        pos = torch.nonzero(e[r]).flatten().tolist()
        assert [(p, int(h[r, p]), bool(f[r, p])) for p in pos] == want, r


def test_without_the_run_reset_the_blocks_differ(rng):
    differ = 0
    for w in (3, 7, 31):
        spec = HashSpec(k=K, w=w, seed=17)
        c, ln = _torch(*_rows(rng, K, w, L_SMALL))
        _assert_same(wide_route(spec, c, ln),
                     MK.sketch_plain(spec, c, ln))
        bad = wide_route(spec, c, ln, run_reset=False)
        differ += int((bad[2] != MK.sketch_plain(spec, c, ln)[2]).sum())
    assert differ > 0
