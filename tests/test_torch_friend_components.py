"""Capped-friend clustering's propagation (``cluster/cooccur.py``): the
plain rounds (``_friend_rounds``: k-mer labels to each friend column's
minimum and back, to the fixpoint) against a connected-components
reference in scipy over the bipartite (k-mer, friend) graph, on membership
masks as ``_membership`` makes them (no set cell on a pad): random ones,
sparse and dense, rows of 0, 1 and all-valid k-mers, pads inside rows,
empty friend columns (the table's -1 friends), a batch with no links, one
component over each row, and a path whose smallest k-mer sits at the far
end (the rounds take one pass a hop).  On a card the same batches hold the
friend-components kernel (``kernels/friend_components.py``) to the plain
rounds, label for label, at K from 8 to 2,048 and F 1, 7, 16 and 256, on
its byte loads (F not a multiple of 16, an unaligned mask) and at the
capped cell's batch shape (227, 1,024, 256); its links equal the valid
k-mers and the friends they touch, less the components.

This file imports no JAX, so its card tests run on the card with
``python -m pytest -q --noconftest -m chip tests/test_torch_friend_components.py``.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from test_torch_pair_components import _lists

from hash10x_tpu_torch.cluster import cooccur
from hash10x_tpu_torch.kernels import friend_components as FC
from hash10x_tpu_torch.table.incidence import Incidence
from hash10x_tpu_torch.utils import timing
from hash10x_tpu_torch.utils.timing import StageTimer

CASES = ("sparse", "dense", "counts", "holes", "empty_friends", "no_links",
         "one_component", "path")
WIDTHS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
FRIENDS = (1, 7, 16, 256)


def batch(case: str, K: int, F: int, seed: int):
    """``(m (B, K, F) bool, valid (B, K) bool)`` as numpy arrays, m false
    on every pad's row, as ``_membership`` leaves it."""
    rng = np.random.default_rng([seed, K, F, CASES.index(case)])
    B = max(3, min(6, (1 << 22) // (K * F)))
    if case == "counts":      # rows of 0, 1 and all k-mers, then random
        n = np.array([0, 1, K] + rng.integers(0, K + 1, B).tolist())[:B]
    elif case in ("one_component", "path"):
        n = np.full(B, K)
    else:
        n = rng.integers(max(1, K // 2), K + 1, B)
    valid = np.arange(K)[None, :] < n[:, None]
    if case in ("holes", "one_component", "path"):   # pads inside the row
        valid &= rng.random((B, K)) < 0.7
    m = np.zeros((B, K, F), bool)
    if case in ("sparse", "counts", "holes", "empty_friends"):
        m = rng.random((B, K, F)) < 1.5 / max(K, F)
    elif case == "dense":
        m = rng.random((B, K, F)) < 0.3
    elif case == "one_component":
        m = rng.random((B, K, F)) < 1.0 / (K * F)
    if case == "empty_friends":   # empty columns, the last ones as -1 pads
        m &= (rng.random(F) < 0.5)[None, None, :]
        m[:, :, F - max(1, F // 4):] = False
    for b in range(B if case in ("one_component", "path") else 0):
        idx = np.nonzero(valid[b])[0]
        if case == "one_component":   # k-mer i joins friends i and i + 1
            for i, k in enumerate(rng.permutation(idx)):
                m[b, k, [i % F, (i + 1) % F]] = True
        else:   # k-mers joined in turn by friends 0, 1, ..., the smallest last
            order = np.concatenate([rng.permutation(idx[1:]), idx[:1]])
            order = order[len(order) - min(len(order), F + 1):]
            for i in range(len(order) - 1):
                m[b, order[i:i + 2], i] = True
    return m & valid[:, :, None], valid


def reference(m, valid):
    """(labels (B, K) int64: each valid k-mer's smallest connected valid
    k-mer index, K for a pad; the links: the valid k-mers and the friends
    they touch, less their components)."""
    B, K, F = m.shape
    labels = np.full((B, K), K, np.int64)
    links = 0
    for b in range(B):
        k, f = np.nonzero(m[b] & valid[b][:, None])
        graph = coo_matrix((np.ones(k.shape[0]), (k, K + f)),
                           shape=(K + F, K + F))
        n_comp, comp = connected_components(graph, directed=False)
        idx = np.nonzero(valid[b])[0]
        low = np.full(n_comp, K, np.int64)
        np.minimum.at(low, comp[idx], idx)
        labels[b, idx] = low[comp[idx]]
        nodes = np.union1d(idx, K + f)
        links += nodes.shape[0] - np.unique(comp[nodes]).shape[0]
    return labels, links


def _tensors(case, K, F, seed, device="cpu"):
    m, valid = batch(case, K, F, seed)
    return torch.from_numpy(m).to(device), torch.from_numpy(valid).to(device)


@pytest.mark.parametrize("F", FRIENDS)
@pytest.mark.parametrize("K", [8, 64])
@pytest.mark.parametrize("case", CASES)
def test_plain_rounds_reach_the_components(case, K, F):
    m, valid = batch(case, K, F, 0)
    want, _ = reference(m, valid)
    got, rounds = cooccur._friend_rounds(torch.from_numpy(m),
                                         torch.from_numpy(valid))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "path":        # the rounds take one pass a hop
        hops = min(int(valid.sum(1).max()), F + 1) - 1
        assert rounds >= hops


def _never_built():
    raise AssertionError("the kernel was built")


@pytest.mark.parametrize("fault", ["cpu", "m_dtype", "m_rank", "valid_dtype",
                                   "valid_shape", "devices", "not_contiguous",
                                   "too_wide"])
def test_the_wrapper_rejects_before_any_build(fault, monkeypatch):
    monkeypatch.setattr(FC, "build", _never_built)
    m, valid = _tensors("sparse", 8, 16, 0)
    meta = torch.device("meta")
    K = 1 << 16
    m, valid, match = {
        "cpu": (m, valid, "unsupported device"),
        "m_dtype": (m.to(torch.uint8), valid, "bool"),
        "m_rank": (m[0], valid, "bool"),
        "valid_dtype": (m, valid.to(torch.uint8), "bool"),
        "valid_shape": (m, valid[:, :4], "bool"),
        "devices": (m, valid.to(meta), "one device"),
        "not_contiguous": (m.transpose(1, 2).contiguous().transpose(1, 2),
                           valid, "contiguous"),
        "too_wide": (torch.empty((1, K, 256), dtype=torch.bool, device=meta),
                     torch.empty((1, K), dtype=torch.bool, device=meta),
                     "shared memory"),
    }[fault]
    with pytest.raises(ValueError, match=match):
        FC.components(m, valid)


def test_shared_memory_takes_every_size_class_up_to_2_to_the_15():
    assert FC.smem_bytes(1024, 256) == 4 * 1280 + 1024
    assert FC.smem_bytes(13, 7) == 96
    assert FC.smem_bytes(1 << 15, 256) <= FC.SMEM_LIMIT \
        < FC.smem_bytes(1 << 16, 256)


def test_bound_counts_the_cells_flags_and_labels():
    nbytes, ms = FC.bound([3, 0, 740], 1024, 256)
    assert nbytes == 256 * (3 + 0 + 740) + 9 * 1024 * 3
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def _friend_batch(seed, device="cpu"):
    """``(cl, valid, friends)`` of a padded batch: rows of 0-16 valid
    k-mers at K = 16, lists of up to 8 of 24 codes, 6 friends a row with
    -1 pads."""
    rng = np.random.default_rng(seed)
    valid = torch.arange(16)[None, :] < torch.tensor([[0], [1], [9], [16]])
    cl = torch.from_numpy(_lists(rng, 4, 16, 8, 24, p_pad_row=0.0))
    cl = torch.where(valid[:, :, None], cl, -1)
    friends = torch.from_numpy(np.stack(
        [rng.choice(24, 6, replace=False) for _ in range(4)]).astype(np.int64))
    friends[:, 4:] = -1
    friends[1] = -1
    return cl.to(device), valid.to(device), friends.to(device)


def _canonical_reference(cl, valid, friends):
    m = cooccur._membership(cl, valid, friends)
    want, links = reference(m.cpu().numpy(), valid.cpu().numpy())
    return cooccur._canonical(torch.from_numpy(want), valid.cpu()), links


def test_the_cpu_runs_the_rounds_without_the_kernel(monkeypatch):
    """``friend_union_batch`` on CPU tensors runs the plain rounds, counts
    them in ``cluster.capped_rounds`` and adds no kernel links; the kernel
    is never built."""
    monkeypatch.setattr(FC, "build", _never_built)
    cl, valid, friends = _friend_batch(5)
    seen = []
    prop = cooccur._propagate

    def counted(step, v):
        lab, rounds = prop(step, v)
        seen.append(rounds)
        return lab, rounds
    monkeypatch.setattr(cooccur, "_propagate", counted)
    timer = StageTimer(None)
    with timing.recording(timer):
        got = cooccur.friend_union_batch(cl, valid, friends)
    stats = timer.stats()
    assert stats["cluster.capped_uf_hooks"] == 0
    assert stats["cluster.capped_rounds"] == sum(seen) >= 1
    assert len(seen) == 1
    want, _ = _canonical_reference(cl, valid, friends)
    assert torch.equal(got, want)


# -- on a card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("F", FRIENDS)
@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_the_plain_rounds(case, K, F):
    """Label for label against the plain rounds on the card and the
    reference; the links equal the valid k-mers and the friends they
    touch, less the components."""
    dev = _card()
    m, valid = _tensors(case, K, F, 1, dev)
    plain, _ = cooccur._friend_rounds(m, valid)
    before = FC.LAUNCHES
    lab, hooks = FC.components(m, valid)
    torch.cuda.synchronize()
    assert FC.LAUNCHES == before + 1
    assert torch.equal(lab, plain), (case, K, F)
    want, links = reference(m.cpu().numpy(), valid.cpu().numpy())
    np.testing.assert_array_equal(lab.cpu().numpy(), want)
    assert int(hooks) == links


@pytest.mark.chip
@pytest.mark.parametrize("K,F,offset", [(64, 7, 0), (100, 33, 3),
                                        (64, 16, 1), (1024, 256, 8)])
def test_the_byte_loads(K, F, offset):
    """A friend count that is not a multiple of 16, and a mask starting
    off 16-byte alignment, take the kernel's byte loads: same labels."""
    dev = _card()
    m, valid = _tensors("dense", K, F, 2, dev)
    flat = torch.zeros(m.numel() + offset, dtype=torch.bool, device=dev)
    moved = flat[offset:].view(m.shape)
    moved.copy_(m)
    assert moved.is_contiguous()
    assert (moved.data_ptr() % 16 != 0) == bool(offset)
    lab, hooks = FC.components(moved, valid)
    plain, _ = cooccur._friend_rounds(m, valid)
    torch.cuda.synchronize()
    assert torch.equal(lab, plain)
    assert int(hooks) == reference(m.cpu().numpy(), valid.cpu().numpy())[1]


def _cell_batch(dev, seed, B=227, K=1024, F=256):
    """A batch shaped as the capped cell's (B, K, F): 600-1,024 valid
    k-mers a row in a few molecules of consecutive k-mers, each friend
    column a molecule's (a quarter of them -1 pads), set at 70% within its
    molecule and rarely across."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = torch.randint(600, K + 1, (B, 1), generator=g, device=dev)
    kio = torch.arange(K, device=dev)
    valid = kio[None, :] < n
    cuts = torch.sort(torch.randint(0, K, (B, 3), generator=g, device=dev),
                      dim=1).values
    mol = (kio[None, :, None] >= cuts[:, None, :]).sum(2)       # (B, K)
    fmol = torch.randint(0, 5, (B, F), generator=g, device=dev)
    fmol[:, 3 * F // 4:] = -1                                     # no friend
    same = mol[:, :, None] == fmol[:, None, :]
    p = torch.rand((B, K, F), generator=g, device=dev)
    m = ((same & (p < 0.7)) | (p > 1 - 1e-5)) & (fmol >= 0)[:, None, :]
    return (m & valid[:, :, None]).contiguous(), valid


@pytest.mark.chip
def test_the_cells_batch_shape():
    dev = _card()
    for seed in range(2):
        m, valid = _cell_batch(dev, seed)
        plain, rounds = cooccur._friend_rounds(m, valid)
        lab, hooks = FC.components(m, valid)
        torch.cuda.synchronize()
        assert torch.equal(lab, plain)
        comps = sum(int(torch.unique(lab[b][valid[b]]).shape[0])
                    for b in range(m.shape[0]))
        touched = int(m.any(1).sum())
        assert int(hooks) == int(valid.sum()) + touched - comps
        assert rounds >= 2 and 0 < comps < int(valid.sum())


def _incidence(pairs, n_kmers, n_codes, dev):
    """An ``Incidence`` of (k-mer, barcode) pairs: both CSRs."""
    k, c = np.array(sorted(set(pairs))).T

    def csr(major, minor, n):
        o = np.lexsort((minor, major))
        off = np.concatenate([[0], np.cumsum(np.bincount(major, minlength=n))])
        return (torch.from_numpy(off).to(dev),
                torch.from_numpy(minor[o].astype(np.int64)).to(dev))
    code_off, code_kmers = csr(c, k, n_codes)
    kmer_off, kmer_codes = csr(k, c, n_kmers)
    return Incidence(n_kmers, n_codes, code_off, code_kmers, kmer_off,
                     kmer_codes)


@pytest.mark.chip
def test_cluster_codes_runs_the_kernel_on_cuda():
    """``cluster_codes`` in capped-friend mode on CUDA: one launch and one
    round a batch, the round span timed on the stream,
    ``cluster.capped_uf_hooks`` above 0, and the CPU's labels; and
    ``friend_union_batch`` on CUDA gives the CPU's labels."""
    dev = _card()
    rng = np.random.default_rng(9)
    sizes = [1, 0, 3, 9, 17, 40, 70, 100, 0, 5, 33, 64, 65, 12]
    pairs = [(int(k), c) for c, n in enumerate(sizes)
             for k in rng.choice(120, size=n, replace=False)]
    k, h = np.nonzero(rng.random((120, 24)) < 0.2)
    pairs += list(zip(k.tolist(), (h + len(sizes)).tolist()))
    n_codes = len(sizes) + 24
    inc = {d: _incidence(pairs, 120, n_codes, d) for d in ("cpu", dev)}
    kw = {"min_friend_share": 2, "max_friends": 8, "max_batch_bytes": 1 << 16}
    want = cooccur.cluster_codes(inc["cpu"], **kw)
    timer = StageTimer(None, device=dev)
    before = FC.LAUNCHES
    with timing.recording(timer), timer.span("cluster"):
        got = cooccur.cluster_codes(inc[dev], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    stats = timer.stats()
    batches = stats["cluster.capped.round.n"]
    assert batches == stats["cluster.capped.member.n"] > 1
    assert FC.LAUNCHES - before == batches == stats["cluster.capped_rounds"]
    assert stats["cluster.capped_uf_hooks"] > 0
    assert stats["cluster.capped.round.device_s"] > 0

    cl, valid, friends = _friend_batch(7)
    want, links = _canonical_reference(cl, valid, friends)
    timer = StageTimer(None, device=dev)
    with timing.recording(timer):
        got = cooccur.friend_union_batch(cl.to(dev), valid.to(dev),
                                         friends.to(dev))
    assert torch.equal(got.cpu(), want)
    stats = timer.stats()
    assert stats["cluster.capped_rounds"] == 1
    assert stats["cluster.capped_uf_hooks"] == links
