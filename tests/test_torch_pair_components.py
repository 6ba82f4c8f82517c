"""Pair clustering's propagation (``cluster/cooccur.py``): the plain rounds
(``_pair_rounds``: the threshold, the adjacency and min-label rounds)
against a connected-components reference in scipy, on symmetric
integer-valued support matrices: random ones at several densities and
``min_share`` 1-3, rows of 0, 1 and all-valid k-mers and rows with holes,
a row with no links, one component over the whole row, and a path whose
smallest index sits at the far end (the rounds take ~K passes).  The
support product (``_support``) gives exactly such matrices: symmetric and
integer-valued, as the kernel's one-triangle read takes them.  On a card
the same batches hold the pair-components kernel
(``kernels/pair_components.py``) to the plain rounds, label for label, at
K from 8 to 2,048 and at the pair cell's batch shape (78, 1,024, 1,024);
its links equal the valid k-mers less the components.

This file imports no JAX, so its card tests run on the card with
``python -m pytest -q --noconftest -m chip tests/test_torch_pair_components.py``.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from hash10x_tpu_torch.cluster import cooccur
from hash10x_tpu_torch.kernels import pair_components as PC
from hash10x_tpu_torch.utils import timing
from hash10x_tpu_torch.utils.timing import StageTimer

CASES = ("sparse", "dense", "counts", "holes", "no_links",
         "one_component", "path")
WIDTHS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def batch(case: str, K: int, seed: int, min_share: int = 2):
    """``(s (B, K, K) float32, valid (B, K) bool)`` as numpy arrays: S
    symmetric and integer-valued, a cell at or above ``min_share + 1``
    where the case links two k-mers and at or below ``min_share``
    elsewhere, but for cells of a pad, which take any value (links there
    must not count)."""
    rng = np.random.default_rng([seed, K, min_share, CASES.index(case)])
    B = max(3, min(6, (1 << 22) // (K * K)))
    if case == "counts":      # rows of 0, 1 and all k-mers, then random
        n = np.array([0, 1, K] + rng.integers(0, K + 1, B).tolist())[:B]
    elif case in ("one_component", "path"):
        n = np.full(B, K)
    else:
        n = rng.integers(max(1, K // 2), K + 1, B)
    valid = np.arange(K)[None, :] < n[:, None]
    if case in ("holes", "one_component", "path"):   # pads inside the row
        valid &= rng.random((B, K)) < 0.7
    link = np.zeros((B, K, K), bool)
    if case in ("sparse", "dense", "counts", "holes"):
        p = {"dense": 0.3}.get(case, 2.0 / K)
        link = rng.random((B, K, K)) < p
    elif case == "one_component":   # a path over the valid k-mers, and more
        link = rng.random((B, K, K)) < 1.0 / K
    for b in range(B if case in ("one_component", "path") else 0):
        idx = np.nonzero(valid[b])[0]
        # the smallest valid index at one end of the path
        order = np.concatenate([rng.permutation(idx[1:]), idx[:1]])
        link[b, order[:-1], order[1:]] = True
    link |= link.transpose(0, 2, 1)
    high = min_share + 1 + rng.integers(0, 3, (B, K, K))
    low = rng.integers(0, min_share + 1, (B, K, K))
    s = np.where(link, high, low)
    pad = ~(valid[:, :, None] & valid[:, None, :])
    s = np.where(pad, rng.integers(0, min_share + 4, (B, K, K)), s)
    s = np.triu(s) + np.triu(s, 1).transpose(0, 2, 1)      # symmetric
    return s.astype(np.float32), valid


def reference(s, valid, min_share):
    """(labels (B, K) int64: each valid k-mer's smallest connected valid
    index, K for a pad; the valid k-mers less the components)."""
    B, K = valid.shape
    labels = np.full((B, K), K, np.int64)
    links = 0
    for b in range(B):
        idx = np.nonzero(valid[b])[0]
        if idx.shape[0] == 0:
            continue
        sub = s[b][np.ix_(idx, idx)]
        adj = (sub - np.float32(1.0)) >= min_share
        n_comp, comp = connected_components(csr_matrix(adj), directed=False)
        low = np.full(n_comp, K, np.int64)
        np.minimum.at(low, comp, idx)
        labels[b, idx] = low[comp]
        links += idx.shape[0] - n_comp
    return labels, links


def _tensors(case, K, seed, min_share, device="cpu"):
    s, valid = batch(case, K, seed, min_share)
    return (torch.from_numpy(s).to(device), torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("min_share", [1, 2, 3])
@pytest.mark.parametrize("K", [8, 64])
@pytest.mark.parametrize("case", CASES)
def test_plain_rounds_reach_the_components(case, K, min_share):
    s, valid = batch(case, K, 0, min_share)
    want, _ = reference(s, valid, min_share)
    got, rounds = cooccur._pair_rounds(torch.from_numpy(s),
                                       torch.from_numpy(valid), min_share)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "path":        # the path does take the rounds ~K passes
        assert rounds >= int(valid.sum(1).max()) - 1


def _lists(rng, B, K, C, n_codes, p_pad_row=0.2):
    """A CL batch (B, K, C): ascending distinct codes of [0, n_codes) per
    k-mer, -1 padded; whole k-mer rows of -1 at ``p_pad_row``."""
    cl = np.full((B, K, C), -1, np.int64)
    for b in range(B):
        for k in range(K):
            if rng.random() < p_pad_row:
                continue
            m = int(rng.integers(1, C + 1))
            cl[b, k, :m] = np.sort(rng.choice(n_codes, m, replace=False))
    return cl


@pytest.mark.parametrize("B,K,C,n_codes,max_bytes", [
    (3, 8, 8, 12, 1 << 30), (4, 16, 16, 40, 1 << 30),
    (2, 64, 32, 100, 1 << 30), (5, 32, 8, 20, 1)])
def test_support_is_symmetric_and_integer_valued(B, K, C, n_codes,
                                                 max_bytes):
    """S = D @ D^T is exactly symmetric and integer-valued: each cell the
    number of codes two lists share (the kernel reads one triangle); a
    one-byte budget runs the product a row at a time."""
    rng = np.random.default_rng([B, K, C])
    cl = _lists(rng, B, K, C, n_codes)
    s = cooccur._support(torch.from_numpy(cl), max_bytes)
    assert s.dtype == torch.float32 and s.shape == (B, K, K)
    assert torch.equal(s, s.transpose(1, 2))
    assert torch.equal(s, torch.round(s))
    sets = [[set(cl[b, k][cl[b, k] >= 0].tolist()) for k in range(K)]
            for b in range(B)]
    want = np.array([[[len(sets[b][k] & sets[b][l]) for l in range(K)]
                      for k in range(K)] for b in range(B)], np.float32)
    np.testing.assert_array_equal(s.numpy(), want)


def _never_built():
    raise AssertionError("the kernel was built")


@pytest.mark.parametrize("fault", ["cpu", "s_dtype", "s_rank", "not_square",
                                   "valid_dtype", "valid_shape", "devices",
                                   "too_wide"])
def test_the_wrapper_rejects_before_any_build(fault, monkeypatch):
    monkeypatch.setattr(PC, "build", _never_built)
    s, valid = _tensors("sparse", 8, 0, 2)
    meta = torch.device("meta")
    K = 1 << 16
    s, valid, match = {
        "cpu": (s, valid, "unsupported device"),
        "s_dtype": (s.double(), valid, "float32"),
        "s_rank": (s[0], valid, "float32"),
        "not_square": (s[:, :, :4], valid, "float32"),
        "valid_dtype": (s, valid.to(torch.uint8), "bool"),
        "valid_shape": (s, valid[:, :4], "bool"),
        "devices": (s, valid.to(meta), "one device"),
        "too_wide": (torch.empty((1, K, K), device=meta),
                     torch.empty((1, K), dtype=torch.bool, device=meta),
                     "shared memory"),
    }[fault]
    with pytest.raises(ValueError, match=match):
        PC.components(s, valid, 2)


def test_shared_memory_takes_every_size_class_up_to_2_to_the_15():
    assert PC.smem_bytes(1024) == 5 * 1024
    assert PC.smem_bytes(13) == 80
    assert PC.smem_bytes(1 << 15) <= PC.SMEM_LIMIT < PC.smem_bytes(1 << 16)


def test_bound_counts_the_triangles_flags_and_labels():
    nbytes, ms = PC.bound([3, 0, 1024], 1024)
    assert nbytes == 4 * (3 + 0 + 1024 * 1023 // 2) + 9 * 1024 * 3
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_the_cpu_runs_the_rounds_without_the_kernel(monkeypatch):
    """``cluster_batch`` on CPU tensors runs the plain rounds in the round
    span, counts them, and adds no kernel links; the kernel is never
    built."""
    monkeypatch.setattr(PC, "build", _never_built)
    rng = np.random.default_rng(5)
    cl = torch.from_numpy(_lists(rng, 4, 16, 8, 10, p_pad_row=0.0))
    valid = torch.arange(16)[None, :] < torch.tensor([[0], [1], [9], [16]])
    cl = torch.where(valid[:, :, None], cl, -1)
    seen = []
    prop = cooccur._propagate

    def counted(step, v):
        lab, rounds = prop(step, v)
        seen.append(rounds)
        return lab, rounds
    monkeypatch.setattr(cooccur, "_propagate", counted)
    timer = StageTimer(None)
    with timing.recording(timer):
        got = cooccur.cluster_batch(cl, valid, 2)
    stats = timer.stats()
    assert stats["cluster.pair_uf_hooks"] == 0
    assert stats["cluster.pair_rounds"] == sum(seen) >= 1
    assert stats["cluster.pair.round.n"] == stats["cluster.pair.support.n"] \
        == 1
    s = cooccur._support(cl, 1 << 30).numpy()
    want, _ = reference(s, valid.numpy(), 2)
    np.testing.assert_array_equal(
        got.numpy(), cooccur._canonical(torch.from_numpy(want), valid).numpy())


# -- on a card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_the_plain_rounds(case, K):
    """Label for label against the plain rounds on the card and the
    reference, ``min_share`` 1-3; the links equal the valid k-mers less
    the components."""
    dev = _card()
    for min_share in (1, 2, 3):
        s, valid = _tensors(case, K, 1, min_share, dev)
        plain, _ = cooccur._pair_rounds(s, valid, min_share)
        before = PC.LAUNCHES
        lab, hooks = PC.components(s, valid, min_share)
        torch.cuda.synchronize()
        assert PC.LAUNCHES == before + 1
        assert torch.equal(lab, plain), (case, K, min_share)
        want, links = reference(s.cpu().numpy(), valid.cpu().numpy(),
                                min_share)
        np.testing.assert_array_equal(lab.cpu().numpy(), want)
        assert int(hooks) == links


@pytest.mark.chip
@pytest.mark.parametrize("K,offset", [(13, 0), (64, 1), (100, 2)])
def test_the_four_byte_loads(K, offset):
    """A width that is not a multiple of 4, and S starting 4 or 8 bytes off
    16-byte alignment, take the kernel's 4-byte loads: same labels."""
    dev = _card()
    s, valid = _tensors("dense", K, 2, 2, dev)
    flat = torch.empty(s.numel() + offset, device=dev)
    moved = flat[offset:].view(s.shape)
    moved.copy_(s)
    assert (moved.data_ptr() % 16 != 0) == bool(offset)
    lab, hooks = PC.components(moved, valid, 2)
    plain, _ = cooccur._pair_rounds(s, valid, 2)
    assert torch.equal(lab, plain)
    assert int(hooks) == reference(s.cpu().numpy(), valid.cpu().numpy(),
                                   2)[1]


def _cell_batch(dev, seed):
    """A (78, 1,024, 1,024) batch shaped as the pair cell's: n in
    (512, 1,024] valid k-mers a row, each k-mer of one of a few molecules
    along the row; S counts the holders two k-mers share, high inside a
    molecule's stretch and falling with distance."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, K = 78, 1024
    n = torch.randint(513, K + 1, (B,), generator=g, device=dev)
    valid = torch.arange(K, device=dev)[None, :] < n[:, None]
    pos = torch.sort(torch.rand((B, K), generator=g, device=dev),
                     dim=1).values
    mol = (pos * torch.randint(1, 4, (B, 1), generator=g, device=dev)).long()
    near = 24.0 * (1 - (pos[:, :, None] - pos[:, None, :]).abs() * 8)
    noise = torch.randint(0, 3, (B, K, K), generator=g, device=dev)
    s = torch.clamp(near, min=0).floor() * (mol[:, :, None]
                                            == mol[:, None, :]) + noise
    s = torch.triu(s) + torch.triu(s, 1).transpose(1, 2)
    return s.float().contiguous(), valid


@pytest.mark.chip
def test_the_cells_batch_shape():
    dev = _card()
    for seed in range(2):
        s, valid = _cell_batch(dev, seed)
        assert torch.equal(s, s.transpose(1, 2))
        plain, rounds = cooccur._pair_rounds(s, valid, 2)
        lab, hooks = PC.components(s, valid, 2)
        torch.cuda.synchronize()
        assert torch.equal(lab, plain)
        comps = sum(int(torch.unique(lab[b][valid[b]]).shape[0])
                    for b in range(s.shape[0]))
        assert int(hooks) == int(valid.sum()) - comps
        assert rounds >= 2 and 0 < comps < int(valid.sum())


@pytest.mark.chip
def test_cluster_batch_runs_the_kernel_on_cuda():
    """``cluster_batch`` on CUDA: one launch and one round a batch, the
    support and round spans timed on the stream, ``cluster.pair_uf_hooks``
    the valid k-mers less the components, and the CPU's labels."""
    dev = _card()
    rng = np.random.default_rng(9)
    cl_np = _lists(rng, 6, 64, 16, 24)
    cl = torch.from_numpy(cl_np)
    n = torch.tensor([0, 1, 30, 64, 50, 64])
    valid = torch.arange(64)[None, :] < n[:, None]
    cl = torch.where(valid[:, :, None], cl, -1)
    want = cooccur.cluster_batch(cl, valid, 2)
    timer = StageTimer(None, device=dev)
    before = PC.LAUNCHES
    with timing.recording(timer), timer.span("cluster"):
        got = cooccur.cluster_batch(cl.to(dev), valid.to(dev), 2)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    stats = timer.stats()
    assert PC.LAUNCHES == before + 1
    assert stats["cluster.pair_rounds"] == 1 == stats["cluster.pair.round.n"]
    s = cooccur._support(cl, 1 << 30).numpy()
    assert stats["cluster.pair_uf_hooks"] == reference(s, valid.numpy(),
                                                       2)[1]
    assert stats["cluster.pair.round.device_s"] > 0
    assert stats["cluster.pair.support.device_s"] > 0


@pytest.mark.chip
def test_the_support_is_symmetric_on_the_card():
    dev = _card()
    rng = np.random.default_rng(11)
    cl = torch.from_numpy(_lists(rng, 4, 256, 64, 300)).to(dev)
    s = cooccur._support(cl, 1 << 30)
    assert torch.equal(s, s.transpose(1, 2))
    assert torch.equal(s, torch.round(s))
    assert torch.equal(s.cpu(), cooccur._support(cl.cpu(), 1 << 30))
