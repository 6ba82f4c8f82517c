"""Friend clustering's label propagation (``cluster/sparse.py``
``propagate_labels``) against a union-find in numpy, on random bipartite
(position, friend) graphs: isolated positions, friend nodes with one edge,
no edges, one component over everything, and long chains that take the
plain rounds many passes.  On a card the same graphs hold the union-find
kernel (``kernels/union_find.py``) to the plain version, label for label,
at both parent widths, and the edges cut into blocks (empty, odd-length
and unaligned ones among them) give the labels and links of one sweep
over them whole.

This file imports no JAX, so its card tests run on the card with
``python -m pytest -q --noconftest -m chip tests/test_torch_propagate.py``.
"""

import numpy as np
import pytest
import torch

from hash10x_tpu_torch.cluster import sparse as SP
from hash10x_tpu_torch.kernels import union_find as UF
from hash10x_tpu_torch.utils import timing
from hash10x_tpu_torch.utils.timing import StageTimer

CASES = ("random", "isolated", "single_edge_friends", "no_edges",
         "one_component", "chains", "barcode_blocks")


def graph(case: str, seed: int):
    """Edges ``(p_e, f_e)`` (int64, in random order) of a bipartite graph
    of ``n_p`` positions and ``n_f`` friend nodes: ``(p_e, f_e, n_p,
    n_f)``."""
    rng = np.random.default_rng([seed, CASES.index(case)])
    if case == "no_edges":
        n_p, n_f = int(rng.integers(1, 50)), int(rng.integers(0, 5))
        return np.zeros(0, np.int64), np.zeros(0, np.int64), n_p, n_f
    if case == "chains":
        # chains p_0 - f_0 - p_1 - f_1 - ... whose smallest position sits at
        # the far end, so a label walks the whole chain
        n_chains, length = 3, int(rng.integers(1500, 2500))
        n_p, n_f = n_chains * length + 7, n_chains * length
        perm = rng.permutation(n_p)
        p, f = [], []
        for c in range(n_chains):
            pos = np.sort(perm[c * length:(c + 1) * length])[::-1]
            fr = np.arange(c * length, (c + 1) * length - 1)
            p += [pos[:-1], pos[1:]]
            f += [fr, fr]
        p_e, f_e = np.concatenate(p), np.concatenate(f)
    elif case == "barcode_blocks":
        # components inside blocks of positions, as barcodes hold them:
        # each friend node joins random positions of its own block
        blocks, per_p, per_f = 40, 30, 6
        n_p, n_f = blocks * per_p, blocks * per_f
        fr = np.repeat(np.arange(n_f), rng.integers(1, 6, n_f))
        blk = fr // per_f
        p_e = blk * per_p + rng.integers(0, per_p, fr.shape[0])
        f_e = fr
    else:
        n_p = int(rng.integers(100, 400))
        n_f = int(rng.integers(20, 120))
        E = int(rng.integers(n_f, 3 * n_p))
        p_e = rng.integers(0, n_p, E)
        f_e = rng.integers(0, n_f, E)
        if case == "isolated":       # a third of the positions left out
            keep = rng.permutation(n_p)[: 2 * n_p // 3]
            p_e = keep[rng.integers(0, keep.shape[0], E)]
        elif case == "single_edge_friends":
            f_e = np.arange(n_f)
            p_e = rng.integers(0, n_p, n_f)
        elif case == "one_component":
            # a spanning path through every node, then the random edges
            order = rng.permutation(n_p)
            fr = np.arange(n_p - 1) % n_f
            p_e = np.concatenate([order[:-1], order[1:], p_e])
            f_e = np.concatenate([fr, fr, f_e])
    order = rng.permutation(p_e.shape[0])
    return (p_e[order].astype(np.int64), f_e[order].astype(np.int64), n_p,
            n_f)


def reference(p_e, f_e, n_p, n_f):
    """(each position's smallest connected position, the number of
    components over all n_p + n_f nodes), by a sequential union-find."""
    parent = np.arange(n_p + n_f)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for p, f in zip(p_e.tolist(), f_e.tolist()):
        a, b = find(p), find(n_p + f)
        if a != b:
            parent[max(a, b)] = min(a, b)
    roots = np.array([find(x) for x in range(n_p + n_f)])
    return roots[:n_p], np.unique(roots).shape[0]


def _tensors(case, seed, device="cpu"):
    p_e, f_e, n_p, n_f = graph(case, seed)
    return (torch.from_numpy(p_e).to(device), torch.from_numpy(f_e).to(device),
            n_p, n_f)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_plain_rounds_reach_the_components(case, seed):
    p_e, f_e, n_p, n_f = graph(case, seed)
    want, _ = reference(p_e, f_e, n_p, n_f)
    got = SP.propagate_labels(torch.from_numpy(p_e), torch.from_numpy(f_e),
                              n_p, n_f)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert SP.STATS["edges"] == p_e.shape[0]
    if case == "chains":   # the chains do take the rounds many passes
        assert SP.STATS["rounds"] >= 6


@pytest.mark.parametrize("edge_block", [1, 7, 1 << 25])
def test_plain_rounds_any_edge_block(edge_block):
    p_e, f_e, n_p, n_f = graph("random", 3)
    want, _ = reference(p_e, f_e, n_p, n_f)
    got = SP.propagate_labels(torch.from_numpy(p_e), torch.from_numpy(f_e),
                              n_p, n_f, edge_block)
    np.testing.assert_array_equal(got.numpy(), want)
    assert SP.STATS["edge_blocks"] == -(-p_e.shape[0] // edge_block)


def test_the_plain_rounds_count_no_kernel_edges():
    timer = StageTimer(None)
    p_e, f_e, n_p, n_f = _tensors("random", 4)
    with timing.recording(timer):
        SP.propagate_labels(p_e, f_e, n_p, n_f)
    stats = timer.stats()
    assert stats["cluster.uf_edges"] == stats["cluster.uf_hooks"] == 0
    assert stats["cluster.round.n"] == SP.STATS["rounds"] >= 1


def test_the_kernel_takes_cuda_tensors_only():
    p_e, f_e, n_p, n_f = _tensors("random", 5)
    with pytest.raises(ValueError, match="unsupported device"):
        UF.components(p_e, f_e, n_p, n_f)
    with pytest.raises(ValueError, match="unsupported device"):
        SP.propagate_labels(p_e.to("meta"), f_e.to("meta"), n_p, n_f)


def _never_built():
    raise AssertionError("the kernel was built")


@pytest.mark.parametrize("fault", ["none", "cpu", "lengths", "dtype",
                                   "devices"])
def test_the_block_list_entry_rejects_before_any_build(fault, monkeypatch):
    monkeypatch.setattr(UF, "build", _never_built)
    p_e, f_e, n_p, n_f = _tensors("random", 6)
    a = (p_e[:40], f_e[:40])
    blocks, match = {
        "none": ([], "no edge blocks"),
        "cpu": ([a, (p_e[40:], f_e[40:])], "unsupported device"),
        "lengths": ([a, (p_e[40:], f_e[41:])], "one length"),
        "dtype": ([a, (p_e[40:].int(), f_e[40:].int())], "int64"),
        "devices": ([a, (p_e[40:].to("meta"), f_e[40:].to("meta"))],
                    "one device"),
    }[fault]
    with pytest.raises(ValueError, match=match):
        UF.components_of_blocks(blocks, n_p, n_f)


def test_bound_counts_edges_and_labels():
    nbytes, ms = UF.bound(1_000, 10)
    assert nbytes == 16 * 1_000 + 8 * 10
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.chip
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_the_plain_rounds(case):
    """Both parent widths, 16-byte aligned edges and edges one int64 off
    alignment (the scalar loads), label for label against the plain
    rounds on the card; the links equal the node count less the
    components."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in range(3):
        p_e, f_e, n_p, n_f = _tensors(case, seed, "cuda")
        plain = SP._rounds(p_e, f_e, n_p, n_f, SP._EDGE_BLOCK)
        _, n_comp = reference(*graph(case, seed))
        for wide in (False, True):
            for lo in (0, 1):
                if lo and p_e.shape[0] == 0:
                    continue
                pe = torch.cat([p_e[:1], p_e])[1:] if lo else p_e
                fe = torch.cat([f_e[:1], f_e])[1:] if lo else f_e
                assert (pe.data_ptr() % 16 != 0) == bool(lo)
                before = UF.LAUNCHES
                lab, hooks = UF._launch(pe, fe, n_p, n_f, wide)
                torch.cuda.synchronize()
                assert UF.LAUNCHES == before + 1
                assert torch.equal(lab, plain), (case, seed, wide, lo)
                assert int(hooks) == n_p + n_f - n_comp


@pytest.mark.chip
def test_propagate_labels_runs_the_kernel_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    timer = StageTimer(None, device="cuda")
    p_e, f_e, n_p, n_f = _tensors("barcode_blocks", 0, "cuda")
    before = UF.LAUNCHES
    with timing.recording(timer), timer.span("cluster"):
        lab = SP.propagate_labels(p_e, f_e, n_p, n_f)
    torch.cuda.synchronize()
    want, n_comp = reference(*graph("barcode_blocks", 0))
    np.testing.assert_array_equal(lab.cpu().numpy(), want)
    stats = timer.stats()
    assert UF.LAUNCHES == before + 1
    assert SP.STATS["rounds"] == 1 == stats["cluster.round.n"]
    assert stats["cluster.uf_edges"] == SP.STATS["edges"] == p_e.shape[0]
    assert stats["cluster.uf_hooks"] == n_p + n_f - n_comp
    assert stats["cluster.round.device_s"] > 0


def _blocks(p_e, f_e, seed):
    """``(p_e, f_e)`` cut into blocks in order: empty ones at both ends and
    inside, odd lengths, views starting an int64 off 16-byte alignment
    (the scalar loads), and the longest block copied to such an offset."""
    E = p_e.shape[0]
    rng = np.random.default_rng(seed)
    cuts = np.sort(np.concatenate([[0, 0, min(1, E), min(1, E), E, E],
                                   rng.integers(0, E + 1, 6)])).tolist()
    blocks = [(p_e[a:b], f_e[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    i = max(range(len(blocks)), key=lambda j: blocks[j][0].shape[0])
    if blocks[i][0].shape[0]:
        blocks[i] = tuple(torch.cat([x[:1], x])[1:] for x in blocks[i])
    return blocks


@pytest.mark.chip
@pytest.mark.parametrize("case", CASES)
def test_a_block_list_is_one_sweep(case):
    """One kernel call over the blocks gives the labels of the plain rounds
    and the labels and links of one sweep over the edges whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in range(3):
        p_e, f_e, n_p, n_f = _tensors(case, seed, "cuda")
        plain = SP._rounds(p_e, f_e, n_p, n_f, SP._EDGE_BLOCK)
        _, n_comp = reference(*graph(case, seed))
        whole, whole_hooks = UF.components(p_e, f_e, n_p, n_f)
        blocks = _blocks(p_e, f_e, seed)
        assert torch.equal(torch.cat([p for p, _ in blocks]), p_e)
        assert any(b[0].shape[0] == 0 for b in blocks)
        if p_e.shape[0] > 1:
            assert any(p.shape[0] and p.data_ptr() % 16 for p, _ in blocks)
            assert any(p.shape[0] % 2 for p, _ in blocks)
        before = UF.LAUNCHES
        lab, hooks = UF.components_of_blocks(blocks, n_p, n_f)
        torch.cuda.synchronize()
        assert UF.LAUNCHES == before + 1
        assert torch.equal(lab, plain) and torch.equal(lab, whole), \
            (case, seed)
        assert int(hooks) == int(whole_hooks) == n_p + n_f - n_comp
