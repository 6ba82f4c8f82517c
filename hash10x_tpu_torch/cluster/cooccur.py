"""Per-barcode molecule clustering in padded device batches — the port of
``hash10x_tpu/cluster/cooccur.py`` (the pair and capped-friend modes of
``--codeClusters``; the uncapped friend mode routes to ``cluster/sparse.py``).

Each barcode's k-mers are one row of a batch; barcodes are bucketed by
k-mer-set size into power-of-two classes (``_size_class``) so one batch
holds rows of one padded width K.  Per batch:

1. gather each k-mer's barcode list from the inverted CSR -> CL (B, K, C),
   ascending, -1 padded;
2. pair mode: dense-rank the codes of each row into a local universe of U
   codes, build the 0/1 indicator D (B, K, U) and the support S = D @ D^T
   (B, K, K); two k-mers link iff S - 1 >= min_share (both lists always hold
   the barcode itself);
   capped-friend mode: the barcode's top ``max_friends`` friends by share
   descending, then smaller id, kept iff share >= the threshold (one row of
   ``friends_table``); a k-mer and a friend link iff the friend is in the
   k-mer's list;
3. the fixpoint of min-label propagation: each k-mer's label is the
   smallest k-mer index of its component.  On CUDA one union-find pass
   over each row in a kernel takes it: pair mode's
   ``kernels/pair_components.py`` reads S and applies the threshold as it
   goes (no (B, K, K) adjacency), capped-friend mode's
   ``kernels/friend_components.py`` reads the (B, K, F) mask once (no
   int64 (B, K, F) temporaries); neither reads anything back to the host.
   On the CPU rounds of a ``where`` and a ``min`` run to the fixpoint, one
   host read a round;
4. canonical ranks: the number of distinct component labels below a
   k-mer's label, which is first-appearance numbering (oracle:
   ``hash10x_tpu/oracle/cluster_ref.py``).

The support product runs on float32 operands: 0/1 inputs and their sums are
exact in float32 (and in TF32 products with float32 accumulation), while a
bfloat16 result holds integers exactly only up to 256.  The local universe
is dense-ranked (the JAX package spans all K * C slots), so D holds only the
distinct codes of a row, and its product runs in sub-batches bounded by the
byte budget.  Labels do not depend on batch composition, so the batch size
is a memory choice only: ``max_batch_bytes`` bounds the per-batch working
set (2 GiB by default on a device with 80 GB; the JAX package's 256 MiB was
a TPU choice).

Spans and counters (``utils/timing.py``, on the engine's timer while it
clusters; none adds a synchronisation): pair mode records, a batch each,
``cluster.pair.lists`` (``batch_lists``' gather, host clock only),
``cluster.pair.support`` (dense ranks, D and D @ D^T) and
``cluster.pair.round`` (the threshold and the propagation: on CUDA the
kernel's one pass, on the CPU the adjacency and every round), the last two
with stream seconds on CUDA, and the counters
``cluster.pair_rounds`` (rounds run, summed over the batches: 1 a batch on
CUDA, one pass), ``cluster.pair_uf_hooks`` (the kernel's links, summed on
the device; 0 on the CPU), ``cluster.pair_cells`` (the B * K * K support
cells computed) and ``cluster.pair_real_cells`` (the sum of n_c^2 over the
batches' barcodes, n_c a barcode's k-mers: the cells that are not
padding).  Capped-friend mode records ``cluster.capped.friends`` (one a
pass: ``friends_table``, with ``cluster.cooccur`` inside it), and a batch
each ``cluster.capped.member`` (``batch_lists``' gather and the (B, K, F)
membership mask of ``_membership``) and ``cluster.capped.round`` (the
propagation: on CUDA the kernel's one pass, on the CPU every round of
``_friend_rounds``; and the canonical ranks), each with stream seconds on
CUDA, and the counters ``cluster.capped_rounds`` (rounds run, summed over
the batches: 1 a batch on CUDA, one pass; on the CPU each batch's rounds,
the last, unchanged one included: one host read each),
``cluster.capped_uf_hooks`` (the kernel's links, summed on the device; 0 on
the CPU), ``cluster.capped_cells`` (the B * K * F membership cells of the
batches), ``cluster.capped_real_cells`` (the sum of n_c * f_c over the
barcodes, f_c the friends in c's row: the cells that are not padding) and
``cluster.capped_cut`` (the barcodes that have more friends at the
threshold than the cap keeps); the last two are summed on the device.
Host waits (``timing.wait``): a batch each, its barcode ids sent to the
device and the two selections that put its labels in place
(``wait.cluster.batch``, three), in pair mode the read of its rank count
(``wait.cluster.pair.ranks``); on the CPU a round each
(``wait.cluster.rounds``); and the friend table's selections and reads
(``wait.cluster.capped.friends``) and the batch plan's reads
(``wait.cluster.batches``) once a pass.

The JAX package takes each batch's friends from a dense (B, n_codes) share
row and a ``top_k`` over it (``_friends`` here, kept as the reference the
tests hold ``friends_table`` against): O(n_codes^2) work over the lane,
10^12 share cells at 1M barcodes.  ``friends_table`` takes the same rows
from the sparse co-occurrence counts of ``cluster/sparse.py``, in memory
proportional to the co-occurring pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import friend_components, pair_components
from ..table.incidence import Incidence
from ..utils import timing

__all__ = ["cluster_batch", "shares_batch", "friend_union_batch",
           "friends_table", "cluster_codes"]

_PAD = (1 << 31) - 1       # sorts after every code (codes are int32-sized)
_BATCH_BYTES = 2 << 30
_FILL_CELLS = 1 << 26      # (rows, ids) cells per block of the zero-share fill


def _size_class(n: int) -> int:
    c = 8
    while c < n:
        c *= 2
    return c


def _propagate(step, valid: torch.Tensor) -> tuple:
    """Iterate ``lab <- step(lab)`` from each valid row's own index (pads
    hold K) until nothing changes; one host wait per round
    (``wait.cluster.rounds``, under the mode's round span).  Returns the
    labels and the rounds run."""
    B, K = valid.shape
    lab = torch.where(valid, torch.arange(K, device=valid.device), K)
    rounds = 1
    while True:
        new = step(lab)
        with timing.wait("cluster.rounds"):
            same = torch.equal(new, lab)
        if same:
            return lab, rounds
        lab = new
        rounds += 1


def _canonical(labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Number of distinct labels of the row below each label (pads -1)."""
    lab_s = torch.sort(torch.where(valid, labels, _PAD), dim=1).values
    is_first = torch.ones_like(lab_s, dtype=torch.bool)
    is_first[:, 1:] = lab_s[:, 1:] != lab_s[:, :-1]
    is_first &= lab_s != _PAD
    distinct_upto = torch.cumsum(is_first.to(torch.int64), dim=1)
    pos = torch.searchsorted(lab_s, labels.contiguous())   # first equal slot
    below = torch.gather(distinct_upto, 1, torch.clamp(pos - 1, min=0))
    return torch.where(valid & (pos > 0), below,
                       torch.where(valid, 0, -1))


def _support(cl: torch.Tensor, max_bytes: int) -> torch.Tensor:
    """S[b, k, l] = number of codes that lists k and l of row b share, as
    float32, computed as D @ D^T over the dense-ranked local universe."""
    B, K, C = cl.shape
    flat = cl.reshape(B, K * C)
    pad = flat < 0
    srt, order = torch.sort(torch.where(pad, _PAD, flat), dim=1)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    ranks_s = torch.cumsum(first.to(torch.int64), dim=1) - 1
    ranks = torch.empty_like(ranks_s).scatter_(1, order, ranks_s)
    ranks = torch.where(pad, 0, ranks).reshape(B, K, C)
    real = (~pad).reshape(B, K, C).to(torch.float32)
    with timing.wait("cluster.pair.ranks"):
        U = int(ranks.max()) + 1
    s = torch.empty((B, K, K), dtype=torch.float32, device=cl.device)
    sub = max(1, max_bytes // (4 * K * U))
    for a in range(0, B, sub):
        b = min(a + sub, B)
        d = torch.zeros((b - a, K, U), dtype=torch.float32, device=cl.device)
        # pads scatter 0 into rank 0; amax keeps a real 1 there
        d.scatter_reduce_(2, ranks[a:b], real[a:b], "amax")
        torch.bmm(d, d.transpose(1, 2), out=s[a:b])
    return s


def _pair_rounds(s: torch.Tensor, kmer_valid: torch.Tensor,
                 min_share: int) -> tuple:
    """The plain version of ``kernels/pair_components.py``: the adjacency
    S - 1 >= ``min_share`` between valid k-mers (each valid k-mer linked to
    itself) and min-label rounds over it to the fixpoint.  Returns the
    labels (B, K) int64 (a pad's K) and the rounds run."""
    K = s.shape[1]
    both = kmer_valid[:, :, None] & kmer_valid[:, None, :]
    adj = (s - 1.0 >= min_share) & both
    adj |= torch.eye(K, dtype=torch.bool, device=s.device)[None] \
        & kmer_valid[:, :, None]

    def step(lab):
        nbr = torch.where(adj, lab[:, None, :], K).min(dim=2).values
        return torch.minimum(lab, nbr)
    return _propagate(step, kmer_valid)


def cluster_batch(cl: torch.Tensor, kmer_valid: torch.Tensor,
                  min_share: int = 2,
                  max_bytes: int = _BATCH_BYTES) -> torch.Tensor:
    """Pair mode on one padded batch: ``cl (B, K, C)`` sorted barcode ids
    per k-mer, -1 padded; ``kmer_valid (B, K)``.  Returns canonical labels
    (B, K) int64, pad rows -1.  CUDA tensors take the pair-components
    kernel (one pass, no host read), CPU tensors the plain rounds; both
    give the same labels."""
    with timing.span("cluster.pair.support", device=True):
        s = _support(cl, max_bytes)
    with timing.span("cluster.pair.round", device=True):
        if s.device.type == "cpu":
            lab, rounds = _pair_rounds(s, kmer_valid, min_share)
            timing.add("cluster.pair_uf_hooks", 0)
        else:
            lab, hooks = pair_components.components(s, kmer_valid,
                                                    min_share)
            rounds = 1
            timing.add_device("cluster.pair_uf_hooks", hooks)
    timing.add("cluster.pair_rounds", rounds)
    return _canonical(lab, kmer_valid)


def shares_batch(cl: torch.Tensor, self_codes: torch.Tensor,
                 n_codes: int) -> torch.Tensor:
    """Rows of the barcode x barcode co-occurrence matrix: for each row, the
    number of its k-mers each barcode holds, self zeroed.  ``cl (B, K, C)``
    (-1 pad), ``self_codes (B,)``; returns (B, n_codes) int64."""
    B = cl.shape[0]
    flat = cl.reshape(B, -1)
    ok = flat >= 0
    acc = torch.zeros((B, n_codes), dtype=torch.int64, device=cl.device)
    acc.scatter_add_(1, torch.where(ok, flat, 0), ok.to(torch.int64))
    acc[torch.arange(B, device=cl.device), self_codes] = 0
    return acc


def _membership(cl: torch.Tensor, kmer_valid: torch.Tensor,
                friends: torch.Tensor) -> torch.Tensor:
    """The (B, K, F) mask of the bipartite (k-mer, friend) graph of one
    padded batch: ``cl (B, K, C)`` ascending lists (-1 pad), ``friends
    (B, F)`` (-1 pad); a valid k-mer and a friend connect iff the friend's
    id is in the k-mer's list."""
    B, K, C = cl.shape
    F = friends.shape[1]
    clp = torch.where(cl < 0, _PAD, cl)
    fq = torch.where(friends < 0, -2, friends)           # never matches
    fq_k = fq[:, None, :].expand(B, K, F).contiguous()
    idx = torch.searchsorted(clp, fq_k)
    hit = torch.gather(clp, 2, torch.clamp(idx, max=C - 1))
    return (hit == fq_k) & kmer_valid[:, :, None]


def _friend_rounds(m: torch.Tensor, kmer_valid: torch.Tensor) -> tuple:
    """The plain version of ``kernels/friend_components.py``, which CPU
    tensors take: min-label rounds over the membership mask ``m``
    (``_membership``) to the fixpoint, k-mer labels to each friend's column
    minimum and back.  Returns the labels (B, K) int64 (a pad's K) and the
    rounds run."""
    K = m.shape[1]

    def step(lab):
        colmin = torch.where(m, lab[:, :, None], K).min(dim=1).values
        back = torch.where(m, colmin[:, None, :], K).min(dim=2).values
        return torch.minimum(lab, back)
    return _propagate(step, kmer_valid)


def _friend_labels(m: torch.Tensor, kmer_valid: torch.Tensor) -> torch.Tensor:
    """Canonical labels (B, K), pad rows -1, of the components of the
    membership mask ``m`` (``_membership``).  CUDA tensors take the
    friend-components kernel (one pass, no host read), CPU tensors the
    plain rounds; both give the same labels."""
    if m.device.type == "cpu":
        lab, rounds = _friend_rounds(m, kmer_valid)
        timing.add("cluster.capped_uf_hooks", 0)
    else:
        lab, hooks = friend_components.components(m, kmer_valid)
        rounds = 1
        timing.add_device("cluster.capped_uf_hooks", hooks)
    timing.add("cluster.capped_rounds", rounds)
    return _canonical(lab, kmer_valid)


def friend_union_batch(cl: torch.Tensor, kmer_valid: torch.Tensor,
                       friends: torch.Tensor) -> torch.Tensor:
    """Components of the bipartite (k-mer, friend) graph of one padded
    batch: ``cl (B, K, C)`` ascending lists (-1 pad), ``friends (B, F)``
    (-1 pad).  A k-mer and a friend connect iff the friend's id is in the
    k-mer's list.  Returns canonical labels (B, K), pad rows -1."""
    return _friend_labels(_membership(cl, kmer_valid, friends), kmer_valid)


def _friends(cl: torch.Tensor, self_codes: torch.Tensor, n_codes: int,
             thr: int, max_friends: int) -> torch.Tensor:
    """Top-``max_friends`` friends of each row through the unique packed key
    share * n + (n - 1 - id); -1 where the share is below ``thr``.  The
    dense reference of ``friends_table``."""
    share = shares_batch(cl, self_codes, n_codes)
    iota = torch.arange(n_codes, device=cl.device)
    key = share * n_codes + (n_codes - 1 - iota)
    top = torch.topk(key, min(max_friends, n_codes), dim=1).values
    top_share = top // n_codes
    top_id = n_codes - 1 - top % n_codes
    return torch.where(top_share >= thr, top_id, -1)


def friends_table(inc: Incidence, thr: int, max_friends: int,
                  pad: bool = False) -> torch.Tensor:
    """Every barcode's row of ``_friends`` from the sparse co-occurrence
    counts: the (code, friend, share) triples of ``cooccurrence_counts`` in
    both orders, sorted by code, share descending and friend id ascending;
    a code's first ``max_friends`` with share >= ``thr`` fill its row.

    At ``thr <= 0`` the dense row goes on with the codes that share nothing
    with the barcode (itself included) in ascending id order, until it
    holds ``max_friends``; those are filled here too, so every row equals
    the dense one.  Returns (n_codes, W) int64, -1 padded: W =
    min(max_friends, n_codes) with ``pad`` or ``thr <= 0``, else the
    longest row (columns past it are -1 in every dense row).  Adds the
    codes with more such friends than ``max_friends`` to the counter
    ``cluster.capped_cut``, on the device."""
    from .sparse import STATS, cooccurrence_counts
    n, dev = inc.n_codes, inc.device
    F = min(max_friends, n)
    STATS.clear()
    keys, shares = cooccurrence_counts(inc)
    c1, c2 = keys // n, keys % n
    code, friend = torch.cat([c1, c2]), torch.cat([c2, c1])
    share = torch.cat([shares, shares])
    ok = share >= thr
    with timing.wait("cluster.capped.friends", 3):
        code, friend, share = code[ok], friend[ok], share[ok]
    # (code, friend) ascending, then stable by share descending and by code
    o = torch.argsort(code * n + friend)
    o = o[torch.argsort(-share[o], stable=True)]
    o = o[torch.argsort(code[o], stable=True)]
    code, friend = code[o], friend[o]
    STATS["friend_keys"] = code.shape[0]
    with timing.wait("cluster.capped.friends", 2 if code.numel() else 0):
        per_code = torch.bincount(code, minlength=n)
    rank = torch.arange(code.shape[0], device=dev) \
        - (torch.cumsum(per_code, 0) - per_code)[code]
    keep = rank < F
    kept = torch.clamp(per_code, max=F)
    timing.add_device("cluster.capped_cut", (per_code > F).sum())
    W = F
    if not (pad or thr <= 0):
        W = 1
        if n:
            with timing.wait("cluster.capped.friends"):
                W = max(1, int(kept.max()))
    table = torch.full((n, W), -1, dtype=torch.int64, device=dev)
    with timing.wait("cluster.capped.friends", 3):
        table[code[keep], rank[keep]] = friend[keep]
    if thr <= 0:
        with timing.wait("cluster.capped.friends", 2):
            code, friend = code[keep], friend[keep]
        _fill_zero_share(table, kept, code, friend)
    return table


def _fill_zero_share(table: torch.Tensor, kept: torch.Tensor,
                     code: torch.Tensor, friend: torch.Tensor) -> None:
    """Append to each row of ``table`` (holding ``kept`` positive-share
    friends: ``friend`` of ``code``) the ids that share nothing with the
    code, ascending, up to the row's width.  A row holding p < W friends
    needs W - p such ids, all below W + p < 2W, so ids [0, min(2W, n))
    are the candidates."""
    n, W = table.shape
    R = min(n, 2 * W)
    rows = max(1, _FILL_CELLS // R)
    near = friend < R
    for a in range(0, n, rows):
        b = min(a + rows, n)
        sel = near & (code >= a) & (code < b)
        taken = torch.zeros((b - a, R), dtype=torch.bool, device=table.device)
        # the selections, then True sent
        with timing.wait("cluster.capped.friends", 3):
            taken[code[sel] - a, friend[sel]] = True
        free = ~taken
        slot = kept[a:b, None] + torch.cumsum(free.to(torch.int64), 1) - 1
        put = free & (slot < W)
        with timing.wait("cluster.capped.friends"):
            r, ids = torch.nonzero(put, as_tuple=True)
        table[a + r, slot[r, ids]] = ids


def _gather_lists(inc: Incidence, km: torch.Tensor, valid: torch.Tensor,
                  C: int) -> torch.Tensor:
    """CL (B, K, C): the inverted-CSR list of every k-mer id of ``km``."""
    kid = torch.clamp(km, min=0)
    off = inc.kmer_offsets[kid]
    ll = inc.kmer_offsets[kid + 1] - off
    ci = torch.arange(C, device=km.device)
    ok = (ci < ll[:, :, None]) & valid[:, :, None]
    last = max(inc.kmer_codes.shape[0] - 1, 0)
    idx = torch.clamp(off[:, :, None] + ci, max=last)
    return torch.where(ok, inc.kmer_codes[idx], -1)


def batch_lists(inc: Incidence, chunk: torch.Tensor, K: int, C: int):
    """One padded batch of the barcodes ``chunk``: each row's forward-CSR
    positions (B, K) (0 where padded), the valid mask (B, K) and CL
    (B, K, C), the inverted-CSR list of each of its k-mers."""
    kio = torch.arange(K, device=chunk.device)
    valid = kio[None, :] < (inc.code_offsets[chunk + 1]
                            - inc.code_offsets[chunk])[:, None]
    pos = torch.where(valid, inc.code_offsets[chunk][:, None] + kio, 0)
    km = torch.where(valid, inc.code_kmers[pos], -1)
    return pos, valid, _gather_lists(inc, km, valid, C)


def _row_bytes(mode: str, K: int, C: int, F: int) -> int:
    """Working set of one batch row in bytes (int64 and float32 cells):
    pair mode holds CL and its sort (K*C), S and the propagation temporaries
    (K*K); friend mode holds CL and its padded copy (2*K*C) and, while
    ``_membership`` runs, four int64 (K, F) cells: the friends broadcast,
    their search positions, those clamped and the ids gathered there (its
    rounds hold less: a ``where`` at a time).  On an H100 the chr20 slice's
    capped batches (K = 1,024, C = 64, F = 256) took 9,450,496 bytes a row
    at their peak while masking (9,437,184 here) and 5.0-6.6 MB a row in
    their rounds."""
    if mode == "pair":
        return 8 * (4 * K * C + 3 * K * K)
    return 8 * (2 * K * C + 4 * K * F)


def _batches(inc: Incidence, mode: str, F: int = 0,
            max_batch_bytes: int = _BATCH_BYTES):
    """The padded batches ``cluster_codes`` takes, in its order: ``(K, C,
    codes)`` for each, the barcodes ``codes`` (int64 numpy, of one size
    class K: ascending k-mer count) whose longest k-mer list fits C, as
    many a batch as ``max_batch_bytes`` holds (``_row_bytes``)."""
    code_of = inc.code_of_pair()
    list_lens = torch.diff(inc.kmer_offsets)
    longest = torch.zeros(inc.n_codes, dtype=torch.int64, device=inc.device)
    longest.scatter_reduce_(0, code_of, list_lens[inc.code_kmers], "amax")
    with timing.wait("cluster.batches", 2):
        sizes = torch.diff(inc.code_offsets).cpu().numpy()
        longest = longest.cpu().numpy()
    order = np.argsort(sizes, kind="stable")
    active = order[sizes[order] > 0]
    kcs = np.array([_size_class(int(n)) for n in sizes[active]])
    for kc in np.unique(kcs):
        codes = active[kcs == kc]
        K, C = int(kc), _size_class(int(longest[codes].max()))
        bsz = max(1, max_batch_bytes // _row_bytes(mode, K, C, F))
        for a in range(0, len(codes), bsz):
            yield K, C, codes[a:a + bsz]


def cluster_codes(inc: Incidence, min_share: int = 2, mode: str = "friend",
                  min_friend_share: int = 8, max_friends: int = 256,
                  max_batch_bytes: int = _BATCH_BYTES) -> torch.Tensor:
    """Cluster every barcode of ``inc`` (the ``--codeClusters`` pass).

    mode="pair": the pairwise-support contract (``cluster_barcode``);
    mode="friend": friend barcodes, capped at ``max_friends`` per barcode
    (``cluster_barcode_friend``); ``max_friends=0`` runs the uncapped sparse
    pipeline of ``cluster/sparse.py``.  Returns int64 labels aligned with
    the forward CSR (``inc.code_kmers``)."""
    if mode not in ("pair", "friend"):
        raise ValueError(f"unknown cluster mode {mode!r}")
    if mode == "friend" and max_friends == 0:
        from .sparse import cluster_codes_sparse
        return cluster_codes_sparse(inc, min_friend_share=min_friend_share)
    dev = inc.device
    out = torch.full((inc.n_pairs,), -1, dtype=torch.int64, device=dev)
    if inc.n_pairs == 0:
        return out
    F = 0
    if mode == "friend":
        with timing.span("cluster.capped.friends", device=True):
            table = friends_table(inc, min_friend_share, max_friends)
        F = table.shape[1]
        timing.add_device("cluster.capped_real_cells",
                          (torch.diff(inc.code_offsets)
                           * (table >= 0).sum(1)).sum())
    with timing.wait("cluster.batches"):
        sizes = torch.diff(inc.code_offsets).cpu().numpy()
    for K, C, sel in _batches(inc, mode, F, max_batch_bytes):
        with timing.wait("cluster.batch"):
            chunk = torch.from_numpy(sel).to(dev)
        if mode == "pair":
            with timing.span("cluster.pair.lists"):
                pos, valid, cl = batch_lists(inc, chunk, K, C)
            labels = cluster_batch(cl, valid, min_share, max_batch_bytes)
            timing.add("cluster.pair_cells", len(sel) * K * K)
            timing.add("cluster.pair_real_cells",
                       int((sizes[sel].astype(np.int64) ** 2).sum()))
        else:
            with timing.span("cluster.capped.member", device=True):
                pos, valid, cl = batch_lists(inc, chunk, K, C)
                m = _membership(cl, valid, table[chunk])
                del cl
            with timing.span("cluster.capped.round", device=True):
                labels = _friend_labels(m, valid)
                del m
            timing.add("cluster.capped_cells", len(sel) * K * F)
        with timing.wait("cluster.batch", 2):
            out[pos[valid]] = labels[valid]
    return out
