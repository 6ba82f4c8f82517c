"""The seam between host state and port state.  Inbound, numpy count
tables, incidences and engine state (the JAX package's layout, uint64 keys
with U64MAX pads) become the port's int64 torch state on a chosen device;
outbound, port tensors become the JAX package's checkpoint dtypes (uint64
keys, uint32 counts, int64 offsets, int32 ids), each range-checked.

This system has no weights: its state is the count table, the retained
count band and the incidence.  The per-phase tests load the JAX engine's
state through these functions so each phase of the port is compared on the
same inputs, and ``Engine.save``/``Engine.load`` write and read the JAX
package's ``.npz`` checkpoints through them.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashspec import U64MAX
from .table import sorted_table as st
from .table.incidence import Incidence

__all__ = ["keys_from_numpy", "table_from_numpy", "incidence_from_numpy",
           "labels_from_numpy",
           "engine_state_from_numpy", "keys_to_numpy", "to_numpy",
           "incidence_to_numpy", "incidence_from_npz",
           "sharded_table_from_numpy", "sharded_table_to_numpy",
           "retained_sharded_from_numpy", "retained_sharded_to_numpy",
           "sharded_incidence_from_numpy", "sharded_incidence_to_numpy"]

_INC_FIELDS = (("code_offsets", np.int64), ("code_kmers", np.int32),
               ("kmer_offsets", np.int64), ("kmer_codes", np.int32))


def keys_from_numpy(hashes_u64: np.ndarray, device) -> torch.Tensor:
    """Real uint64 keys (U64MAX pads dropped) as an int64 tensor; every real
    canonical hash is below 2^62."""
    h = np.asarray(hashes_u64, np.uint64)
    h = h[h != np.uint64(U64MAX)]
    if len(h) and int(h.max()) >= 1 << 63:
        raise ValueError("key does not fit int64")
    return torch.from_numpy(h.astype(np.int64)).to(device)


def table_from_numpy(hashes_u64: np.ndarray, counts_u32: np.ndarray, device,
                     load: float = 0.6) -> st.SortedTable:
    """A flushed count table holding the (hash, count) pairs (sorted here);
    U64MAX entries are pads and dropped."""
    h = np.asarray(hashes_u64, np.uint64)
    real = h != np.uint64(U64MAX)
    order = np.argsort(h[real], kind="stable")
    keys = keys_from_numpy(h[real][order], device)
    counts = torch.from_numpy(
        np.asarray(counts_u32)[real][order].astype(np.int32)).to(device)
    n = keys.shape[0]
    cap = 1
    while n > load * cap:
        cap *= 2
    t = st.make_sorted_table(cap, 1, device)
    t.hashes[:n] = keys
    t.counts[:n] = counts
    t.n_filled = n
    return t


def incidence_from_numpy(inc, device) -> Incidence:
    """A port Incidence (int64 tensors) from any object with the JAX
    ``Incidence`` fields."""
    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
    inv = getattr(inc, "inv2fwd", None)
    return Incidence(int(inc.n_kmers), int(inc.n_codes), t(inc.code_offsets),
                     t(inc.code_kmers), t(inc.kmer_offsets),
                     t(inc.kmer_codes), None if inv is None else t(inv))


def engine_state_from_numpy(engine, hashes_u64, counts_u32, retained_u64=None,
                            retained_counts=None, inc=None,
                            n_reads: int = 0) -> None:
    """Load a count table, an optional retained band and an optional
    incidence into a port ``Engine``, replacing its state."""
    dev = engine.device
    engine.table = table_from_numpy(hashes_u64, counts_u32, dev)
    engine.n_reads_counted = n_reads
    engine.retained_hashes = None if retained_u64 is None \
        else keys_from_numpy(retained_u64, dev)
    engine.retained_counts = None if retained_counts is None \
        else torch.from_numpy(np.asarray(retained_counts)
                              .astype(np.int32)).to(dev)
    engine.inc = None if inc is None else incidence_from_numpy(inc, dev)


def labels_from_numpy(labels, device) -> torch.Tensor:
    """The JAX package's flat cluster labels (int32, aligned with the
    forward CSR) as the port's int64 label tensor."""
    return torch.from_numpy(np.asarray(labels).astype(np.int64)).to(device)


def keys_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """Real int64 keys (``INT64_MAX`` pads dropped) as host uint64."""
    k = keys.cpu().numpy()
    k = k[k != np.iinfo(np.int64).max]
    if len(k) and int(k.min()) < 0:
        raise ValueError("negative key")
    return k.astype(np.uint64)


def to_numpy(t: torch.Tensor, dtype, what: str) -> np.ndarray:
    """A host array of ``dtype``; raises if a value falls outside its range."""
    a = t.cpu().numpy()
    info = np.iinfo(dtype)
    if a.size and (int(a.min()) < info.min or int(a.max()) > info.max):
        raise ValueError(f"{what} do not fit {np.dtype(dtype).name}")
    return a.astype(dtype)


def incidence_to_numpy(inc: Incidence, prefix: str) -> dict:
    """The four CSR arrays of ``inc`` under ``prefix`` (``inc_`` or
    ``split_``), in the JAX ``Incidence`` dtypes; ``inv2fwd`` is not kept."""
    return {prefix + name: to_numpy(getattr(inc, name), dtype,
                                    f"incidence {name}")
            for name, dtype in _INC_FIELDS}


def incidence_from_npz(z, prefix: str, shape, device) -> Incidence:
    """A port Incidence from a checkpoint's ``prefix`` arrays and its
    ``[n_kmers, n_codes]`` shape; ``inv2fwd`` is rebuilt where needed."""
    n_kmers, n_codes = shape

    def t(name):
        return torch.from_numpy(z[prefix + name].astype(np.int64)).to(device)
    return Incidence(int(n_kmers), int(n_codes), t("code_offsets"),
                     t("code_kmers"), t("kmer_offsets"), t("kmer_codes"))


# -- sharded state: the JAX package's per-shard (n, C) arrays <-> the port's
# per-local-shard tensors (this process's rows of a ShardGroup) -------------------

def _rows_to_numpy(group, rows, dtype, pad, what) -> np.ndarray:
    """(n, W) host array of every shard's 1-D rows (a collective)."""
    g = group.all_gather_rows(group.stack_padded(rows, -1), pad=-1)
    g = g.cpu().numpy()
    out = np.full(g.shape, pad, dtype)
    real = g >= 0
    if real.any() and int(g[real].max()) > np.iinfo(dtype).max:
        raise ValueError(f"{what} do not fit {np.dtype(dtype).name}")
    out[real] = g[real].astype(dtype)
    return out


def sharded_table_from_numpy(hashes_u64: np.ndarray, counts_u32: np.ndarray,
                             group, spec=None, routing: str = "range",
                             range_eff=None):
    """A port ShardedSortedTable holding row s of the JAX package's (n, C)
    ``hashes``/``counts`` in shard s (U64MAX pads dropped)."""
    from .dist.sharded_sorted import ShardedSortedTable
    t = ShardedSortedTable(group, 1, 1, spec=spec, routing=routing,
                           range_eff=range_eff)
    for i in range(group.n_local):
        s = group.lo + i
        t.rows[i] = table_from_numpy(hashes_u64[s], counts_u32[s],
                                     group.device)
    return t


def sharded_table_to_numpy(t):
    """The JAX package's (n, C) uint64 hashes (U64MAX pads) and uint32
    counts of a port ShardedSortedTable, every shard (a collective)."""
    t.flush()
    rows = [t.local_compact(i) for i in range(len(t.rows))]
    return (_rows_to_numpy(t.group, [r[0] for r in rows], np.uint64,
                           np.uint64(U64MAX), "hashes"),
            _rows_to_numpy(t.group, [r[1] for r in rows], np.uint32, 0,
                           "counts"))


def retained_sharded_from_numpy(ret_sh, group):
    """The JAX engine's ``_ret_sh`` (rows (n, R) uint64, counts (n, R),
    offsets (n,), total) as the port engine's (this process's rows, counts,
    offsets, total)."""
    rows, crows, off, n = ret_sh
    rows, crows = np.asarray(rows), np.asarray(crows)
    h, c = [], []
    for s in range(group.lo, group.hi):
        real = rows[s] != np.uint64(U64MAX)
        h.append(keys_from_numpy(rows[s][real], group.device))
        c.append(torch.from_numpy(crows[s][real].astype(np.int32))
                 .to(group.device))
    return h, c, np.asarray(off, np.int64), int(n)


def retained_sharded_to_numpy(ret_sh, group):
    """The port engine's sharded retained set as (rows (n, R) uint64 with
    U64MAX pads, counts (n, R) uint32, offsets, total) (a collective)."""
    h, c, off, n = ret_sh
    return (_rows_to_numpy(group, h, np.uint64, np.uint64(U64MAX), "hashes"),
            _rows_to_numpy(group, c, np.uint32, 0, "counts"), off, n)


def sharded_incidence_from_numpy(keys_u64: np.ndarray, pair_counts,
                                 n_kmers: int, n_codes: int, group,
                                 code_bounds=None):
    """A port ShardedIncidence from the JAX one's (n, Ppad) uint64 keys
    (U64MAX pads) and per-shard pair counts."""
    from .dist.sharded_inc import ShardedIncidence
    keys = [keys_from_numpy(keys_u64[s], group.device)
            for s in range(group.lo, group.hi)]
    return ShardedIncidence(group, keys, np.asarray(pair_counts, np.int64),
                            n_kmers, n_codes, code_bounds=code_bounds)


def sharded_incidence_to_numpy(inc_sh):
    """(keys (n, Ppad) uint64 with U64MAX pads, pair counts (n,)) of a port
    ShardedIncidence (a collective)."""
    return (_rows_to_numpy(inc_sh.group, inc_sh.keys, np.uint64,
                           np.uint64(U64MAX), "pair keys"),
            inc_sh.pair_counts.copy())
