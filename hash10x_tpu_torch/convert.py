"""Host state in, port state out: numpy count tables, incidences and engine
state (the JAX package's layout, uint64 keys with U64MAX pads) become the
port's int64 torch state on a chosen device.

This system has no weights: its state is the count table, the retained
count band and the incidence.  The per-phase tests load the JAX engine's
state through these functions so each phase of the port is compared on the
same inputs; checkpoint save/load will use the same seam.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashspec import U64MAX
from .table import sorted_table as st
from .table.incidence import Incidence

__all__ = ["keys_from_numpy", "table_from_numpy", "incidence_from_numpy",
           "engine_state_from_numpy"]


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
