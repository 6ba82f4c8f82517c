"""The sketch's least time on the card, from the lane alone (whatever
implements the kernel): a frozen copy of the arithmetic of the port's
``kernels/minimizer.py``, counted from the lane and not from the kernel's
slots or tiles.

* Bytes: every read's packed words and its length read once, and every
  emitted minimizer's hash (8 B) written once.
* Operations: ``OPS_PER_HASH`` integer operations per k-mer position.
* Peaks of an NVIDIA H100 SXM: 3.35 TB/s of device memory (published), and
  132 SMs x 64 INT32 lanes x 1.98 GHz integer operations per second
  (derived, not published).
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "OPS_PER_HASH",
           "sketch_work", "least_seconds"]

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_HASH = 20   # a canonical hash: 2 64-bit multiplies at 4, 2 64-bit
#                     shifts at 2, the 64-bit compare and select at 4, the
#                     forward and reverse-complement roll at 4


def sketch_work(n_reads: int, read_len: int, k: int, emitted: int):
    """(bytes, operations) of one sketch of a lane of ``n_reads`` reads of
    ``read_len`` bases that emits ``emitted`` minimizers."""
    words = (read_len + 15) // 16
    nbytes = n_reads * (4 * words + 4) + 8 * emitted
    ops = OPS_PER_HASH * n_reads * (read_len - k + 1)
    return nbytes, ops


def least_seconds(nbytes: int, ops: int):
    """(seconds, what bounds them: "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to), "bytes" if tb >= to else "operations"
