"""Unique / dense-rank helpers on a torch device — the port of
``hash10x_tpu/utils/dense.py``.  On a GPU the sort plus gathers is the
natural form; the JAX package's gather-free merge joins were TPU
workarounds."""

from __future__ import annotations

import torch

from . import timing

__all__ = ["distinct_below", "device_unique", "device_dense_ranks"]


def distinct_below(s: torch.Tensor, is_new: torch.Tensor, q: torch.Tensor
                   ) -> torch.Tensor:
    """For each query in ``q``: the number of distinct values of the
    ascending ``s`` strictly below it (``is_new`` marks the first element of
    each run of equal values in ``s``)."""
    if s.shape[0] == 0:
        return torch.zeros_like(q)
    dense = torch.cumsum(is_new.to(torch.int64), 0)
    idx = torch.searchsorted(s, q)
    return torch.where(idx > 0, dense[torch.clamp(idx - 1, min=0)], 0)


def device_unique(values: torch.Tensor, return_counts: bool = False):
    """Sorted distinct values (and their counts) of an integer tensor."""
    timing.add("sorted_keys", values.shape[0])
    with timing.wait("dense.unique"):
        return torch.unique(values, sorted=True, return_counts=return_counts)


def device_dense_ranks(values: torch.Tensor) -> torch.Tensor:
    """Rank of each element among the sorted distinct values."""
    timing.add("sorted_keys", values.shape[0])
    with timing.wait("dense.unique"):
        return torch.unique(values, sorted=True, return_inverse=True)[1]
