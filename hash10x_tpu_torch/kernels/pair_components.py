"""Pair-components kernel wrapper: the connected components of pair
clustering's k-mer graph, one barcode row at a time, in one pass over each
row's support matrix, on CUDA tensors.

Replaces no TPU kernel: the JAX package thresholds the support into a dense
(B, K, K) adjacency and propagates labels in rounds of a ``where`` and a
``min`` over it (``hash10x_tpu/cluster/cooccur.py`` ``cluster_batch``), and
the plain version is the port's same rounds (``cluster/cooccur.py``
``_pair_rounds`` on CPU tensors), which reach the same fixpoint: each valid
k-mer's component minimum index, K for a pad.  The CUDA source is
``csrc/pair_components.cu``; its header says what bounds it on an H100 (one
triangle of each row's valid block of S read once, the labels written once)
and what the design does about it: a block a row, the row's parents in
shared memory, path halving, a CAS hook of the larger root under the
smaller.

:func:`components` launches the kernel (one launch a call, counted in
``LAUNCHES``) and raises on what it does not take.  The library is built
with ``nvcc`` for ``sm_90a`` into ``_build/`` at first use
(``kernels/nvcc.py``), keyed by a hash of the source, and loaded with
ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from .nvcc import CSRC, HBM_BYTES_PER_S, library

__all__ = ["components", "bound", "smem_bytes", "build", "LAUNCHES",
           "SOURCE", "SMEM_LIMIT"]

LAUNCHES = 0

SOURCE = CSRC / "pair_components.cu"

# shared memory one block of an H100 may take (227 KB, opted in), less the
# kernel's static shared memory
SMEM_LIMIT = 232_448 - 16

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = library(SOURCE)
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.h10x_pair_components.argtypes = [
            ptr, ptr, i64, ctypes.c_int, ctypes.c_float, ptr, ptr, ptr]
        lib.h10x_pair_components.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(K: int) -> int:
    """Dynamic shared memory of one block at width ``K``: the int32
    parents and the byte flags, 16-byte rounded (``smem_bytes`` of the
    source)."""
    return (5 * K + 15) // 16 * 16


def bound(n_valid, K: int):
    """(bytes, bound_ms) of one call on rows of ``n_valid`` valid k-mers
    each (a sequence of ints) at width ``K``: each row's upper triangle of
    S over its valid block read once (4 bytes a cell), its flags read once
    and its int64 labels written once, at the H100's 3.35 TB/s."""
    cells = sum(n * (n - 1) // 2 for n in n_valid)
    nbytes = 4 * cells + 9 * K * len(n_valid)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def components(s: torch.Tensor, valid: torch.Tensor, min_share: int):
    """``(labels, hooks)`` of the rows of ``s (B, K, K)`` float32 (the
    support matrix: contiguous, symmetric) and ``valid (B, K)`` bool: a
    valid k-mer's label is the smallest valid k-mer index of its component
    under the links S - 1 >= ``min_share`` between valid k-mers, a pad's is
    K (int64, (B, K)); ``hooks (1,) int64`` is the links made (the valid
    k-mers less the components), on the device, unread.  One kernel launch
    on the current stream, no host sync."""
    if s.dtype != torch.float32 or s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError("pair components: s must be a float32 (B, K, K) "
                         "tensor")
    if valid.dtype != torch.bool or valid.shape != s.shape[:2]:
        raise ValueError("pair components: valid must be a bool (B, K) "
                         "tensor of s's rows")
    K = s.shape[1]
    if smem_bytes(K) > SMEM_LIMIT:
        raise ValueError(f"pair components: K = {K} needs "
                         f"{smem_bytes(K)} bytes of shared memory a block, "
                         f"past the {SMEM_LIMIT} an H100 block has")
    if s.device != valid.device:
        raise ValueError("pair components: s and valid must be on one "
                         "device")
    if s.device.type != "cuda":
        raise ValueError(f"pair components: unsupported device {s.device}")
    if not s.is_contiguous():
        raise ValueError("pair components: s must be contiguous")
    global LAUNCHES
    lib = build()
    B = s.shape[0]
    valid = valid.contiguous()
    labels = torch.empty((B, K), dtype=torch.int64, device=s.device)
    hooks = torch.empty(1, dtype=torch.int64, device=s.device)  # zeroed there
    with torch.cuda.device(s.device):
        rc = lib.h10x_pair_components(
            s.data_ptr(), valid.data_ptr(), B, K, float(min_share),
            labels.data_ptr(), hooks.data_ptr(),
            torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair components kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return labels, hooks
