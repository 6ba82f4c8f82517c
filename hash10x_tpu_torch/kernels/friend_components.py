"""Friend-components kernel wrapper: the connected components of
capped-friend clustering's bipartite (k-mer, friend) graph, one barcode row
at a time, in one pass over each row's membership mask, on CUDA tensors.

Replaces no TPU kernel: the JAX package propagates labels over the
(B, K, F) mask in rounds of a ``where`` and a ``min``
(``hash10x_tpu/cluster/cooccur.py`` ``friend_union_batch``), and the plain
version is the port's same rounds (``cluster/cooccur.py``
``_friend_rounds`` on CPU tensors), which reach the same fixpoint: each
valid k-mer's component minimum index, K for a pad.  The CUDA source is
``csrc/friend_components.cu``; its header says what bounds it on an H100
(each valid k-mer's F mask cells read once, the labels written once) and
what the design does about it: a block a row, the row's K + F parents in
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

SOURCE = CSRC / "friend_components.cu"

# shared memory one block of an H100 may take (227 KB, opted in), less the
# kernel's static shared memory
SMEM_LIMIT = 232_448 - 16

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = library(SOURCE)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.h10x_friend_components.argtypes = [
            ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
        lib.h10x_friend_components.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(K: int, F: int) -> int:
    """Dynamic shared memory of one block at ``K`` k-mers and ``F``
    friends: the int32 parents of the K + F nodes and the k-mers' byte
    flags, 16-byte rounded (``smem_bytes`` of the source)."""
    return (4 * (K + F) + K + 15) // 16 * 16


def bound(n_valid, K: int, F: int):
    """(bytes, bound_ms) of one call on rows of ``n_valid`` valid k-mers
    each (a sequence of ints) at ``K`` k-mers and ``F`` friends: each valid
    k-mer's F mask cells read once (a byte a cell), each row's flags read
    once and its int64 labels written once, at the H100's 3.35 TB/s."""
    nbytes = F * sum(n_valid) + 9 * K * len(n_valid)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def components(m: torch.Tensor, valid: torch.Tensor):
    """``(labels, hooks)`` of the rows of the membership mask ``m (B, K,
    F)`` bool (contiguous; ``cooccur._membership``) and ``valid (B, K)``
    bool: a valid k-mer's label is the smallest valid k-mer index of its
    component under the links of ``m``'s set cells between valid k-mers and
    friends, a pad's is K (int64, (B, K)); ``hooks (1,) int64`` is the
    links made (the valid k-mers and the friends they touch, less the
    components), on the device, unread.  One kernel launch on the current
    stream, no host sync."""
    if m.dtype != torch.bool or m.dim() != 3:
        raise ValueError("friend components: m must be a bool (B, K, F) "
                         "tensor")
    if valid.dtype != torch.bool or valid.shape != m.shape[:2]:
        raise ValueError("friend components: valid must be a bool (B, K) "
                         "tensor of m's rows")
    B, K, F = m.shape
    if smem_bytes(K, F) > SMEM_LIMIT:
        raise ValueError(f"friend components: K = {K}, F = {F} need "
                         f"{smem_bytes(K, F)} bytes of shared memory a "
                         f"block, past the {SMEM_LIMIT} an H100 block has")
    if m.device != valid.device:
        raise ValueError("friend components: m and valid must be on one "
                         "device")
    if not m.is_contiguous():
        raise ValueError("friend components: m must be contiguous")
    if m.device.type != "cuda":
        raise ValueError(f"friend components: unsupported device "
                         f"{m.device}")
    global LAUNCHES
    lib = build()
    valid = valid.contiguous()
    labels = torch.empty((B, K), dtype=torch.int64, device=m.device)
    hooks = torch.empty(1, dtype=torch.int64, device=m.device)  # zeroed there
    with torch.cuda.device(m.device):
        rc = lib.h10x_friend_components(
            m.data_ptr(), valid.data_ptr(), B, K, F, labels.data_ptr(),
            hooks.data_ptr(),
            torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"friend components kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return labels, hooks
