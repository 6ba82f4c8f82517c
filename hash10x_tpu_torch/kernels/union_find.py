"""Union-find kernel wrapper: the connected components of friend
clustering's bipartite (position, friend) graph, in one sweep over the edges,
on CUDA tensors.

Replaces no TPU kernel: the JAX package propagates labels in rounds of
``jax.ops.segment_min`` (``hash10x_tpu/cluster/sparse.py`` ``_propagate``),
and the plain version is the port's rounds of ``scatter_reduce_(amin)``
(``cluster/sparse.py`` ``propagate_labels`` on CPU tensors), which reach the
same fixpoint: each position's component minimum position.  The CUDA source
is ``csrc/union_find.cu``; its header says what bounds it on an H100 (16
bytes an edge streamed once, and random parent sectors) and what the design
does about it: both ends' parents loaded together, path halving, a CAS hook
of the larger root under the smaller.

:func:`components_of_blocks` launches the kernel on a list of edge blocks
(CUDA tensors; the sharded path's per-shard blocks, hooked into one parent
array without being joined) and raises on what it does not take;
:func:`components` is its one-block case.  Parents are int32 when the nodes
(positions and friend ranks) number under 2^31, else int64: the width
follows the node count.  ``LAUNCHES`` counts kernel calls (a call is an
init launch, a hook launch per block that holds edges and a finalise
launch, with no host sync between them).  The library is built with
``nvcc`` for ``sm_90a`` into ``_build/`` at first use
(``kernels/nvcc.py``), keyed by a hash of the source, and loaded with
ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from .nvcc import CSRC, HBM_BYTES_PER_S, library

__all__ = ["components", "components_of_blocks", "bound", "build",
           "LAUNCHES", "SOURCE"]

LAUNCHES = 0

SOURCE = CSRC / "union_find.cu"

_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = library(SOURCE)
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.h10x_union_find.argtypes = [
            ctypes.POINTER(ptr), ctypes.POINTER(ptr), ctypes.POINTER(i64),
            ctypes.c_int, i64, i64, ctypes.c_int, ptr, ptr, ptr, ptr]
        lib.h10x_union_find.restype = ctypes.c_int
        _lib = lib
    return _lib


def bound(n_edges: int, n_p: int):
    """(bytes, bound_ms) of one call: each edge (two int64) read once and
    each position's int64 label written once, at the H100's 3.35 TB/s."""
    nbytes = 16 * n_edges + 8 * n_p
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def components(p_e: torch.Tensor, f_e: torch.Tensor, n_p: int, n_f: int):
    """Labels of the bipartite graph whose edges join position ``p_e[i]``
    (in [0, n_p)) and friend rank ``f_e[i]`` (in [0, n_f)): the one-block
    case of :func:`components_of_blocks`."""
    return components_of_blocks([(p_e, f_e)], n_p, n_f)


def components_of_blocks(blocks, n_p: int, n_f: int):
    """Labels of the bipartite graph whose edges are those of every block
    ``(p_e, f_e)`` of ``blocks``, each joining position ``p_e[i]`` (in [0,
    n_p)) and friend rank ``f_e[i]`` (in [0, n_f)): ``(labels, hooks)``,
    ``labels (n_p,) int64`` each position's smallest connected position,
    ``hooks (1,) int64`` the links the sweep made over all blocks (the node
    count less the component count), on the device, unread.  One or more
    blocks of CUDA int64 edge vectors, the two of a block of one length,
    all on one device; one kernel call on the current stream.  An edge out
    of range stops the kernel with a device-side trap."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("union-find kernel: no edge blocks")
    dev = blocks[0][0].device
    for p_e, f_e in blocks:
        if p_e.dtype != torch.int64 or f_e.dtype != torch.int64 \
                or p_e.dim() != 1 or p_e.shape != f_e.shape:
            raise ValueError("p_e and f_e must be int64 vectors of one "
                             "length")
        if p_e.device != dev or f_e.device != dev:
            raise ValueError("edge blocks must be on one device")
    if dev.type != "cuda":
        raise ValueError(f"union-find kernel: unsupported device {dev}")
    if n_p < 0 or n_f < 0:
        raise ValueError("n_p and n_f must be >= 0")
    return _sweep([(p.contiguous(), f.contiguous()) for p, f in blocks],
                  n_p, n_f, wide=n_p + n_f >= 1 << 31)


def _launch(p_e: torch.Tensor, f_e: torch.Tensor, n_p: int, n_f: int,
            wide: bool):
    """One kernel call on one checked, contiguous block, with int64 parents
    where ``wide``, else int32."""
    return _sweep([(p_e, f_e)], n_p, n_f, wide)


def _sweep(blocks, n_p: int, n_f: int, wide: bool):
    """One kernel call on :func:`components_of_blocks`' checked, contiguous
    blocks, with int64 parents where ``wide``, else int32."""
    global LAUNCHES
    lib = build()
    dev = blocks[0][0].device
    parent = torch.empty(n_p + n_f, device=dev,
                         dtype=torch.int64 if wide else torch.int32)
    labels = torch.empty(n_p, dtype=torch.int64, device=dev)
    hooks = torch.empty(1, dtype=torch.int64, device=dev)   # zeroed by init
    if n_p == 0:
        return labels, hooks.zero_()
    n = len(blocks)
    p_ptrs = (ctypes.c_void_p * n)(*(p.data_ptr() for p, _ in blocks))
    f_ptrs = (ctypes.c_void_p * n)(*(f.data_ptr() for _, f in blocks))
    sizes = (ctypes.c_longlong * n)(*(p.shape[0] for p, _ in blocks))
    with torch.cuda.device(dev):
        rc = lib.h10x_union_find(
            p_ptrs, f_ptrs, sizes, n, n_p, n_f, int(wide), parent.data_ptr(),
            labels.data_ptr(), hooks.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"union-find kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return labels, hooks
