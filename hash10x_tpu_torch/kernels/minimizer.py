"""Sketch kernel wrapper: the CUDA kernel on CUDA tensors, the plain torch
version on CPU tensors.

Replaces the TPU kernel of ``hash10x_tpu/kernels/minimizer_pallas.py``
(``_make_kernel``, launched through ``pl.pallas_call`` at :403 and exposed as
``sketch``/``sketch_minimizer_compact``).  The CUDA source is
``csrc/minimizer.cu``; its header says what bounds it on an H100 (bytes: one
read of each base, one write of each output slot) and what the design does
about it: a warp per tile of a row, the tile's bases staged in shared memory
with 16-byte loads, hashes rolled position-parallel into shared memory, and
coalesced stores (compacted rows ranked with a warp ballot).

``sketch`` launches the kernel for a CUDA tensor and raises when it cannot;
it never gives way to the plain version there.  ``sketch_plain`` is the same
function in plain torch (``core/seqhash.py`` plus an in-order compaction)
and serves CPU tensors.  ``LAUNCHES`` counts kernel calls and
``PLAIN_CALLS`` counts plain-version calls made by ``sketch``.  A call made
while a CUDA graph is being captured launches nothing: it counts in
``CAPTURED``, and each replay of the graph adds the launches it recorded to
``LAUNCHES`` (``count_replay``).
``sketch_minimizer``, ``sketch_minimizer_compact`` and ``supported`` keep
the JAX module's entry points; ``sketch_bound`` is the least time an H100
could take for one call, the yardstick of ``chip_smoke.py``.

The kernel is built with ``nvcc`` for ``sm_90a`` into ``_build/`` (ignored by
git) at first use, keyed by a hash of the source, and loaded with ctypes.
It runs every mode of ``seqhash.sketch`` (``KERNEL_MODES``) for any batch
size and any ``w``: minimizer windows wider than the tile kernel's
(``h10x_max_tile_w``, 4096) take the wide route, three position-parallel
passes (hashes, window argmins over blocks of w positions, compaction)
whose (B, P) scratch grids the wrapper allocates.  One ``sketch`` call
counts one launch in ``LAUNCHES`` however many CUDA launches it makes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import INT64_MAX
from ..core import seqhash
from ..hashspec import HashSpec
from .nvcc import CSRC, HBM_BYTES_PER_S, NVCC_FLAGS, library

__all__ = ["sketch", "sketch_plain", "sketch_minimizer",
           "sketch_minimizer_compact", "supported", "sketch_bound", "launcher",
           "build", "count_replay", "LAUNCHES", "PLAIN_CALLS", "CAPTURED",
           "KERNEL_MODES", "NVCC_FLAGS",
           "HBM_BYTES_PER_S", "INT32_OPS_PER_S", "OPS_PER_HASH"]

LAUNCHES = 0
PLAIN_CALLS = 0
CAPTURED = 0

KERNEL_MODES = {"kmer": 0, "minimizer": 1, "modimizer": 2, "syncmer": 3}

# 32-bit integer operations per second: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (the float32 row's 67 TFLOP/s counts 128 lanes and two per FMA)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_HASH = 20  # a canonical hash: 2 64-bit multiplies at 4, 2 64-bit
#                    shifts at 2, the 64-bit compare and select at 4, the
#                    forward and reverse-complement roll at 4

SOURCE = CSRC / "minimizer.cu"

_lib = None
_max_tile_w = 0  # widest tile-kernel minimizer window, set by build()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _max_tile_w
    if _lib is not None:
        return _lib
    lib = library(SOURCE)
    fn = lib.h10x_sketch
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    fn.argtypes = [ptr, ptr, i32, i32, i32, i32, u64, i32, i32, u64, i32,
                   u64, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    lib.h10x_max_tile_w.restype = ctypes.c_int
    _max_tile_w = lib.h10x_max_tile_w()
    _lib = lib
    return _lib


def sketch_plain(spec: HashSpec, codes: torch.Tensor, lengths: torch.Tensor,
                 mode: str = "minimizer", compact_to: int = 0, m: int = 0,
                 syncmer_s: int = 0):
    """Plain torch sketch with the kernel's outputs.

    Returns ``(hashes, is_forward, emit, overflow)``.  With ``compact_to=0``
    the first three are dense (B, P) grids (hashes of every valid position,
    ``INT64_MAX`` elsewhere) and ``overflow`` is zero.  With ``compact_to=C``
    each read's emissions move to the front of a (B, C) row in ascending
    position order, ``INT64_MAX`` pads follow, and ``overflow (B,) int32``
    counts the emissions past C exactly."""
    h, fwd, emit = seqhash.sketch(spec, codes, lengths, mode=mode, m=m,
                                  syncmer_s=syncmer_s)
    B = h.shape[0]
    dev = h.device
    if not compact_to:
        return h, fwd, emit, torch.zeros(B, dtype=torch.int32, device=dev)
    C = compact_to
    rank = torch.cumsum(emit.to(torch.int64), dim=1) - 1
    slot = torch.where(emit & (rank < C), rank, C)  # column C is discarded
    out_h = torch.full((B, C + 1), INT64_MAX, dtype=torch.int64, device=dev)
    out_h.scatter_(1, slot, torch.where(emit, h, INT64_MAX))
    out_f = torch.zeros((B, C + 1), dtype=torch.bool, device=dev)
    out_f.scatter_(1, slot, fwd & emit)
    hashes = out_h[:, :C].contiguous()
    overflow = torch.clamp(emit.sum(dim=1) - C, min=0).to(torch.int32)
    return hashes, out_f[:, :C].contiguous(), hashes != INT64_MAX, overflow


def supported(spec: HashSpec, codes_shape, mode: str = "minimizer",
              m: int = 0, syncmer_s: int = 0) -> bool:
    """Whether the kernel takes a (B, L) batch in this mode (``sketch``
    raises ``ValueError`` on CUDA tensors otherwise).  Wider than the Pallas
    kernel's domain: any B, reads shorter than k + w - 1, any w, a
    modimizer modulus in [1, 2^63)."""
    B, L = codes_shape
    if mode not in KERNEL_MODES or B < 0 or L - spec.k + 1 < 1:
        return False
    if mode == "modimizer":
        return 1 <= (m or spec.w) < (1 << 63)
    if mode == "syncmer":
        return 0 < syncmer_s < spec.k
    return True


def sketch_minimizer(spec: HashSpec, codes: torch.Tensor,
                     lengths: torch.Tensor):
    """Minimizer sketch as dense (B, P) rows: ``(hashes, is_forward,
    emit)``, ``INT64_MAX`` at positions without a valid k-mer."""
    return sketch(spec, codes, lengths)[:3]


def sketch_minimizer_compact(spec: HashSpec, codes: torch.Tensor,
                             lengths: torch.Tensor, compact_to: int):
    """Minimizer sketch with each read's emissions moved to the front of a
    (B, ``compact_to``) row in position order: ``(hashes, is_forward, emit,
    overflow)``, overflow counting the emissions past ``compact_to``."""
    return sketch(spec, codes, lengths, compact_to=compact_to)


def sketch_bound(B: int, L: int, R: int, k: int, mode: str = "minimizer",
                 s: int = 0):
    """(bytes, operations, bound_ms, bound_by) of one sketch call of B reads
    of L bases into R output slots per read: each base and length read
    once, each output slot (int64 hash, flags byte) and overflow count
    written once; a lower count of the integer work (every k-mer position
    hashed, syncmer's s-mers hashed and k - s compares per position,
    minimizer's 2 compares per position)."""
    P = L - k + 1
    nbytes = B * L + 4 * B + B * R * 9 + 4 * B
    ops = B * P * OPS_PER_HASH
    if mode == "syncmer":
        ops += B * (L - s + 1) * OPS_PER_HASH + B * P * (k - s) * 2
    elif mode == "minimizer":
        ops += B * P * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (nbytes, ops, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def launcher(spec: HashSpec, codes: torch.Tensor, lengths: torch.Tensor,
             mode: str = "minimizer", compact_to: int = 0, m: int = 0,
             syncmer_s: int = 0):
    """A function that makes one kernel launch on the CUDA batch (codes,
    lengths) into outputs allocated once here: the kernel alone, without
    the wrapper's allocations and flag conversions, for timing it."""
    B, L = codes.shape
    R = compact_to or L - spec.k + 1
    dev = codes.device
    out = (torch.empty((B, R), dtype=torch.int64, device=dev),
           torch.empty((B, R), dtype=torch.uint8, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))
    return lambda: _launch(spec, codes, lengths, out, mode, compact_to, m,
                           syncmer_s)


def count_replay(n: int) -> None:
    """Count the ``n`` kernel launches that one replay of a CUDA graph makes
    (the launches its capture added to ``CAPTURED``)."""
    global LAUNCHES
    LAUNCHES += n


def sketch(spec: HashSpec, codes: torch.Tensor, lengths: torch.Tensor,
           mode: str = "minimizer", compact_to: int = 0, m: int = 0,
           syncmer_s: int = 0):
    """Sketch a batch: ``codes (B, L) uint8``, ``lengths (B,) int32``.

    Same arguments and outputs as :func:`sketch_plain`: ``m`` is the
    modimizer modulus (0 = ``w``), ``syncmer_s`` the syncmer s-mer size.
    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream or raise ``ValueError`` on what it does not take."""
    global PLAIN_CALLS
    if codes.device.type == "cpu":
        PLAIN_CALLS += 1
        return sketch_plain(spec, codes, lengths, mode=mode,
                            compact_to=compact_to, m=m, syncmer_s=syncmer_s)
    if codes.device.type != "cuda":
        raise ValueError(f"sketch: unsupported device {codes.device}")
    if mode not in KERNEL_MODES:
        raise ValueError(f"unknown sketch mode {mode!r} (kernel modes: "
                         f"{sorted(KERNEL_MODES)})")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a (B, L) uint8 tensor")
    if lengths.dtype != torch.int32 or lengths.shape != codes.shape[:1]:
        raise ValueError("lengths must be a (B,) int32 tensor")
    if lengths.device != codes.device:
        raise ValueError("codes and lengths must be on one device")
    if compact_to < 0:
        raise ValueError("compact_to must be >= 0")
    B, L = codes.shape
    P = L - spec.k + 1
    if P < 1:
        raise ValueError(f"read length {L} < k {spec.k}")
    codes = codes.contiguous()
    lengths = lengths.contiguous()
    dev = codes.device
    R = compact_to or P
    out = (torch.empty((B, R), dtype=torch.int64, device=dev),
           torch.empty((B, R), dtype=torch.uint8, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))
    _launch(spec, codes, lengths, out, mode, compact_to, m, syncmer_s)
    out_h, out_f, over = out
    return out_h, (out_f & 2) != 0, (out_f & 1) != 0, over


def _launch(spec: HashSpec, codes: torch.Tensor, lengths: torch.Tensor, out,
            mode: str, compact_to: int, m: int, syncmer_s: int) -> None:
    """One kernel call (one count in ``LAUNCHES``, or in ``CAPTURED`` while
    a CUDA graph is captured; the wide route's three passes are one call)
    on :func:`sketch`'s checked, contiguous CUDA inputs into ``out`` =
    (hashes (B, R) int64, flags (B, R) uint8 with bit 0 emitted and bit 1
    forward, overflow (B,) int32).  It launches on the current stream and
    makes no other stream call, so a CUDA graph can record it."""
    global LAUNCHES, CAPTURED
    modulus = (m or spec.w) if mode == "modimizer" else 0
    if mode == "modimizer" and not 1 <= modulus < (1 << 63):
        raise ValueError(f"modimizer modulus must be in [1, 2^63), got {modulus}")
    sub = seqhash.smer_spec(spec, syncmer_s) if mode == "syncmer" else None
    lib = build()
    B, L = codes.shape
    P = L - spec.k + 1
    dev = codes.device
    out_h, out_f, over = out
    scratch = [None, None, None]  # window args; hashes, flags if compacting
    if mode == "minimizer" and spec.w > _max_tile_w:
        scratch[0] = torch.empty((B, P), dtype=torch.int32, device=dev)
        if compact_to:
            scratch[1] = torch.empty((B, P), dtype=torch.int64, device=dev)
            scratch[2] = torch.empty((B, P), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.h10x_sketch(
        codes.data_ptr(), lengths.data_ptr(), B, L, spec.k, spec.w,
        spec.factor1, spec.shift1, KERNEL_MODES[mode], modulus,
        syncmer_s if sub else 0, sub.factor1 if sub else 0,
        sub.shift1 if sub else 0, compact_to,
        *(t.data_ptr() if t is not None else None for t in scratch),
        out_h.data_ptr(), out_f.data_ptr(), over.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sketch kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
