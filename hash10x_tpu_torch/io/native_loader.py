"""ctypes bridge to the native FASTQ loader (``native/loader/h10x_loader.c``,
shared with the JAX package and compiled as it stands) — the port of
``hash10x_tpu/io/native_loader.py``.

The library is built with gcc (OpenMP and zlib where the host has them) on
first use into ``hash10x_tpu_torch/_build/`` beside the sketch kernel, keyed
by a hash of the source.  Without a compiler, ``load_fastq_native`` returns
None and ``io.fqb.fastq_to_fqb`` takes the numpy parser, as in the JAX
package.  Both give the same ``Fqb``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "build", "load_fastq_native", "SOURCE"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "loader" / "h10x_loader.c"
BUILD_DIR = _PKG / "_build"
# flag sets tried in order: OpenMP + zlib, OpenMP, plain
_VARIANTS = (["-O3", "-march=native", "-fopenmp", "-DH10X_HAVE_ZLIB", "-lz"],
             ["-O3", "-march=native", "-fopenmp"],
             ["-O3"])

_lib = None
_tried = False


def _compile(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for flags in _VARIANTS:
            try:
                r = subprocess.run(["gcc", "-shared", "-fPIC", "-o", tmp,
                                    str(SOURCE), *flags], capture_output=True)
            except OSError:       # no gcc on this host
                return False
            if r.returncode == 0:
                os.replace(tmp, so)
                return True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build() -> Optional[ctypes.CDLL]:
    """Compile (once per source hash) and load the loader; None when the
    source or a working gcc is missing."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SOURCE.exists():
        return None
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"h10x_loader_{tag}.so"
    if not so.exists() and not _compile(so):
        return None
    lib = ctypes.CDLL(str(so))
    long_p = ctypes.POINTER(ctypes.c_long)
    lib.h10x_count_records.restype = ctypes.c_long
    lib.h10x_count_records.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.h10x_seq_offsets.restype = ctypes.c_long
    lib.h10x_seq_offsets.argtypes = [ctypes.c_char_p, ctypes.c_long, long_p,
                                     long_p, ctypes.c_long]
    lib.h10x_pack.restype = ctypes.c_long
    lib.h10x_pack.argtypes = [
        ctypes.c_char_p, long_p, long_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
    if hasattr(lib, "h10x_gz_read"):
        lib.h10x_gz_read.restype = ctypes.c_long
        lib.h10x_gz_read.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_void_p)]
        lib.h10x_free.restype = None
        lib.h10x_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return build() is not None


def load_fastq_native(path, bc_len: int = 16, max_len: int = 0
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                          int, Optional[np.ndarray]]]:
    """FASTQ file -> (packed (N, W) u32, lengths (N,) i32, barcode keys
    (N,) u32, read_len, nmask (N, ceil(L/32)) u32 or None when the lane has
    no Ns), or None when the library is unavailable.  ``max_len`` is the
    post-barcode genomic length (0: the longest read).  Plain and ``.gz``
    inputs are read by the library itself when it has zlib."""
    lib = build()
    if lib is None:
        return None
    p = str(path)
    if hasattr(lib, "h10x_gz_read"):
        ptr = ctypes.c_void_p()
        n = lib.h10x_gz_read(p.encode(), ctypes.byref(ptr))
        if n < 0:
            raise OSError(f"{p}: cannot open/decompress")
        try:
            return _parse_buffer(lib, ctypes.cast(ptr, ctypes.c_char_p), n,
                                 bc_len, max_len, p)
        finally:
            lib.h10x_free(ptr)
    if p.endswith(".gz"):
        import gzip
        with gzip.open(p, "rb") as f:
            data = f.read()
    else:
        data = Path(p).read_bytes()
    buf = ctypes.create_string_buffer(data, len(data))
    return _parse_buffer(lib, buf, len(data), bc_len, max_len, p)


def _parse_buffer(lib, buf, n, bc_len, max_len, path):
    n_rec_est = lib.h10x_count_records(buf, n)
    if n_rec_est <= 0:
        return (np.zeros((0, 0), np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.uint32), 0, None)
    long_p = ctypes.POINTER(ctypes.c_long)
    seq_off = np.zeros(n_rec_est, np.int64)
    seq_len = np.zeros(n_rec_est, np.int64)
    n_rec = lib.h10x_seq_offsets(buf, n, seq_off.ctypes.data_as(long_p),
                                 seq_len.ctypes.data_as(long_p), n_rec_est)
    if n_rec < 0:
        raise ValueError(
            f"{path}: malformed FASTQ (record not starting with @)")
    seq_off, seq_len = seq_off[:n_rec], seq_len[:n_rec]

    read_len = max_len or max(int(seq_len.max(initial=0)) - bc_len, 0)
    words = (read_len + 15) // 16
    nwords = (read_len + 31) // 32
    packed = np.zeros((n_rec, max(words, 1)), np.uint32)
    lengths = np.zeros(n_rec, np.int32)
    barcodes = np.zeros(n_rec, np.uint32)
    nmask = np.zeros((n_rec, max(nwords, 1)), np.uint32)
    u32_p = ctypes.POINTER(ctypes.c_uint32)
    n_bad = lib.h10x_pack(
        buf, seq_off.ctypes.data_as(long_p), seq_len.ctypes.data_as(long_p),
        n_rec, bc_len, read_len, max(words, 1), max(nwords, 1),
        packed.ctypes.data_as(u32_p),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        barcodes.ctypes.data_as(u32_p), nmask.ctypes.data_as(u32_p))
    return (packed[:, :words], lengths, barcodes, read_len,
            nmask[:, :nwords] if n_bad else None)
