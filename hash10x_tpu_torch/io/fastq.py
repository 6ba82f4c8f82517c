"""FASTQ/FASTA parsing and 10x Chromium barcode extraction (host side).

Models the reference's sequence-reading layer (``readseq.c``/``seqio.c``, SURVEY.md
§3.1 #17 [M]) and its FASTQ->FQB conversion (#3 [L]).  Parsing is vectorized numpy
over the raw byte buffer — no per-read Python loop — because host ingest must keep the
device fed (SURVEY.md §4.5: host-side packing feeds the device pipeline).

Chromium layout (SURVEY.md §1): R1 = 16 bp GEM barcode + linked genomic bases,
R2 = genomic.  :func:`read_fastq` returns raw records; :func:`extract_barcodes`
splits R1 into (barcode codes, remaining sequence).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.encode import ascii_to_codes

__all__ = ["ReadBatch", "read_fastq", "read_fasta", "extract_barcodes",
           "barcode_codes_to_u32", "BARCODE_LEN"]

BARCODE_LEN = 16  # 16 bp GEM barcode => 32-bit 2-bit-packed key (SURVEY.md §3.1 #2)


@dataclass
class ReadBatch:
    """A dense batch of reads: codes (N, L) uint8 (4 = pad/invalid), lengths (N,),
    optional per-read barcode u32 keys (N,) and names."""

    codes: np.ndarray
    lengths: np.ndarray
    barcodes: Optional[np.ndarray] = None
    names: Optional[List[bytes]] = None

    def __len__(self):
        return self.codes.shape[0]


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastq(path, max_len: int = 0, with_names: bool = False) -> ReadBatch:
    """Parse a FASTQ file into a dense ReadBatch (no barcode handling here)."""
    with _open(path) as f:
        data = f.read()
    lines = data.split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    n = len(lines) // 4
    seqs = lines[1::4][:n]
    names = [l[1:].split(b" ")[0] for l in lines[0::4][:n]] if with_names else None
    return _pack_seqs(seqs, max_len, names)


def read_fasta(path, with_names: bool = True) -> ReadBatch:
    """Parse FASTA into a ReadBatch (one row per record; rows padded to longest).

    For whole genomes prefer :func:`fasta_records` streaming to avoid a dense pad.
    """
    names, seqs = [], []
    for name, seq in fasta_records(path):
        names.append(name)
        seqs.append(seq)
    return _pack_seqs(seqs, 0, names if with_names else None)


_FASTA_BLOCK = 1 << 26   # bytes read at once by fasta_records


def fasta_records(path, block: int = _FASTA_BLOCK, table: bytes = None):
    """Yield (name: bytes, sequence: bytes) per FASTA record, streaming.

    The file is read ``block`` bytes at a time.  A line starting with
    ``>`` is a header, whose name is the text after ``>`` up to the first
    space; the lines between headers are the record's sequence with their
    newlines removed, one ``bytes.translate`` per run of lines (through
    ``table`` where one is given: the crib reads base codes so), so a
    sequence may be cut anywhere between blocks and no block is copied
    whole.  Text before the first header is dropped."""
    name, parts, head, line_start = None, [], None, True
    with _open(path) as f:
        while True:
            data = f.read(block)
            if not data:
                break
            pos, n = 0, len(data)
            while pos < n:
                if head is not None:          # inside a header line
                    end = data.find(b"\n", pos)
                    head += data[pos:n if end < 0 else end]
                    if end < 0:
                        break
                    if name is not None:
                        yield name, b"".join(parts)
                    name, parts, head = head.split(b" ")[0], [], None
                    pos, line_start = end + 1, True
                elif line_start and data[pos] == 62:    # ">"
                    head, pos = b"", pos + 1
                else:
                    nxt = data.find(b"\n>", pos)
                    stop = n if nxt < 0 else nxt + 1
                    parts.append(data[pos:stop].translate(table, b"\n"))
                    pos, line_start = stop, data[stop - 1] == 10
    if head is not None:
        if name is not None:
            yield name, b"".join(parts)
        name, parts = head.split(b" ")[0], []
    if name is not None:
        yield name, b"".join(parts)


def _pack_seqs(seqs: List[bytes], max_len: int, names) -> ReadBatch:
    n = len(seqs)
    lengths = np.array([len(s) for s in seqs], np.int32)
    L = max_len or (int(lengths.max()) if n else 0)
    lengths = np.minimum(lengths, L)
    codes = np.full((n, L), 4, np.uint8)
    # Vectorized fill: concatenate all bytes once, scatter by offsets.
    if n:
        flat = ascii_to_codes(b"".join(s[:L] for s in seqs))
        ends = np.cumsum(lengths)
        starts = ends - lengths
        rows = np.repeat(np.arange(n), lengths)
        cols = np.arange(ends[-1]) - np.repeat(starts, lengths)
        codes[rows, cols] = flat
    return ReadBatch(codes=codes, lengths=lengths, names=names)


def extract_barcodes(batch: ReadBatch, bc_len: int = BARCODE_LEN
                     ) -> Tuple[np.ndarray, ReadBatch]:
    """Split leading bc_len bases off every read as its GEM barcode.

    Returns (barcode u32 keys (N,), trimmed ReadBatch).  Reads shorter than
    bc_len + 1, or with an N inside the barcode, get barcode key 0xFFFFFFFF
    (invalid) and zero remaining length.
    """
    bc = batch.codes[:, :bc_len]
    ok = (batch.lengths > bc_len) & (bc <= 3).all(axis=1)
    keys = barcode_codes_to_u32(bc)
    keys = np.where(ok, keys, np.uint32(0xFFFFFFFF))
    rest = ReadBatch(
        codes=batch.codes[:, bc_len:].copy(),
        lengths=np.where(ok, batch.lengths - bc_len, 0).astype(np.int32),
        barcodes=keys,
        names=batch.names,
    )
    return keys, rest


def barcode_codes_to_u32(bc_codes: np.ndarray) -> np.ndarray:
    """(N, 16) base codes -> u32 2-bit-packed barcode key, base 0 in the top bits
    (so lexicographic sequence order == numeric key order)."""
    c = np.where(bc_codes <= 3, bc_codes, 0).astype(np.uint32)
    L = c.shape[1]
    shifts = (2 * (L - 1 - np.arange(L))).astype(np.uint32)
    return (c << shifts).sum(axis=1, dtype=np.uint32)
