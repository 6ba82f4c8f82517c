"""Packed binary read container — the framework's ``.fqb`` analog.

The reference reads 2-bit packed reads with barcode ids from its ``.fqb`` format
(``hash10x.c:~readFQB``, SURVEY.md §3.1 #2; byte layout [L]-confidence and
unverifiable while the mount is empty).  Per SURVEY.md §3.3's compatibility ruling,
the container format is ours (semantic outputs are the contract); this module defines
it plus a FASTQ importer.  Layout: an uncompressed ``.npz`` holding

* ``packed   (N, ceil(L/16)) uint32`` — 2-bit packed bases (N bases packed as 'a')
* ``nmask    (N, ceil(L/32)) uint32`` — invalid-base (N) bitmask, omitted when the
  lane has no Ns; unpack restores code 4 there so k-mer windows spanning an N are
  rejected exactly as on the text path
* ``lengths  (N,) int32``
* ``barcode_ids (N,) int32`` — index into ``barcode_keys`` (-1 = invalid/no barcode)
* ``barcode_keys (C,) uint32`` — distinct 16bp barcodes, 2-bit packed, sorted
  (so barcode id order is deterministic, independent of read order)
* ``meta`` — json: version, read length, counts
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.encode import pack_2bit, unpack_2bit, nmask_from_codes
from .fastq import BARCODE_LEN, ReadBatch, read_fastq, extract_barcodes

__all__ = ["Fqb", "save_fqb", "load_fqb", "fastq_to_fqb", "from_read_batch"]

_VERSION = 2
_INVALID = np.uint32(0xFFFFFFFF)


def _length_masked_nmask(codes: np.ndarray, lengths: np.ndarray):
    """Invalid-base bitmask restricted to bases inside each read's length
    (padding past the length is already invalid via lengths); None if no Ns."""
    L = codes.shape[-1]
    in_read = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    bad = (np.asarray(codes, np.uint8) > 3) & in_read
    if not bad.any():
        return None
    return nmask_from_codes(np.where(bad, 4, 0).astype(np.uint8))


@dataclass
class Fqb:
    packed: np.ndarray        # (N, W) uint32
    lengths: np.ndarray       # (N,) int32
    barcode_ids: np.ndarray   # (N,) int32, -1 = invalid
    barcode_keys: np.ndarray  # (C,) uint32 sorted
    read_len: int
    nmask: Optional[np.ndarray] = None  # (N, ceil(L/32)) uint32, None = no Ns

    def __len__(self):
        return self.packed.shape[0]

    @property
    def n_barcodes(self) -> int:
        return int(self.barcode_keys.shape[0])

    def codes(self) -> np.ndarray:
        """Unpack to (N, read_len) uint8 base codes (padding beyond lengths is 'a',
        N positions come back as 4; mask with lengths downstream)."""
        return unpack_2bit(self.packed, self.read_len, self.nmask)


def from_read_batch(batch: ReadBatch, barcodes: Optional[np.ndarray] = None) -> Fqb:
    """Dense reads (+ per-read u32 barcode keys) -> Fqb with dense barcode ids.

    Validity comes from length > 0, NOT from the 0xFFFFFFFF key value: every
    32-bit value is a legitimate 16bp barcode (all-T packs to 0xFFFFFFFF), so
    invalid-barcode reads are marked by the extractors zeroing their length."""
    n, L = batch.codes.shape
    keys = batch.barcodes if barcodes is None else barcodes
    if keys is None:
        keys = np.full(n, _INVALID, np.uint32)
        valid = np.zeros(n, bool)  # no barcodes at all -> no barcode analysis
    else:
        valid = (batch.lengths > 0)
    uniq = np.unique(keys[valid])
    ids = np.full(n, -1, np.int32)
    ids[valid] = np.searchsorted(uniq, keys[valid]).astype(np.int32)
    return Fqb(
        packed=pack_2bit(batch.codes),
        lengths=batch.lengths.astype(np.int32),
        barcode_ids=ids,
        barcode_keys=uniq.astype(np.uint32),
        read_len=L,
        nmask=_length_masked_nmask(batch.codes, batch.lengths),
    )


def save_fqb(path, fqb: Fqb) -> None:
    meta = json.dumps({"version": _VERSION, "read_len": fqb.read_len,
                       "n_reads": len(fqb), "n_barcodes": fqb.n_barcodes,
                       "has_nmask": fqb.nmask is not None})
    extra = {"nmask": fqb.nmask} if fqb.nmask is not None else {}
    np.savez(path, packed=fqb.packed, lengths=fqb.lengths,
             barcode_ids=fqb.barcode_ids, barcode_keys=fqb.barcode_keys,
             meta=np.frombuffer(meta.encode(), np.uint8), **extra)


def load_fqb(path) -> Fqb:
    z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["version"] not in (1, _VERSION):
        raise ValueError(f"fqb version {meta['version']} != {_VERSION}")
    return Fqb(packed=z["packed"], lengths=z["lengths"],
               barcode_ids=z["barcode_ids"], barcode_keys=z["barcode_keys"],
               read_len=meta["read_len"],
               nmask=z["nmask"] if meta.get("has_nmask") else None)


def from_packed(packed: np.ndarray, lengths: np.ndarray, barcode_keys: np.ndarray,
                read_len: int, nmask: Optional[np.ndarray] = None) -> Fqb:
    """Assemble an Fqb directly from packed parts.
    Validity = length > 0 (see from_read_batch: every u32 is a real barcode)."""
    valid = np.asarray(lengths) > 0
    uniq = np.unique(barcode_keys[valid])
    ids = np.full(len(barcode_keys), -1, np.int32)
    ids[valid] = np.searchsorted(uniq, barcode_keys[valid]).astype(np.int32)
    if nmask is not None and not nmask.any():
        nmask = None
    return Fqb(packed=packed, lengths=lengths.astype(np.int32), barcode_ids=ids,
               barcode_keys=uniq.astype(np.uint32), read_len=read_len,
               nmask=nmask)


def paired_fastq_to_fqb(r1_path, r2_path, out_path=None, max_len: int = 0,
                        prefer_native: bool = True) -> Fqb:
    """Paired Chromium lane: R1 = 16bp GEM barcode + genomic, R2 = genomic.

    R2 reads inherit their mate's barcode (same record order — the Chromium
    demultiplexed-FASTQ contract, SURVEY.md §1); both mates' genomic sequence
    lands in one Fqb so the k-mer x barcode table sees all bases.
    """
    f1 = fastq_to_fqb(r1_path, barcoded=True, max_len=max_len,
                      prefer_native=prefer_native)
    b2 = read_fastq(r2_path, max_len=max_len)
    if len(b2) != len(f1):
        raise ValueError(f"R1 has {len(f1)} records but R2 has {len(b2)}")
    L = max(f1.read_len, b2.codes.shape[1])
    from ..core.encode import pack_2bit
    packed1 = f1.packed
    if f1.read_len < L:
        pad = np.zeros((len(f1), (L + 15) // 16 - packed1.shape[1]), np.uint32)
        packed1 = np.concatenate([packed1, pad], axis=1)
    packed2 = pack_2bit(b2.codes)
    if packed2.shape[1] < packed1.shape[1]:
        pad = np.zeros((len(b2), packed1.shape[1] - packed2.shape[1]), np.uint32)
        packed2 = np.concatenate([packed2, pad], axis=1)
    valid1 = f1.barcode_ids >= 0
    keys1 = f1.barcode_keys[np.maximum(f1.barcode_ids, 0)].astype(np.uint32)
    nm2 = _length_masked_nmask(b2.codes, b2.lengths)
    nmask = None
    if f1.nmask is not None or nm2 is not None:
        W32 = (L + 31) // 32
        def _pad_nm(nm, n_rows):
            if nm is None:
                return np.zeros((n_rows, W32), np.uint32)
            if nm.shape[1] < W32:
                nm = np.concatenate(
                    [nm, np.zeros((nm.shape[0], W32 - nm.shape[1]), np.uint32)],
                    axis=1)
            return nm
        nmask = np.concatenate([_pad_nm(f1.nmask, len(f1)),
                                _pad_nm(nm2, len(b2))])
    fqb = from_packed(
        np.concatenate([packed1, packed2]),
        np.concatenate([f1.lengths,
                        np.where(valid1, b2.lengths, 0).astype(np.int32)]),
        np.concatenate([keys1, keys1]),
        L, nmask=nmask)
    if out_path is not None:
        save_fqb(out_path, fqb)
    return fqb


def fastq_to_fqb(fastq_path, out_path=None, barcoded: bool = True,
                 max_len: int = 0, prefer_native: bool = True) -> Fqb:
    """FASTQ (R1 with leading 16bp GEM barcode if ``barcoded``) -> Fqb.

    The FASTQ->FQB converter of SURVEY.md §3.1 #3.  Uses the native C loader
    (``io/native_loader.py``: fused parse and pack) when it builds and
    ``barcoded``; otherwise the vectorized numpy parser.  Both give the same
    Fqb.
    """
    if barcoded and prefer_native:
        from . import native_loader
        parts = native_loader.load_fastq_native(fastq_path, max_len=max_len)
        if parts is not None:
            fqb = from_packed(*parts)
            if out_path is not None:
                save_fqb(out_path, fqb)
            return fqb
    # max_len means post-barcode genomic length in both loader paths
    raw_max = (max_len + BARCODE_LEN) if (barcoded and max_len) else max_len
    batch = read_fastq(fastq_path, max_len=raw_max)
    if barcoded:
        _, batch = extract_barcodes(batch)
    fqb = from_read_batch(batch)
    if out_path is not None:
        save_fqb(out_path, fqb)
    return fqb
