"""k-mer x barcode incidence (the code tables) in CSR form, on a torch
device — the port of ``hash10x_tpu/table/incidence.py``.

One deduplicated (k-mer, barcode) pair set held twice: sorted by barcode
(forward CSR, ``codeHashes``) and by k-mer (inverted CSR, ``hashCodes``).
k-mer ids are ranks in the sorted retained (count-band) hash set, so the
structure does not depend on read or batch order.

Pair keys are ``code * n_kmers + kmer`` in int64, so the key space must stay
below 2^63 - 1.  Lanes whose (barcode, hash) pair fits one int63 key skip the
per-batch rank join and map ranks once at the end
(:func:`combined_key_bits`, :func:`finalize_combined_pairs`).
:func:`build_incidence` is the one-shot entry from flat (k-mer id, barcode)
emissions; the engine streams batches through a sorted pair table instead.
Both end in :func:`incidence_from_sorted_pairs`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import INT64_MAX
from ..utils import timing
from .sorted_table import lookup_ids

__all__ = ["Incidence", "build_incidence", "retained_lookup", "pair_keys",
           "combined_key_bits", "finalize_combined_pairs",
           "incidence_from_sorted_pairs"]


@dataclass
class Incidence:
    n_kmers: int
    n_codes: int
    # forward CSR (codeHashes): pairs sorted by (code, kmer)
    code_offsets: torch.Tensor   # (n_codes + 1,) int64
    code_kmers: torch.Tensor     # (P,) int64
    # inverted CSR (hashCodes): pairs sorted by (kmer, code)
    kmer_offsets: torch.Tensor   # (n_kmers + 1,) int64
    kmer_codes: torch.Tensor     # (P,) int64
    # forward-CSR position of each inverted-CSR entry (the payload of the
    # kmer-major sort); None for hand-built instances
    inv2fwd: Optional[torch.Tensor] = None  # (P,) int64

    @property
    def n_pairs(self) -> int:
        return int(self.code_kmers.shape[0])

    @property
    def device(self) -> torch.device:
        return self.code_offsets.device

    def code_of_pair(self) -> torch.Tensor:
        """(P,) int64 barcode of every forward-CSR position."""
        return torch.repeat_interleave(
            torch.arange(self.n_codes, device=self.device),
            torch.diff(self.code_offsets))

    def kmers_of(self, code: int) -> torch.Tensor:
        """The k-mer ids of barcode ``code``, ascending (a view)."""
        o = self.code_offsets[code:code + 2].tolist()
        return self.code_kmers[o[0]:o[1]]

    def codes_of(self, kmer: int) -> torch.Tensor:
        """The barcodes holding k-mer ``kmer``, ascending (a view)."""
        o = self.kmer_offsets[kmer:kmer + 2].tolist()
        return self.kmer_codes[o[0]:o[1]]


def retained_lookup(retained: torch.Tensor, hashes: torch.Tensor):
    """Canonical k-mer ids of ``hashes``: their ranks in the ascending
    retained set.  Returns (ids int64, -1 where absent; found mask);
    ``INT64_MAX`` pads are never found."""
    return lookup_ids(retained, hashes)


def pair_keys(retained: torch.Tensor, flat_h: torch.Tensor,
              flat_bc: torch.Tensor, n_kmers: int) -> torch.Tensor:
    """Per-batch pair keys: (hash, barcode) -> code * n_kmers + kmer rank,
    ``INT64_MAX`` for hashes outside the retained set or invalid barcodes."""
    if retained.shape[0] == 0:
        return torch.full_like(flat_h, INT64_MAX)
    idx = torch.clamp(torch.searchsorted(retained, flat_h),
                      max=retained.shape[0] - 1)
    ok = (retained[idx] == flat_h) & (flat_h != INT64_MAX) & (flat_bc >= 0)
    return torch.where(ok, flat_bc * n_kmers + idx, INT64_MAX)


def combined_key_bits(k: int, n_codes: int) -> int:
    """Bits to shift the barcode id by so (barcode << hb) | hash fits one
    non-negative int64 below ``INT64_MAX``, or 0 when it cannot.

    The canonical hash spans 2k bits, so hb = 2k, and every real combined key
    is below n_codes << hb; that needs n_codes <= 2^(63 - 2k) - 1 (one bit
    less than the uint64 form of the JAX package)."""
    hb = 2 * k
    if hb >= 63:
        return 0
    if max(n_codes, 1) > (1 << (63 - hb)) - 1:
        return 0
    return hb


def finalize_combined_pairs(keys: torch.Tensor, retained: torch.Tensor,
                            n_kmers: int, hb: int) -> torch.Tensor:
    """Map sorted distinct combined keys (barcode << hb | hash) to sorted
    canonical pair keys code * n_kmers + rank, dropping hashes outside the
    retained set.  rank is monotone in hash, so the survivors stay sorted."""
    if retained.shape[0] == 0 or keys.shape[0] == 0:
        return keys[:0]
    h = keys & ((1 << hb) - 1)
    bc = keys >> hb
    idx = torch.clamp(torch.searchsorted(retained, h),
                      max=retained.shape[0] - 1)
    found = retained[idx] == h
    return (bc * n_kmers + idx)[found]


def _csr_from_pairs(pairs: torch.Tensor, n_kmers: int, n_codes: int):
    """Sorted unique code-major pair keys -> both CSR halves, with inv2fwd
    carried out of the kmer-major sort."""
    dev = pairs.device
    pc = pairs // n_kmers
    pk = pairs % n_kmers
    code_offsets = torch.searchsorted(
        pairs, torch.arange(n_codes + 1, device=dev) * n_kmers)
    timing.add("sorted_keys", pairs.shape[0])
    keys2, inv2fwd = torch.sort(pk * n_codes + pc, stable=True)
    kmer_offsets = torch.searchsorted(
        keys2, torch.arange(n_kmers + 1, device=dev) * n_codes)
    return pk, code_offsets, kmer_offsets, keys2 % n_codes, inv2fwd


def incidence_from_sorted_pairs(pairs: torch.Tensor, n_kmers: int,
                                n_codes: int) -> Incidence:
    """Sorted unique (code-major) int64 pair keys -> double-CSR Incidence on
    the keys' device."""
    dev = pairs.device
    if n_codes == 0 or pairs.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return Incidence(n_kmers, n_codes,
                         torch.zeros(n_codes + 1, dtype=torch.int64,
                                     device=dev), empty,
                         torch.zeros(n_kmers + 1, dtype=torch.int64,
                                     device=dev), empty, empty)
    if n_codes * n_kmers >= INT64_MAX:
        raise ValueError(f"pair key space {n_codes} codes x {n_kmers} kmers "
                         "does not fit int64")
    pk, code_offsets, kmer_offsets, kmer_codes, inv2fwd = _csr_from_pairs(
        pairs, n_kmers, n_codes)
    return Incidence(n_kmers, n_codes, code_offsets, pk, kmer_offsets,
                     kmer_codes, inv2fwd)


def build_incidence(kmer_ids, codes, n_kmers: int, n_codes: int,
                    device) -> Incidence:
    """Deduplicate flat (k-mer id, barcode id) emissions into the
    double-CSR incidence on ``device``.

    ``kmer_ids`` and ``codes`` are (P,) integer arrays or tensors; entries
    where either is -1 are dropped.  Pair keys ``code * n_kmers + kmer`` are
    sorted and deduplicated on the device."""
    dev = torch.device(device)
    k = torch.as_tensor(kmer_ids).to(dev, torch.int64)
    c = torch.as_tensor(codes).to(dev, torch.int64)
    keep = (k >= 0) & (c >= 0)
    k, c = k[keep], c[keep]
    if n_codes * n_kmers >= INT64_MAX:
        raise ValueError(f"pair key space {n_codes} codes x {n_kmers} kmers "
                         "does not fit int64")
    if k.shape[0] and (int(k.max()) >= n_kmers or int(c.max()) >= n_codes):
        raise ValueError(f"k-mer ids must be < {n_kmers} and barcode ids "
                         f"< {n_codes}")
    pairs = torch.unique(c * n_kmers + k, sorted=True)
    return incidence_from_sorted_pairs(pairs, n_kmers, n_codes)
