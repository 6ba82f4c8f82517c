"""Base encoding and 2-bit packing (host side: numpy; device side: torch).

Models the reference's ``dna2indexConv`` tables (``readseq.c``/``seqio.c``,
SURVEY.md §3.1 #17 [M]): a/A->0 c/C->1 g/G->2 t/T->3; everything else is the
invalid code 4 (the reference maps unknowns to negatives; we use one sentinel
since only valid/invalid matters downstream).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BAD",
    "CODE_TABLE",
    "ascii_to_codes",
    "codes_to_ascii",
    "pack_2bit",
    "nmask_from_codes",
    "unpack_2bit",
    "unpack_2bit_torch",
    "revcomp_codes",
]

BAD = np.uint8(4)

_LUT = np.full(256, BAD, dtype=np.uint8)
for _c, _v in (("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _LUT[ord(_c)] = _v
    _LUT[ord(_c.upper())] = _v
# the same map for ``bytes.translate`` (a C loop, several times faster than
# the numpy gather on genome-sized text)
CODE_TABLE = bytes(_LUT.tolist())

_BASES = np.frombuffer(b"acgtn", dtype=np.uint8)


def ascii_to_codes(s) -> np.ndarray:
    """bytes/str/uint8-array of DNA -> uint8 base codes (4 = invalid)."""
    if isinstance(s, str):
        s = s.encode()
    a = np.frombuffer(s, dtype=np.uint8) if isinstance(s, (bytes, bytearray)) else np.asarray(s, np.uint8)
    return _LUT[a]


def codes_to_ascii(codes: np.ndarray) -> bytes:
    return _BASES[np.minimum(np.asarray(codes, np.uint8), 4)].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement; invalid codes stay invalid."""
    c = np.asarray(codes, np.uint8)[::-1]
    return np.where(c <= 3, 3 - c, c).astype(np.uint8)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """(..., L) base codes -> (..., ceil(L/16)) uint32, base j in bits [2j%32).

    Invalid codes are packed as 0 (='a'); N information is carried out of band
    by :func:`nmask_from_codes` (the reference's ``.fqb`` is 2-bit, SURVEY.md
    §3.3 — but k-mers spanning an N must not be counted, so packed containers
    store a validity sideband and unpack restores code 4 there).
    """
    c = np.asarray(codes, np.uint8)
    L = c.shape[-1]
    pad = (-L) % 16
    if pad:
        c = np.concatenate([c, np.zeros(c.shape[:-1] + (pad,), np.uint8)], axis=-1)
    c = np.where(c <= 3, c, 0).astype(np.uint32)
    c = c.reshape(c.shape[:-1] + (-1, 16))
    shifts = (2 * np.arange(16, dtype=np.uint32))
    return (c << shifts).sum(axis=-1, dtype=np.uint32)


def nmask_from_codes(codes: np.ndarray) -> np.ndarray:
    """(..., L) base codes -> (..., ceil(L/32)) uint32 invalid-base bitmask
    (bit j%32 of word j//32 set iff base j is not in [0,3])."""
    c = np.asarray(codes, np.uint8)
    L = c.shape[-1]
    pad = (-L) % 32
    bad = (c > 3)
    if pad:
        bad = np.concatenate(
            [bad, np.zeros(c.shape[:-1] + (pad,), bool)], axis=-1)
    bad = bad.reshape(bad.shape[:-1] + (-1, 32)).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bad << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_2bit(packed: np.ndarray, length: int,
                nmask: np.ndarray = None) -> np.ndarray:
    """Inverse of :func:`pack_2bit` -> (..., length) uint8 codes; positions set
    in ``nmask`` (see :func:`nmask_from_codes`) come back as the invalid code 4."""
    p = np.asarray(packed, np.uint32)[..., :, None]
    shifts = (2 * np.arange(16, dtype=np.uint32))
    c = (p >> shifts) & 3
    c = c.reshape(c.shape[:-2] + (-1,))[..., :length].astype(np.uint8)
    if nmask is not None:
        m = np.asarray(nmask, np.uint32)[..., :, None]
        b = ((m >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
        b = b.reshape(b.shape[:-2] + (-1,))[..., :length]
        c = np.where(b, BAD, c)
    return c


def unpack_2bit_torch(packed, length: int, nmask=None):
    """Device-side unpack: (..., W) int32 words (the uint32 packing viewed as
    int32) -> (..., length) uint8 codes on the same device.

    Reads cross to the device packed (4x smaller); this expands them there.
    ``nmask`` (..., ceil(L/32)) int32 restores invalid bases as code 4, so
    k-mer windows spanning them are rejected downstream, matching the text
    path.  Arithmetic right shifts are safe: every extracted field is masked
    to its low bits.
    """
    import torch
    dev = packed.device
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=dev)
    c = (packed[..., :, None] >> shifts) & 3
    c = c.reshape(c.shape[:-2] + (-1,))[..., :length].to(torch.uint8)
    if nmask is not None:
        bits = torch.arange(32, dtype=torch.int32, device=dev)
        b = ((nmask[..., :, None] >> bits) & 1) != 0
        b = b.reshape(b.shape[:-2] + (-1,))[..., :length]
        c = torch.where(b, torch.full_like(c, 4), c)
    return c
