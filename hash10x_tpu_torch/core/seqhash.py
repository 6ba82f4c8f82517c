"""Vectorized seqhash over read batches in plain torch — the port of
``hash10x_tpu/core/seqhash_jnp.py`` and the plain version of the CUDA sketch
kernel (``kernels/minimizer.py``).

Reproduces ``hash10x_tpu/oracle/seqhash_ref.py`` bit for bit on batches of
reads (the tests hold it to both the oracle and the JAX path).  A batch is
``codes (B, L) uint8`` + ``lengths (B,) int32`` on one device; every k-mer
position grid is ``(B, P)`` with ``P = L - k + 1``.

Arithmetic is int64: a 2k-bit code times ``factor1`` wraps mod 2^64 in int64
exactly as in uint64, and the arithmetic ``>> shift1`` followed by ``& mask``
keeps the same top 2k bits as the logical shift of ``HashSpec.hash_func``.
Invalid positions carry ``INT64_MAX`` and ``is_forward`` False.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .. import INT64_MAX
from ..hashspec import HashSpec

__all__ = ["to_int64", "hash_codes", "kmer_grid", "minimizer_mask",
           "modimizer_mask", "smer_spec", "syncmer_mask", "sketch"]


def to_int64(x: int) -> int:
    """The two's-complement int64 value of a uint64 Python int."""
    return x - (1 << 64) if x >= (1 << 63) else x


def hash_codes(spec: HashSpec, x: torch.Tensor) -> torch.Tensor:
    """``HashSpec.hash_func`` over an int64 tensor of 2k-bit codes."""
    return ((x * to_int64(spec.factor1)) >> spec.shift1) & spec.mask


def kmer_grid(spec: HashSpec, codes: torch.Tensor, lengths: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical hash of every k-mer position of every read.

    Returns ``(hashes (B,P) int64, is_forward (B,P) bool, valid (B,P) bool)``;
    a position is valid when its window lies inside the read and holds no
    code > 3.  Invalid positions carry ``INT64_MAX``."""
    k = spec.k
    B, L = codes.shape
    P = L - k + 1
    if P < 1:
        raise ValueError(f"read length {L} < k {k}")
    dev = codes.device
    c = codes.to(torch.int64)
    h = torch.zeros((B, P), dtype=torch.int64, device=dev)
    h_rc = torch.zeros((B, P), dtype=torch.int64, device=dev)
    for j in range(k):
        cj = c[:, j:j + P]
        h |= cj << (2 * (k - 1 - j))
        h_rc |= (3 - cj) << (2 * j)
    h &= spec.mask
    h_rc &= spec.mask

    cbad = torch.cumsum((codes > 3).to(torch.int32), dim=1)
    cbad0 = torch.nn.functional.pad(cbad, (1, 0))
    win_bad = cbad[:, k - 1:] - cbad0[:, :P]
    pos = torch.arange(P, device=dev)[None, :]
    valid = (win_bad == 0) & (pos <= (lengths.to(torch.int64)[:, None] - k))

    hf = hash_codes(spec, h)
    hr = hash_codes(spec, h_rc)
    is_forward = (hf < hr) & valid
    hashes = torch.where(is_forward, hf, hr)
    hashes = torch.where(valid, hashes, torch.full_like(hashes, INT64_MAX))
    return hashes, is_forward, valid


def minimizer_mask(spec: HashSpec, hashes: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    """Leftmost-minimum w-window minimizer emission mask over a (B, P) grid.

    Invalid positions break runs; a run shorter than w emits the leftmost
    minimum of the whole run (``seqhash_ref.minimizers``)."""
    w = spec.w
    B, P = hashes.shape
    dev = hashes.device
    pos = torch.arange(P, device=dev)[None, :].expand(B, P)
    pad_true = torch.ones((B, 1), dtype=torch.bool, device=dev)
    invalid = ~valid

    # run segmentation: first and one-past-last valid position of p's run
    is_start = valid & torch.cat([pad_true, invalid[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    is_end = valid & torch.cat([invalid[:, 1:], pad_true], dim=1)
    end_idx = torch.where(is_end, pos, P + 1)
    run_end = torch.cummin(end_idx.flip(1), dim=1).values.flip(1) + 1
    run_len = torch.where(valid, run_end - run_start, 0)

    # window starts s with run_start <= s <= max(run_end - w, run_start);
    # each covers [s, s + min(run_len, w))
    ww = torch.clamp(run_len, max=w)
    last_start = torch.maximum(run_end - w, run_start)
    is_win_start = valid & (pos <= last_start)

    big = torch.full_like(hashes, INT64_MAX)
    best_val = torch.where(is_win_start, hashes, big)
    best_idx = pos.clone()
    for j in range(1, min(w, P)):
        cand = torch.where(pos + j < P, torch.roll(hashes, -j, dims=1), big)
        cand = torch.where((j < ww) & is_win_start, cand, big)
        take = cand < best_val                     # strict: leftmost wins
        best_val = torch.where(take, cand, best_val)
        best_idx = torch.where(take, pos + j, best_idx)

    marks = torch.zeros((B, P), dtype=torch.int32, device=dev)
    marks.scatter_reduce_(1, best_idx, is_win_start.to(torch.int32), "amax")
    return marks.bool() & valid


def modimizer_mask(spec: HashSpec, hashes: torch.Tensor, valid: torch.Tensor,
                   m: int = 0) -> torch.Tensor:
    """Emission mask for k-mers with canonical hash ≡ 0 (mod m); m defaults
    to w."""
    m = m or spec.w
    return valid & (hashes % m == 0)


@functools.lru_cache(maxsize=64)
def smer_spec(spec: HashSpec, s: int, sub_seed: int = 0) -> HashSpec:
    """The s-mer ``HashSpec`` of syncmer mode (``seqhash_jnp.py:147``).
    Cached: deriving a spec runs the glibc ``random()`` stream in Python
    (~0.16 ms), longer than the sketch kernel it parameterises."""
    if not (0 < s < spec.k):
        raise ValueError("syncmer s must satisfy 0 < s < k")
    return HashSpec(k=s, w=1, seed=sub_seed or spec.seed)


def syncmer_mask(spec: HashSpec, codes: torch.Tensor, lengths: torch.Tensor,
                 s: int, sub_seed: int = 0) -> torch.Tensor:
    """Open-syncmer emission mask: keep a k-mer iff the minimal canonical
    s-mer hash inside it sits at offset 0 (leftmost tie-break)."""
    sh, _, _ = kmer_grid(smer_spec(spec, s, sub_seed), codes, lengths)
    P = codes.shape[1] - spec.k + 1
    base = sh[:, :P]
    keep = torch.ones_like(base, dtype=torch.bool)
    for j in range(1, spec.k - s + 1):
        keep &= sh[:, j:j + P] >= base
    return keep


def sketch(spec: HashSpec, codes: torch.Tensor, lengths: torch.Tensor,
           mode: str = "minimizer", m: int = 0, syncmer_s: int = 0):
    """One-call sketching: ``(hashes, is_forward, emit)``, all (B, P).

    mode: 'kmer' (every k-mer), 'minimizer', 'modimizer' or 'syncmer'
    (``syncmer_s`` = s-mer size)."""
    hashes, is_forward, valid = kmer_grid(spec, codes, lengths)
    if mode == "kmer":
        emit = valid
    elif mode == "minimizer":
        emit = minimizer_mask(spec, hashes, valid)
    elif mode == "modimizer":
        emit = modimizer_mask(spec, hashes, valid, m)
    elif mode == "syncmer":
        emit = valid & syncmer_mask(spec, codes, lengths, syncmer_s)
    else:
        raise ValueError(f"unknown sketch mode {mode!r}")
    return hashes, is_forward, emit
