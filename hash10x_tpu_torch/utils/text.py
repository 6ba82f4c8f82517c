"""Text output of integer columns, formatted as tensors.

The dumps (``--writeCounts``, ``--writeClusters``) and the cluster report
hold one line per k-mer, pair or barcode: hundreds of millions of lines on a
real lane, where one Python f-string per line takes minutes.  Here a block
of lines is built as one (rows, width) byte matrix on the tensors' device
(every field rendered at the block's widest width, leading zeros masked
out), flattened through the mask, and written once.  The bytes equal the
f-strings ``f"{v}"`` (decimal) and ``f"{v:x}"`` (hex) of non-negative
integers.  Each block waits for the device a few times (the widest value,
small host tables sent over, masked selections, the bytes read back),
each recorded as a host wait ``wait.text.<function>``
(``utils/timing.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from . import timing

__all__ = ["write_rows", "write_report"]

ROWS = 1 << 21   # lines rendered at once (bounds the byte matrices)

Part = Union[bytes, Tuple[str, torch.Tensor],
             Tuple[str, torch.Tensor, Sequence[str]]]


def _digits(v: torch.Tensor, base: int):
    """(rows, D) ASCII digits of the non-negative ``v`` in ``base`` (10 or
    16) at the widest width D of the block, and the mask of the digits
    each value prints (no leading zeros; at least one digit)."""
    top = 0
    if v.numel():
        with timing.wait("text.digits"):
            top = int(v.max())
    D = max(len(f"{top:x}" if base == 16 else str(top)), 1)
    j = torch.arange(D, device=v.device)
    if base == 16:
        shifted = v[:, None] >> (4 * (D - 1 - j))
        d = shifted & 15
    else:
        with timing.wait("text.digits"):
            pows = torch.tensor([10 ** (D - 1 - i) for i in range(D)],
                                dtype=torch.int64, device=v.device)
        shifted = v[:, None] // pows
        d = shifted % 10
    chars = (d + 48 + (d > 9) * 39).to(torch.uint8)
    shown = (shifted > 0).sum(1).clamp(min=1)
    return chars, j[None, :] >= (D - shown)[:, None]


def _literal(p: bytes, n: int, device):
    with timing.wait("text.literal"):
        lit = torch.tensor(list(p), dtype=torch.uint8, device=device)
    return lit.expand(n, len(p)), torch.ones((n, len(p)), dtype=torch.bool,
                                             device=device)


def _thousandths(v: torch.Tensor):
    """``v / 1000`` with three decimals: the integer part, a point and
    three digits."""
    m, k = _digits(v // 1000, 10)
    with timing.wait("text.thousandths"):
        pows = torch.tensor([100, 10, 1], dtype=torch.int64, device=v.device)
    frac = ((v % 1000)[:, None] // pows % 10 + 48).to(torch.uint8)
    point, ones = _literal(b".", v.shape[0], v.device)
    return (torch.cat([m, point, frac], 1),
            torch.cat([k, ones, torch.ones_like(frac, dtype=torch.bool)], 1))


def _names(idx: torch.Tensor, names: Sequence[str]):
    """``names[idx]`` (UTF-8) per line, ``-`` where idx is outside the
    table."""
    enc = [x.encode() for x in names] + [b"-"]
    width = max(len(x) for x in enc)
    table = torch.zeros((len(enc), width), dtype=torch.uint8)
    for i, x in enumerate(enc):
        table[i, :len(x)] = torch.tensor(list(x), dtype=torch.uint8)
    with timing.wait("text.names"):
        lens = torch.tensor([len(x) for x in enc], device=idx.device)
    row = torch.where((idx >= 0) & (idx < len(names)), idx, len(names))
    with timing.wait("text.names"):
        table = table.to(idx.device)
    m = table[row]
    return m, torch.arange(width, device=idx.device)[None, :] \
        < lens[row][:, None]


def _render(parts: Sequence[Part], n: int, device):
    """The ``n`` lines made of ``parts``, one after another: ``bytes``
    (the same literal on every line), ``("d", v)`` / ``("x", v)`` (the
    decimal / lowercase hex of each line's value of the int64 ``v``,
    non-negative), ``("c", ch)`` (one uint8 character per line, none
    where 0), and, each printing ``-`` where its value is negative,
    ``("d-", v)`` (decimal), ``("f3", v)`` (``v / 1000`` with three
    decimals) and ``("s", idx, names)`` (the string ``names[idx]``).
    Returns (the lines' bytes as one uint8 tensor, each line's byte
    count)."""
    mats: List[torch.Tensor] = []
    masks: List[torch.Tensor] = []
    for p in parts:
        if isinstance(p, bytes):
            m, k = _literal(p, n, device)
        elif p[0] == "c":
            m, k = p[1][:, None], p[1][:, None] != 0
        elif p[0] in ("d-", "f3", "s"):
            v = p[1].to(torch.int64)
            neg = v < 0
            if p[0] == "s":
                m, k = _names(v, p[2])
            else:
                m, k = (_thousandths if p[0] == "f3" else
                        lambda x: _digits(x, 10))(torch.clamp(v, min=0))
            dash, _ = _literal(b"-", n, device)
            m = torch.cat([m, dash], 1)
            k = torch.cat([k & ~neg[:, None], neg[:, None]], 1)
        else:
            m, k = _digits(p[1].to(torch.int64), 16 if p[0] == "x" else 10)
        mats.append(m)
        masks.append(k)
    mask = torch.cat(masks, 1)
    with timing.wait("text.render"):
        flat = torch.cat(mats, 1)[mask]
    return flat, mask.sum(1)


def _emit(out, flat: torch.Tensor) -> None:
    """Write the UTF-8 bytes ``flat`` to the text stream ``out``: straight
    to its binary buffer where it has one (a file), skipping a decode and
    an encode of every byte."""
    with timing.wait("text.emit"):
        data = flat.cpu().numpy()
    buffer = getattr(out, "buffer", None)
    if buffer is None:
        out.write(data.tobytes().decode())
        return
    out.flush()
    buffer.write(data.data)


def write_rows(out, columns: Sequence[Part], n: int, device) -> None:
    """Write ``n`` lines of ``columns`` (as :func:`_render`; the
    tensors hold one value per line) to the text stream ``out``, a block of
    ``ROWS`` lines at a time."""
    for a in range(0, n, ROWS):
        b = min(a + ROWS, n)
        block = [p if isinstance(p, bytes) else (p[0], p[1][a:b], *p[2:])
                 for p in columns]
        _emit(out, _render(block, b - a, device)[0])


def _starts(lens: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(lens, 0) - lens


def _place(dst: torch.Tensor, flat: torch.Tensor, lens: torch.Tensor,
           row_start: torch.Tensor) -> None:
    """Scatter each row's bytes (``flat``, rows of ``lens`` bytes) to
    ``dst`` from its ``row_start`` on."""
    with timing.wait("text.place", 2):
        row = torch.repeat_interleave(
            torch.arange(lens.shape[0], device=lens.device), lens)
    pos = torch.arange(flat.shape[0], device=lens.device) \
        - _starts(lens)[row]
    dst[row_start[row] + pos] = flat


def write_report(out, n_kmers: torch.Tensor, n_clusters: torch.Tensor,
                 sizes: torch.Tensor, codes_per_block: int = 1 << 18
                 ) -> None:
    """The cluster report, one line per code c: ``code c nKmers
    n_kmers[c] nClusters n_clusters[c] sizes`` and the code's cluster
    sizes (``sizes``, code-major) joined by commas.  A code's line is its
    prefix followed by one ``size,`` token per cluster, the last ending in
    a newline (an empty cluster list ends the prefix with it)."""
    dev = n_kmers.device
    n_codes = n_kmers.shape[0]
    n_clusters = n_clusters.to(torch.int64)
    mol_end = torch.cumsum(n_clusters, 0)
    for c0 in range(0, n_codes, codes_per_block):
        c1 = min(c0 + codes_per_block, n_codes)
        nc = n_clusters[c0:c1]
        with timing.wait("text.report", 2 if c0 else 1):
            m0 = int(mol_end[c0 - 1]) if c0 else 0
            m1 = int(mol_end[c1 - 1])
        code = torch.arange(c0, c1, device=dev)
        with timing.wait("text.report"):
            nl = torch.tensor(10, dtype=torch.uint8, device=dev)
        pflat, plen = _render(
            [b"code ", ("d", code), b" nKmers ", ("d", n_kmers[c0:c1]),
             b" nClusters ", ("d", nc), b" sizes ",
             ("c", torch.where(nc == 0, nl, 0).to(torch.uint8))],
            c1 - c0, dev)
        with timing.wait("text.report", 2):
            mcode = torch.repeat_interleave(
                torch.arange(c1 - c0, device=dev), nc)
        last = torch.zeros(m1 - m0, dtype=torch.bool, device=dev)
        with timing.wait("text.report", 2):   # the selection, then True sent
            last[(_starts(nc) + nc - 1)[nc > 0]] = True
        sep = torch.where(last, nl, ord(",")).to(torch.uint8)
        mflat, mlen = _render([("d", sizes[m0:m1]), ("c", sep)],
                                  m1 - m0, dev)
        per_code = plen.clone()
        per_code.index_add_(0, mcode, mlen)
        code_start = _starts(per_code)
        mol_in_code = _starts(mlen) - _starts(
            torch.zeros_like(plen).index_add_(0, mcode, mlen))[mcode]
        with timing.wait("text.report"):
            n_bytes = int(per_code.sum())
        buf = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
        _place(buf, pflat, plen, code_start)
        _place(buf, mflat, mlen, code_start[mcode] + plen[mcode]
               + mol_in_code)
        _emit(out, buf)
