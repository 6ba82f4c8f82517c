"""The comparison that decides ``correct``: the program's outputs against the
plain reference's, check by check.

A traffic mix names its checks (``compare``): each takes one or more parts
of a pass's outputs and has a limit.  The reference of the mix gives the
same checks.  A check's number is the count of entries that differ between
the two sides, part by part: tensor entries, or report lines for a text
(an entry present on one side only differs; a part that one side lacks
counts every entry of the other, and one more).
"""

from __future__ import annotations

from itertools import zip_longest

import torch

__all__ = ["differing", "lines_differing", "part_differing", "compare"]


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    a, b = a.reshape(-1), b.reshape(-1)
    n = min(a.numel(), b.numel())
    return int((a[:n] != b[:n]).sum()) + abs(a.numel() - b.numel())


def lines_differing(text: str, want: str) -> int:
    a, b = text.split("\n"), want.split("\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def _size(x) -> int:
    if x is None:
        return 0
    return len(x.split("\n")) if isinstance(x, str) else x.numel()


def part_differing(got, want) -> int:
    """Entries of one part that differ (``got`` or ``want`` None when that
    side lacks the part)."""
    if got is None or want is None:
        return _size(got) + _size(want) + 1
    if isinstance(got, str) or isinstance(want, str):
        if not (isinstance(got, str) and isinstance(want, str)):
            return _size(got) + _size(want) + 1
        return lines_differing(got, want)
    return differing(torch.as_tensor(got).to("cpu", torch.int64),
                     torch.as_tensor(want).to("cpu", torch.int64))


def compare(got: list, want: dict) -> tuple:
    """``got``: the outputs of each pass compared, {check: [part]}, a pass
    holding some of the checks; ``want``: the reference's {check: [part]}.
    Returns ({check: entries differing, summed over the passes that hold
    it}, the number of passes that differ in some check)."""
    totals, failed = dict.fromkeys(want, 0), 0
    for out in got:
        if set(out) - set(want):
            raise KeyError(f"the reference gives no {set(out) - set(want)}")
        bad = False
        for name, parts in out.items():
            n = sum(part_differing(a, b)
                    for a, b in zip_longest(parts, want[name]))
            totals[name] += n
            bad = bad or n > 0
        failed += bad
    return totals, failed
