"""The reference of a count pass (the mix ``count``): the histogram of the
count table, the number of distinct hashes held by each barcode count
(clipped to ``MAX_COUNT``; bin 0 is 0)."""

from __future__ import annotations

import torch

from . import pipeline

MAX_COUNT = 256


def reference(lane, cfg: dict, device, control: bool = False):
    """({"histogram": [(MAX_COUNT + 1,) counts]}, {"emitted": minimizer
    positions}) of ``lane``; ``control`` counts every emission in place of
    every distinct barcode."""
    pipeline.require(cfg, mode="minimizer", count_mode="barcodes")
    packed, bcs = pipeline.on_device(lane, device)
    _, _, counts, emitted = pipeline.barcode_counts(
        packed, bcs, lane.read_len, lane.n_codes, cfg["k"], cfg["w"],
        cfg["hash_seed"], distinct_barcodes=not control)
    hist = torch.bincount(counts.clamp(max=MAX_COUNT), minlength=MAX_COUNT + 1)
    hist[0] = 0
    return {"histogram": [hist]}, {"emitted": emitted}
