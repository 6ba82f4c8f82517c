"""The reference of a whole pass (the mix ``main``): the band, the
incidence, friend clustering, the split and the report, in the numbers
that mix compares."""

from __future__ import annotations

import torch

from . import pipeline


def reference(lane, cfg: dict, device, control: bool = False):
    """({check: [part]}, {"emitted": minimizer positions}) of ``lane``;
    ``control`` counts every emission in place of every distinct
    barcode."""
    pipeline.require(cfg, mode="minimizer", count_mode="barcodes",
                     cluster_mode="friend", max_friends=0)
    packed, bcs = pipeline.on_device(lane, device)
    lo, hi = cfg["band"]
    retained, counts, offsets, kmers, emitted = pipeline.band_and_incidence(
        packed, bcs, lane.read_len, lane.n_codes, cfg["k"], cfg["w"],
        cfg["hash_seed"], lo, hi, distinct_barcodes=not control)
    del packed, bcs
    labels = pipeline.friend_clusters(offsets, kmers, retained.shape[0],
                                      cfg["min_friend_share"])
    origin, sizes, per_code = pipeline.molecules(offsets, labels)
    text = pipeline.report_text(torch.diff(offsets).cpu().numpy(),
                                per_code.cpu().numpy(), sizes.cpu().numpy())
    return ({"band": [retained, counts], "pairs": [offsets, kmers],
             "labels": [labels], "molecules": [origin],
             "report_lines": [text]},
            {"emitted": emitted})
