"""The control of the comparison that decides ``correct``: a cell's plain
reference with every emission counted in place of every distinct barcode
(the guarantee the configurations state, that a count is a number of
barcodes, broken), put in the program's place and compared with the
reference as the program is.  It has to come out not correct on every
seed.  The benchmark's runs do not run it.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

prints one JSON line per seed: the numbers compared and whether the
control came out correct.  It runs on the card when there is one, at the
cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .compare import compare
from .lane import lane_of
from .run import load_cell, reference_of

__all__ = ["control_readings", "main"]


def control_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The control's numbers on the lane of ``seed``."""
    lane = lane_of(cfg, seed)
    reference = reference_of(traffic["reference"])
    ctl, _ = reference(lane, cfg, device, control=True)
    ctl = {k: [x.cpu() if isinstance(x, torch.Tensor) else x for x in v]
           for k, v in ctl.items()}
    want, _ = reference(lane, cfg, device)
    return compare([ctl], want)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    _, _, cfg, traffic = load_cell(args.workload)
    limits = {k: c.get("limit", 0) for k, c in traffic["compare"].items()}
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        got = control_readings(cfg, traffic, seed, dev)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": all(got[k] <= limits[k] for k in limits),
            "checks": got, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
