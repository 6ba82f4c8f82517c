"""The plain reference against ``hash10x_tpu_torch`` on the CPU, on tiny lanes
of both configurations' shapes, and the control that has to fail."""

import io
import json

import numpy as np
import pytest
import torch

from benchmark.compare import compare
from benchmark.lane import lane_of, make_lane
from benchmark.program import System, outputs
from benchmark.reference import pipeline
from benchmark.reference.seqhash import hash_factor, minimizers
from benchmark.run import reference_of
from benchmark.tests.conftest import REPO, TINY

CPU = torch.device("cpu")
# (configuration, traffic mix) of each cell
CELLS = [("chr20_30x_slice", "main"), ("chr20_30x", "count")]


def _config(name):
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                     .read_text())
    n, codes, genome = TINY[name]
    cfg.update(n_reads=n, n_barcodes=codes, genome_len=genome, table_bits=12)
    return cfg


def _traffic(name):
    return json.loads((REPO / "benchmark" / "traffic" / f"{name}.json")
                      .read_text())


def _run(cfg_name, mix, seed, **change):
    """(lane, configuration, traffic, the program's outputs)."""
    cfg = dict(_config(cfg_name), **change)
    traffic = _traffic(mix)
    lane = lane_of(cfg, seed)
    p = System(cfg, traffic, lane, CPU).run_pass()
    return lane, cfg, traffic, outputs(p, traffic["compare"])


def _ref(traffic, lane, cfg, **kw):
    return reference_of(traffic["reference"])(lane, cfg, CPU, **kw)


def _scalar_minimizers(codes, k, w, factor):
    """One read's minimizers by the rules, one position at a time."""
    m64 = (1 << 64) - 1
    hs = []
    for p in range(len(codes) - k + 1):
        f = r = 0
        for j in range(k):
            f = (f << 2) | int(codes[p + j])
            r |= (3 - int(codes[p + j])) << (2 * j)
        hs.append(min(((f * factor) & m64) >> (64 - 2 * k),
                      ((r * factor) & m64) >> (64 - 2 * k)))
    out = set()
    for s in range(len(hs) - w + 1):
        win = hs[s:s + w]
        out.add(s + win.index(min(win)))
    return {p: hs[p] for p in sorted(out)}


@pytest.mark.parametrize("k,w", [(21, 11), (31, 5), (15, 1)])
def test_minimizers_by_the_rules(k, w):
    lane = make_lane(40, 4, 100_000, 9)
    factor = hash_factor(17)
    h, e = minimizers(torch.from_numpy(lane.packed.view(np.int32)), 150, k,
                      w, factor)
    codes = (lane.packed[:, :, None] >> (2 * np.arange(16))) & 3
    codes = codes.reshape(40, -1)[:, :150]
    for r in range(40):
        want = _scalar_minimizers(codes[r], k, w, factor)
        got = {p: int(h[r, p]) for p in np.flatnonzero(e[r].numpy())}
        assert got == want


@pytest.mark.parametrize("cell", CELLS, ids="{0[0]}.{0[1]}".format)
@pytest.mark.parametrize("triples", [pipeline.TRIPLES, 5000])
def test_reference_equals_the_program(cell, triples, monkeypatch):
    monkeypatch.setattr(pipeline, "TRIPLES", triples)
    monkeypatch.setattr(pipeline.friend_clusters, "__defaults__",
                        (triples,))
    lane, cfg, traffic, out = _run(*cell, 2**31 + 101)
    want, facts = _ref(traffic, lane, cfg)
    assert set(want) == set(traffic["compare"])
    assert compare([out], want) == (dict.fromkeys(want, 0), 0)
    positions = lane.n_reads * (lane.read_len - cfg["k"] + 1)
    assert 0 < facts["emitted"] < positions
    if "molecules" in want:
        # the lane exercises clustering: barcodes of several molecules and
        # of one
        origin, = want["molecules"]
        per_code = torch.bincount(origin[:, 0])
        assert (per_code > 1).any() and (per_code == 1).any()
        assert facts["emitted"] > want["pairs"][1].shape[0] > 0
    else:
        hist, = want["histogram"]
        # hashes held by one barcode (error k-mers among them) and by
        # several
        assert hist[1] > 0 and hist[2:].sum() > 0


@pytest.mark.parametrize("cell", CELLS, ids="{0[0]}.{0[1]}".format)
def test_the_lane_has_errors_and_both_strands(cell):
    """Without its sequencing errors a lane's count table is smaller: the
    reference sees the errors the configuration states."""
    lane, cfg, traffic, out = _run(*cell, 5)
    want, _ = _ref(traffic, lane, cfg)
    clean = dict(cfg, error_rate=0.0, both_strands=False)
    lane0 = lane_of(clean, 5)
    want0, _ = _ref(traffic, lane0, clean)
    assert compare([out], want0)[1] == 1
    assert compare([out], want)[1] == 0


@pytest.mark.parametrize("cell", CELLS, ids="{0[0]}.{0[1]}".format)
def test_a_wrong_hash_seed_differs(cell):
    lane, cfg, traffic, out = _run(*cell, 7)
    want, _ = _ref(traffic, lane, dict(cfg,
                                             hash_seed=cfg["hash_seed"] + 1))
    got, failed = compare([out], want)
    assert failed == 1 and all(v > 0 for k, v in got.items()
                               if k in ("band", "report_lines", "histogram"))


@pytest.mark.parametrize("cell", CELLS, ids="{0[0]}.{0[1]}".format)
@pytest.mark.parametrize("seed", [3, 2**31 + 9, 2**40 + 1])
def test_control_fails(cell, seed):
    """The control: the reference with every emission counted in place of
    every distinct barcode, put in the program's place."""
    lane, cfg, traffic, _ = _run(*cell, seed)
    want, _ = _ref(traffic, lane, cfg)
    ctl, _ = _ref(traffic, lane, cfg, control=True)
    got, failed = compare([ctl], want)
    assert failed == 1
    assert got.get("band", got.get("histogram")) > 0


@pytest.mark.parametrize("mix,change", [("main", {"cluster_mode": "pair"}),
                                        ("main", {"max_friends": 256}),
                                        ("count", {"mode": "syncmer"})])
def test_reference_refuses_what_it_does_not_hold(mix, change):
    cfg = dict(_config("chr20_30x"), **change)
    lane = lane_of(cfg, 1)
    with pytest.raises(ValueError):
        _ref(_traffic(mix), lane, cfg)


def test_report_text_format():
    text = pipeline.report_text(np.array([3, 0, 5]), np.array([2, 0, 1]),
                                np.array([2, 1, 5]))
    assert text == ("code 0 nKmers 3 nClusters 2 sizes 2,1\n"
                    "code 1 nKmers 0 nClusters 0 sizes \n"
                    "code 2 nKmers 5 nClusters 1 sizes 5\n")
    sink = io.StringIO()
    from hash10x_tpu_torch.utils.text import write_report
    write_report(sink, torch.tensor([3, 0, 5]), torch.tensor([2, 0, 1]),
                 torch.tensor([2, 1, 5]))
    assert sink.getvalue() == text
