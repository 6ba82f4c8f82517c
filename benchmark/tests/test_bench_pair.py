"""The pair cell (``chr20_30x_slice.pair``) on its tiny copy: a sound run is
correct, untraced and traced, and its new metrics read what the pair path
records; a run with the pair path broken underneath comes out not correct,
and so does the control.  The runs skip the harness's look for a card and
drive the rest of a run on the CPU, where no stream clock runs: the
metrics of stream seconds are read on the card (``chip``)."""

import io

import pytest
import torch

import hash10x_tpu_torch.cluster.cooccur as CO
from benchmark import run as bench_run
from benchmark.control import control_readings

CPU = torch.device("cpu")
CELL = "chr20_30x_slice.pair"
COUNTED = {"pair_rounds", "pair_cell_fill"}
TIMED = {"pair_support_s", "pair_propagation_s"}
CHECKS = {"band", "pairs", "labels", "molecules", "report_lines"}


def _run(root, trace=False, device=CPU):
    return bench_run.run_cell(CELL, 2**31 + 77, 0.5, trace, device,
                              root=root, log=io.StringIO())


def _sound(r):
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    assert set(r["checks"]) == CHECKS


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny, trace):
    r = _run(tiny, trace)
    _sound(r)
    names = set(r["metrics"])
    if not trace:
        assert names == {"reads_per_s", "setup_s"}
        return
    assert names == COUNTED    # on the CPU no stream seconds
    assert 0 < r["metrics"]["pair_cell_fill"]["value"] <= 100
    assert r["metrics"]["pair_rounds"]["value"] >= 1


def test_the_mix_runs_the_configurations_contract(tiny):
    _, _, cfg, traffic = bench_run.load_cell(CELL, tiny)
    assert traffic["engine"] == {k: cfg[k]
                                 for k in ("cluster_mode", "min_share")}
    assert traffic["reference"] == "pair_molecules"


def _one_round(mp):
    """Propagation stops after its first round."""
    def once(step, valid):
        K = valid.shape[1]
        iota = torch.arange(K, device=valid.device)
        return step(torch.where(valid, iota, K)), 1
    mp.setattr(CO, "_propagate", once)


def _threshold_off_by_one(mp):
    """Two k-mers link only at one more shared barcode than the contract
    asks."""
    real = CO.cluster_batch
    mp.setattr(CO, "cluster_batch",
               lambda cl, valid, min_share=2, *a, **kw: real(
                   cl, valid, min_share + 1, *a, **kw))


def _row_dropped(mp):
    """In each batch, the barcode of the most molecules loses its labels:
    every k-mer of it in molecule 0."""
    real = CO.cluster_batch

    def dropped(*a, **kw):
        labels = real(*a, **kw)
        r = labels.max(dim=1).values.argmax()
        labels[r] = torch.where(labels[r] >= 0, 0, -1)
        return labels
    mp.setattr(CO, "cluster_batch", dropped)


@pytest.mark.parametrize("fault", [_one_round, _threshold_off_by_one,
                                   _row_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(tiny, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(tiny)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["labels"]["value"] > 0


def test_the_control_fails(tiny):
    _, _, cfg, traffic = bench_run.load_cell(CELL, tiny)
    got = control_readings(cfg, traffic, 2**31 + 5, CPU)
    assert set(got) == CHECKS and got["band"] > 0 and got["pairs"] > 0


@pytest.mark.chip
def test_the_tiny_cell_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(tiny, True, torch.device("cuda", 0))
    _sound(r)
    m = r["metrics"]
    assert COUNTED | TIMED <= set(m)
    assert all(m[k]["value"] > 0 for k in COUNTED | TIMED)
    assert m["pair_cell_fill"]["value"] <= 100
