"""A run with the timed path broken underneath has to come out not correct.
The runs skip the harness's look for a card and drive the rest of a run on
the CPU, on tiny copies of both cells.  The cells run on one card, so the
fault of an exchange between cards does not arise."""

import io

import pytest
import torch

import hash10x_tpu_torch.cluster.sparse as SP
import hash10x_tpu_torch.engine as E
from benchmark import run as bench_run

CPU = torch.device("cpu")
CELLS = ["chr20_30x_slice.main", "chr20_30x.count"]


def _state_unchanged(mp):
    """Label propagation returns its state as it found it."""
    mp.setattr(SP, "propagate_labels",
               lambda p_e, f_e, n_p, n_f, edge_block=0:
               torch.arange(n_p, device=p_e.device))


def _half_batch(mp):
    """Every step sends the first half of each batch's reads only."""
    step = E.Engine._step
    mp.setattr(E.Engine, "_step",
               lambda self, steps, grp, *a, **kw: step(
                   self, steps, [(s, s + (t - s) // 2) for s, t in grp],
                   *a, **kw))


def _report_altered(mp):
    """The report's first molecule is one k-mer larger."""
    write = E.write_report

    def altered(out, n_kmers, n_clusters, sizes, *a, **kw):
        sizes = sizes.clone()
        sizes[0] += 1
        return write(out, n_kmers, n_clusters, sizes, *a, **kw)
    mp.setattr(E, "write_report", altered)


def _count_altered(mp):
    """The count table's first barcode count is one more."""
    count = E.Engine.count

    def altered(self, *a, **kw):
        count(self, *a, **kw)
        self.table.counts[0] += 1
    mp.setattr(E.Engine, "count", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "report_altered": _report_altered, "count_altered": _count_altered}
# the faults each cell's path can have: the count cell runs no clustering
# and writes no report
CELL_FAULTS = [(c, f) for c in CELLS for f in sorted(FAULTS)
               if c.endswith(".main") or f in ("half_batch", "count_altered")]
METRICS = {"chr20_30x_slice.main": {"count_s", "incidence_s", "cluster_s",
                                    "propagation_rounds", "split_report_s",
                                    "steps_per_pass", "flushes_per_pass"},
           "chr20_30x.count": {"count_s", "steps_per_pass",
                               "flushes_per_pass"}}


def _run(root, cell, trace=False):
    return bench_run.run_cell(cell, 2**31 + 77, 0.5, trace, CPU, root=root,
                              log=io.StringIO())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny, cell, trace):
    r = _run(tiny, cell, trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    names = set(r["metrics"])
    if trace:
        # on the CPU no device operation runs: the trace's readers are
        # silent
        assert names == METRICS[cell]
        assert "breakdown" in r and r["device"]["window_s"] > 0
    else:
        assert names == {"reads_per_s", "setup_s"}


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_planted_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = _run(tiny, cell)
    assert r["correct"] is False
    assert r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
