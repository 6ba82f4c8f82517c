"""The benchmark's frozen copies: the lane generator, the glibc factors, the
sketch-work arithmetic and the reduction of a trace."""

import importlib.util

import numpy as np
import pytest

from benchmark import trace, work
from benchmark.lane import make_lane
from benchmark.reference.seqhash import glibc_random, hash_factor
from benchmark.tests.conftest import REPO
from hash10x_tpu_torch import bench as port_bench
from hash10x_tpu_torch.glibc_random import GlibcRandom
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.kernels import minimizer as MK


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("seed", [11, 2**31 + 17])
def test_lane_equals_the_ports_generator(seed):
    a = make_lane(6000, 375, 3_000_000, seed, chunk=1000)
    b = port_bench.make_barcodes_lane_blocked(6000, 375, 3_000_000,
                                              seed=seed)
    assert np.array_equal(a.packed, b.packed)
    assert np.array_equal(a.barcode_ids, b.barcode_ids)
    assert np.array_equal(a.lengths, b.lengths)


def test_lane_follows_the_seed():
    a = make_lane(2000, 100, 1_000_000, 5)
    assert np.array_equal(a.packed, make_lane(2000, 100, 1_000_000, 5).packed)
    assert not np.array_equal(a.packed,
                              make_lane(2000, 100, 1_000_000, 6).packed)


def _codes(lane):
    """(n_reads, read_len) base codes of a lane."""
    c = (lane.packed[:, :, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    return c.reshape(lane.n_reads, -1)[:, :lane.read_len].astype(np.uint8)


def test_lane_reads_off_both_strands():
    plain = _codes(make_lane(4000, 100, 1_000_000, 8))
    both = _codes(make_lane(4000, 100, 1_000_000, 8, both_strands=True))
    same = (both == plain).all(1)
    rc = (both == 3 - plain[:, ::-1]).all(1)
    assert (same | rc).all()
    assert 0.45 < rc.mean() < 0.55


@pytest.mark.parametrize("rate", [0.0024, 0.02])
def test_lane_errors_at_the_rate(rate):
    plain = _codes(make_lane(20_000, 500, 1_000_000, 4))
    lane = make_lane(20_000, 500, 1_000_000, 4, error_rate=rate)
    noisy = _codes(lane)
    wrong = noisy != plain
    n = wrong.size
    # a binomial count within five standard deviations of its mean
    assert abs(wrong.sum() - n * rate) < 5 * (n * rate) ** 0.5
    # errors fall everywhere along the read, and change the seed's lane
    assert wrong[:, :75].sum() > 0 and wrong[:, 75:].sum() > 0
    other = _codes(make_lane(20_000, 500, 1_000_000, 5, error_rate=rate))
    assert not np.array_equal(noisy != _codes(
        make_lane(20_000, 500, 1_000_000, 4)), other != _codes(
        make_lane(20_000, 500, 1_000_000, 5)))
    # the same seed, another chunk: the same lane
    again = make_lane(20_000, 500, 1_000_000, 4, error_rate=rate, chunk=999)
    assert np.array_equal(again.packed, lane.packed)


def test_lane_molecule_length_bounds_the_reads():
    lane = make_lane(400, 20, 1_000_000, 3, molecule=1_000)
    assert lane.n_reads == 400 and lane.packed.shape == (400, 10)
    with pytest.raises(ValueError):
        make_lane(401, 20, 1_000_000, 3)


@pytest.mark.parametrize("seed", [0, 1, 17, 2**31 + 3, 2**32 - 1])
def test_glibc_copy_equals_the_ports(seed):
    g = GlibcRandom(seed)
    assert glibc_random(seed, 6) == [g.random() for _ in range(6)]
    assert hash_factor(seed) == HashSpec(k=21, w=11, seed=seed).factor1


def test_hash_factor_of_the_cells_seed():
    assert hash_factor(17) == 0x49308BB9003CB3AD


def test_work_arithmetic():
    assert (work.HBM_BYTES_PER_S, work.INT32_OPS_PER_S, work.OPS_PER_HASH) \
        == (MK.HBM_BYTES_PER_S, MK.INT32_OPS_PER_S, MK.OPS_PER_HASH)
    nbytes, ops = work.sketch_work(1000, 150, 21, 20_000)
    assert nbytes == 1000 * (40 + 4) + 8 * 20_000
    assert ops == 20 * 1000 * 130
    t, by = work.least_seconds(nbytes, ops)
    assert by == "operations" and t == ops / work.INT32_OPS_PER_S


def _events():
    """A hand-made trace: a 100 us pass, device busy 10-30, 25-40 and
    70-80 us; the host in stage "count" until 50 us, then "cluster"."""
    dev = [(10, 20, "kernel", "sketch_kernel<1>"),
           (25, 15, "kernel", "radixSort"),
           (70, 10, "gpu_memcpy", "Memcpy DtoH")]
    host = [(0, 50, "user_annotation", "stage:count"),
            (40, 10, "cpu_op", "aten::nonzero"),
            (50, 50, "user_annotation", "stage:cluster"),
            (55, 20, "cpu_op", "aten::sort")]
    return [{"ph": "X", "ts": t, "dur": d, "cat": c, "name": n}
            for t, d, c, n in dev + host]


def test_trace_reduction():
    ev = _events()
    spans = trace.device_spans(ev)
    assert len(spans) == 3
    assert trace.busy_seconds(spans) == pytest.approx(40e-6)
    assert trace.top_ops(spans, 2) == [["sketch_kernel<1>", 20e-6],
                                       ["radixSort", 15e-6]]
    gaps = dict(trace.idle_gaps(ev, spans, 0, 100))
    # idle 0-10, 40-70 and 80-100 us, each named at its middle
    assert gaps == pytest.approx({"stage:count": 10e-6,
                                  "stage:cluster/aten::sort": 30e-6,
                                  "stage:cluster": 20e-6})


def test_idle_share_and_roofline_readers():
    ev = _events()
    spans = trace.device_spans(ev)
    ctx = {"trace": {"spans": spans, "busy_s": trace.busy_seconds(spans),
                     "window_s": 100e-6},
           "lane": {"n_reads": 1000, "read_len": 150, "k": 21,
                    "emitted": 20_000},
           "traffic": {"stages": [{"call": "count"}, {"call": "filter"},
                                  {"call": "incidence"}]}}
    assert _reader("device_idle_share")(ctx) == pytest.approx(60.0)
    least, _ = work.least_seconds(*[2 * x for x in work.sketch_work(
        1000, 150, 21, 20_000)])
    assert _reader("sketch_roofline")(ctx) == pytest.approx(
        100 * least / 20e-6)
    ctx["trace"] = None
    assert _reader("sketch_roofline")(ctx) is None
    assert _reader("device_idle_share")(ctx) is None
