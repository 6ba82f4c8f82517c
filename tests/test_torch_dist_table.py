"""The port's sharded count table (``dist/sharded_sorted.py``,
``dist/group.py``) against the JAX package's
(``hash10x_tpu/dist/sharded_sorted.py``) on the 8-device virtual CPU mesh:
the same batches through both count steps (the JAX package's per-batch
step; the port's stacked step at one batch a step and at every batch in
one step) give equal splitters, equal shards (compared through
``convert``), equal drop counts, and a gathered table equal to the
single-shard port's.  Snapshots move between the packages and across shard
counts.  Every comparison is exact (tolerance: none)."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from hash10x_tpu.dist import sharded_sorted as JDS
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.sim import SimConfig, simulate
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.dist import sharded_sorted as DS
from hash10x_tpu_torch.dist.group import ShardGroup
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.table import sorted_table as st

torch.set_num_threads(2)


def mesh_of(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("d",))


@pytest.fixture(scope="module")
def sim_lane():
    """tests/test_dist.py's lane: 2048 padded rows of 120 bp."""
    sim = simulate(SimConfig(genome_len=80_000, n_barcodes=16,
                             molecules_per_barcode=2, molecule_len=5000,
                             reads_per_molecule=40, read_len=120, seed=0))
    fqb = JFB.from_read_batch(sim.reads)
    codes = fqb.codes()
    n = len(codes)
    c = np.zeros((2048, codes.shape[1]), np.uint8)
    ln = np.zeros(2048, np.int32)
    b = np.full(2048, -1, np.int32)
    c[:n], ln[:n], b[:n] = codes, fqb.lengths, fqb.barcode_ids
    return c, ln, b


def port_run(spec, n, batches, depth=1, **kw):
    """The batches through stacked steps of ``depth`` batches each (0: all
    of them in one step), each batch's lanes and slots sized as one
    batch's."""
    g = ShardGroup(n, "cpu")
    step = DS.SortedCountStep(spec, g, **kw)
    t = DS.ShardedSortedTable(g, 1 << 12, 1 << 16, spec=spec,
                              routing=step.routing)
    depth = depth or len(batches)
    for a in range(0, len(batches), depth):
        part = batches[a:a + depth]
        c, ln, b = (np.concatenate(x) for x in zip(*part))
        out = step.stacked(torch.from_numpy(c), torch.from_numpy(ln),
                           torch.from_numpy(b.astype(np.int64)), len(part))
        step.append(t, out, len(part), len(part))
    return step.finish(t)


# one batch a step, or every batch in one step
DEPTHS = pytest.mark.parametrize("depth", [1, 0],
                                 ids=["one_batch_a_step", "one_step"])


def jax_run(spec, n, batches, **kw):
    mesh = mesh_of(n)
    t = JDS.ShardedSortedTable(mesh, capacity=1 << 17, buf_capacity=1 << 20,
                               spec=spec)
    step = JDS.make_sorted_count_step(spec, mesh, **kw)
    for c, ln, b in batches:
        t = step(t, c, ln, b)
    return step.finish(t)


def halves(lane, parts=2):
    c, ln, b = lane
    m = len(c) // parts
    return [(c[i * m:(i + 1) * m], ln[i * m:(i + 1) * m], b[i * m:(i + 1) * m])
            for i in range(parts)]


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("mode,w", [("minimizer", 11), ("kmer", 1),
                                    ("syncmer", 7)])
def test_splitters_equal_jax(n, mode, w):
    jspec, spec = JHashSpec(k=21, w=w, seed=17), HashSpec(k=21, w=w, seed=17)
    eff = DS.emit_dist_eff(spec, mode)
    assert eff == JDS.emit_dist_eff(jspec, mode)
    assert DS.range_splitters(spec, n, eff).tolist() == \
        JDS.range_splitters(jspec, n, eff).astype(np.int64).tolist()
    assert DS.code_range_bounds(1000, n).tolist() == \
        JDS.code_range_bounds(1000, n).tolist()


@DEPTHS
@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_sorted_equals_jax_shard_by_shard(sim_lane, n, depth):
    """Mirror of test_dist.py::test_sharded_sorted_equals_single_device:
    shard s of the port holds exactly shard s of the JAX table."""
    spec, jspec = HashSpec(k=21, w=7, seed=17), JHashSpec(k=21, w=7, seed=17)
    batches = halves(sim_lane)
    t = port_run(spec, n, batches, depth)
    jt = jax_run(jspec, n, batches)
    assert DS.host_sum(t.group, t.drops) == 0
    ph, pc = convert.sharded_table_to_numpy(t)
    jh, jc = np.asarray(jt.hashes), np.asarray(jt.counts)
    for s in range(n):
        keep = jh[s] != np.uint64(2**64 - 1)
        real = ph[s] != np.uint64(2**64 - 1)
        assert ph[s][real].tolist() == jh[s][keep].tolist()
        assert pc[s][real].tolist() == jc[s][keep].tolist()
    # gathered == the single-shard port's table == the JAX gather
    gh, gc = DS.gather_sorted_compact(t)
    one = port_run(spec, 1, batches, depth)
    oh, oc = DS.gather_sorted_compact(one)
    assert gh.tolist() == oh.tolist() and gc.tolist() == oc.tolist()
    jgh, jgc = JDS.gather_sorted_compact(jt)
    assert gh.tolist() == jgh.astype(np.int64).tolist()
    assert gc.tolist() == jgc.tolist()
    # psum-merged histogram
    assert (DS.sorted_histogram(t, 64) == JDS.sorted_histogram(jt, 64)).all()


@DEPTHS
@pytest.mark.parametrize("n,count_mode", [
    (2, "occurrences"), (8, "occurrences"), (8, "barcodes")])
def test_multi_batch_accumulation_equals_jax(sim_lane, n, count_mode, depth):
    """Mirror of test_dist.py::test_scan_stacked_equals_per_batch as a
    multi-batch accumulation: eight 256-row batches through each step."""
    spec, jspec = HashSpec(k=21, w=7, seed=17), JHashSpec(k=21, w=7, seed=17)
    batches = halves(sim_lane, 8)
    t = port_run(spec, n, batches, depth, count_mode=count_mode)
    jt = jax_run(jspec, n, batches, count_mode=count_mode)
    gh, gc = DS.gather_sorted_compact(t)
    jgh, jgc = JDS.gather_sorted_compact(jt)
    assert gh.tolist() == jgh.astype(np.int64).tolist()
    assert gc.tolist() == jgc.tolist()


@DEPTHS
def test_lane_overflow_drops_equal_jax(sim_lane, depth):
    """Eight-slot lanes drop emissions: the port counts exactly the JAX
    package's drops, and delivered plus dropped mass is the whole mass."""
    spec, jspec = HashSpec(k=21, w=7, seed=17), JHashSpec(k=21, w=7, seed=17)
    batches = halves(sim_lane)
    t = port_run(spec, 8, batches, depth, lane_capacity=8)
    jt = jax_run(jspec, 8, batches, lane_capacity=8)
    drops = DS.host_sum(t.group, t.drops)
    assert drops > 0
    assert drops == int(np.asarray(jt.route_drops).sum())
    _, gc = DS.gather_sorted_compact(t)
    _, full = DS.gather_sorted_compact(port_run(spec, 8, batches, depth))
    assert int(gc.sum()) + drops == int(full.sum())


@pytest.mark.parametrize("cf", [4, 0])   # emission_cap_factor (0: full rows)
def test_step_sizing_equals_jax_rules(cf):
    """lane_cap / slots_recv / auto_lane_cap follow the JAX package's rules
    (so --laneCapacity means the same in both)."""
    spec = HashSpec(k=21, w=11, seed=17)
    for n, lane in ((1, 0), (4, 0), (8, 0), (4, 4096)):
        step = DS.SortedCountStep(spec, ShardGroup(n, "cpu"),
                                  lane_capacity=lane, emission_cap_factor=cf)
        per = 4096 // n
        E = per * (min(130, cf * (2 * 130 // 12) + cf) if cf else 130)
        want = lane or (max(E, 8) if n == 1
                        else max(min(E, 2 * E // n + 4096), 8))
        assert step.auto_lane_cap(4096, 150) == want
        exp = per * (2 * 130 // 12 + 1)
        s = (exp + exp // 4 + 4096) if n == 1 else (2 * exp + 4096)
        assert step.slots_recv(4096, 150) == min(
            n * want, ((s + 1023) // 1024) * 1024)


def test_snapshot_portable_across_shards_and_packages(sim_lane, tmp_path):
    """Mirror of test_dist.py::test_snapshot_restore_mesh_portable: saved at
    n = 4, loaded at n = 2 and n = 8 with equal gathered content and range
    ownership; a JAX snapshot loads in the port and the port's in JAX."""
    spec, jspec = HashSpec(k=17, w=5, seed=11), JHashSpec(k=17, w=5, seed=11)
    batches = halves(sim_lane)
    t = port_run(spec, 4, batches)
    gh, gc = DS.gather_sorted_compact(t)
    DS.save_snapshot(t, str(tmp_path / "port"))
    for n in (2, 8):
        t2 = DS.load_snapshot(str(tmp_path / "port"), ShardGroup(n, "cpu"),
                              expect_spec=spec)
        h2, c2 = DS.gather_sorted_compact(t2)
        assert h2.tolist() == gh.tolist() and c2.tolist() == gc.tolist()
        split = DS.range_splitters(spec, n, t2.range_eff)
        for i, row in enumerate(t2.rows):
            k = st.compact(row)[0].numpy()
            assert (np.searchsorted(split, k, side="right") == i).all()
    with pytest.raises(ValueError):
        DS.load_snapshot(str(tmp_path / "port"), ShardGroup(2, "cpu"),
                         expect_spec=HashSpec(k=19, w=5, seed=11))
    jt = jax_run(jspec, 8, batches)
    JDS.save_snapshot(jt, str(tmp_path / "jax"))
    t3 = DS.load_snapshot(str(tmp_path / "jax"), ShardGroup(2, "cpu"))
    h3, c3 = DS.gather_sorted_compact(t3)
    assert h3.tolist() == gh.tolist() and c3.tolist() == gc.tolist()
    jt2 = JDS.load_snapshot(str(tmp_path / "port"), mesh_of(2),
                            capacity=1 << 17)
    jh, jc = JDS.gather_sorted_compact(jt2)
    assert jh.astype(np.int64).tolist() == gh.tolist()
    assert jc.tolist() == gc.tolist()


def test_convert_round_trips_sharded_table(sim_lane):
    spec = HashSpec(k=21, w=7, seed=17)
    t = port_run(spec, 4, halves(sim_lane))
    h, c = convert.sharded_table_to_numpy(t)
    back = convert.sharded_table_from_numpy(h, c, ShardGroup(4, "cpu"),
                                            spec=spec)
    h2, c2 = convert.sharded_table_to_numpy(back)
    assert (h == h2).all() and (c == c2).all()


def test_shard_group_single_process_collectives():
    g = ShardGroup(4, "cpu")
    lanes = torch.arange(4 * 4 * 3).reshape(4, 4, 3)
    recv = g.all_to_all(lanes)
    assert recv.shape == lanes.shape
    for i in range(4):
        for s in range(4):
            assert recv[i, s].tolist() == lanes[s, i].tolist()
    x = torch.tensor([[3, 1], [2, 5], [7, 0], [1, 1]])
    assert g.all_reduce(x, "sum").tolist() == [13, 7]
    assert g.all_reduce(x, "min").tolist() == [1, 0]
    assert g.all_reduce(x, "max").tolist() == [7, 5]
    assert g.all_gather_rows(x).tolist() == x.tolist()
    assert g.host_allgather(np.arange(3)).tolist() == [[0, 1, 2]]
    assert (g.lo, g.hi, g.n_local, g.shard_bits) == (0, 4, 4, 2)
    with pytest.raises(ValueError, match="power of two"):
        ShardGroup(6, "cpu")
    with pytest.raises(ValueError, match="divide"):
        ShardGroup(2, "cpu", world=4, rank=0)
