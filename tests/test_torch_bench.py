"""The port's bench (``python -m hash10x_tpu_torch.bench``) at tiny sizes on
the CPU: every point function returns its named keys and keeps its labels
and tables equal within the point; the summary line parses and stays under
4 KB; without a CUDA device ``main`` prints one JSON line and exits
non-zero; the port and ``chip_smoke.py`` import nothing of JAX; the bench
writes its own detail file, never the JAX bench's ``BENCH_DETAIL.json``.
Times taken here are CPU times and are checked for shape only."""

import ast
import io
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from hash10x_tpu_torch import bench as B

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SPREAD = {"median", "min", "max", "runs"}


def _is_spread(x, runs=2):
    return set(x) == SPREAD and x["runs"] == runs and \
        x["min"] <= x["median"] <= x["max"]


@pytest.fixture(scope="module")
def points():
    """Every point at a tiny size (two runs each), as main() orders them."""
    reads = B.make_lane(2048)
    hot, cold = B.bench_engine(reads, CPU, runs=2, batch=512)
    floor = B.launch_floor_ms(CPU, runs=2, reps=5)
    with tempfile.TemporaryDirectory() as tmp:
        exe = B.c_ref_exe(tmp)
        c = B.bench_c(exe, tmp, reads, runs=2)
        bc = B.bench_barcodes(2400, 48, CPU, floor["median"], runs=2,
                              genome_len=400_000, c_exe=exe, tmp=tmp)
    bc["name"] = "engine_barcodes_2400_reads_48_codes"
    return {"c": c, "floor": floor, "hot": hot, "cold": cold, "bc": bc,
            "breakdown": B.bench_breakdown(reads, CPU, floor, runs=2,
                                           batch=256, cap=1 << 10,
                                           bufc=1 << 11, steps=2),
            "routing": B.bench_routing_ab(reads, CPU, runs=2, batch=512),
            "cluster": B.bench_cluster(CPU, 1500, 15_000, 30, runs=2),
            "shards": B.bench_shards_curve(
                CPU, 1024, 256, shards=(1, 2, 4), cluster_shards=(2, 4),
                cluster_size=(256, 4096, 24), runs=2)}


def test_inputs_are_the_jax_bench_generators():
    sys.path.insert(0, str(ROOT))
    import bench as jax_bench   # the JAX package's bench (JAX imported lazily)
    assert (B.make_lane(300) == jax_bench.make_lane(300)).all()
    reads, bc = B.make_barcodes_lane(200, 10, genome_len=100_000)
    assert reads.shape == (200, 150) and (bc == np.repeat(np.arange(10),
                                                          20)).all()
    assert (B.READ_LEN, B.BATCH, B.K, B.W, B.SEED) == (
        jax_bench.READ_LEN, jax_bench.BATCH, jax_bench.K, jax_bench.W,
        jax_bench.SEED)
    assert (B.N_READS, B.BC_READS, B.BC_CODES, B.C_SUBSET) == (
        jax_bench.N_READS, jax_bench.BC_READS, jax_bench.BC_CODES,
        jax_bench.C_SUBSET)


def test_engine_count_points(points):
    hot, cold = points["hot"], points["cold"]
    assert (hot["name"], cold["name"]) == ("engine_count_hot",
                                           "engine_count_cold")
    for p in (hot, cold):
        assert _is_spread(p["wall_s"]) and p["reads_per_s"] > 0
        assert p["n_reads"] == 2048 and p["n_kmers"] > 10_000
        # 4 batches of 512 reads: one step of up to flush_batches (16)
        assert p["dispatches"] == 1 and p["flushes"] >= 1
    assert points["c"]["n_reads"] == 2048 and points["c"]["reads_per_s"] > 0
    assert _is_spread(points["floor"])


def test_breakdown_point(points):
    p = points["breakdown"]
    assert p["name"] == "count_breakdown"
    for k in ("launch_floor_ms", "step_ms_per_batch", "flush_merge_ms"):
        assert _is_spread(p[k]), k
    # no kernel on the CPU: its device time is not measured here
    assert p["kernel_only_ms_per_batch"] is None
    assert p["compact_to"] == 64 and p["kernel_bound_by"] in ("bytes",
                                                              "operations")
    # the flush sorts the buffer and merges it into the half-full table
    assert p["flush_sorted_elements"] == 1 << 11
    assert p["flush_sorts"] == 1 and p["flush_digit_passes"] == 8
    assert p["flush_merge_bytes"] == ((1 << 9) + (1 << 11)) * 12 * 2
    assert p["flush_bound_ms"] == pytest.approx(
        (8 * (1 << 11) * 16 * 2 + ((1 << 9) + (1 << 11)) * 12 * 2)
        / 3.35e12 * 1e3)


def test_barcodes_point(points):
    p = points["bc"]
    assert set(p["warm"]) == {"count_s", "filter_incidence_s", "cluster_s",
                              "split_s", "report_s",
                              "reads_per_s_end_to_end"}
    assert all(_is_spread(v) for v in p["warm"].values())
    assert p["molecules"] > 48 and p["n_pairs"] > 1000
    assert p["c_molecules"] == p["molecules"] and p["correct"] is True
    assert p["vs_c_full_pipeline"] > 0
    a = p["attribution"]
    assert a["count"]["dispatches"] == a["incidence"]["dispatches"] == 1
    assert a["count"]["flushes"] >= 1
    prof = p["profile"]
    assert prof["busy_ms"] == 0.0 and prof["top_device_ms"] == []  # no card


def test_routing_cluster_and_shards_points(points):
    r = points["routing"]
    assert r["name"] == "routing_ab_1chip" and r["tables_equal"]
    assert _is_spread(r["wall_s"]) and _is_spread(r["plain_wall_s"])
    assert "does not run the lane code" in r["note"]
    c = points["cluster"]
    assert c["name"] == "cluster_200k_codes" and c["labels_equal"]
    assert _is_spread(c["wall_warm_s"]) and c["n_pairs"] > 30_000
    assert 1500 <= c["molecules"] <= c["n_pairs"]
    s = points["shards"]
    assert s["name"] == "shards_curve_one_card" and s["labels_equal"]
    assert [x["n_shards"] for x in s["count_curve"]] == [1, 2, 4]
    assert [x["n_shards"] for x in s["cluster_curve"]] == [1, 2, 4]
    assert "cost of sharding" in s["note"] and s["n_kmers"] > 10_000


def test_summary_line_parses_under_4kb(points, tmp_path):
    detail = tmp_path / "chiprun_out" / "bench_torch_detail.json"
    out = io.StringIO()
    summ = B.Summary(1200.0, {"name": "test", "power_limit": "n/a"},
                     detail=detail, out=out)
    summ.points = [points[k] for k in ("hot", "cold", "bc", "breakdown",
                                       "routing", "cluster", "shards")]
    summ.skipped.append({"name": "x", "reason": "budget"})
    summ.emit(final=True)
    line = out.getvalue().splitlines()[-1]
    assert len(line.encode()) < 4096
    head = json.loads(line)
    for k in ("metric", "value", "unit", "vs_baseline", "points_brief",
              "skipped", "budget_s", "elapsed_s", "device"):
        assert k in head, k
    assert head["metric"] == "count_pass_reads_per_s"
    assert [b["name"] for b in head["points_brief"]][:2] == [
        "engine_count_hot", "engine_count_cold"]
    assert json.loads(detail.read_text())["points"][2]["correct"] is True
    # many points: the line drops to names and still parses under 4 KB
    summ.points = summ.points * 12
    assert len(summ.line().encode()) < 4096
    json.loads(summ.line())


def test_plan_names_skipped_and_failed_points(points, tmp_path):
    out = io.StringIO()
    summ = B.Summary(100.0, {}, detail=tmp_path / "d.json", out=out)

    def broken():
        raise RuntimeError("lane overflow")
    B.run_plan(summ, [("fits", lambda: points["routing"]),
                      ("too_long", lambda: points["cluster"]),
                      ("broken", broken)],
               {"fits": 1, "too_long": 1e6, "broken": 1})
    assert [p["name"] for p in summ.points] == ["routing_ab_1chip"]
    reasons = {s["name"]: s["reason"] for s in summ.skipped}
    assert reasons["too_long"].startswith("budget: ")
    assert reasons["broken"] == "RuntimeError: lane overflow"
    lines = out.getvalue().splitlines()
    assert len(lines) == 3          # the summary after every point
    assert json.loads(lines[-1])["skipped"] == summ.skipped


@pytest.mark.parametrize("outcome,rc", [("ran", 0), ("budget", 0),
                                        ("raised", 1)])
def test_main_exits_1_when_a_point_raised(monkeypatch, tmp_path, capsys,
                                          outcome, rc):
    """``main`` with the card's calls stubbed: every point runs, or one is
    skipped for the budget (exit 0), or one raises (exit 1, after the
    points behind it ran and the final summary line was printed)."""
    ran = []

    def point(name):
        def fn(*a, **kw):
            if outcome == "raised" and name == "routing":
                raise RuntimeError("lane overflow")
            ran.append(name)
            return {"name": name}
        return fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(B, "card_info", lambda: {})
    monkeypatch.setattr(B, "c_ref_exe", lambda tmp: "c_ref")
    monkeypatch.setattr(B, "make_lane", lambda: np.zeros((4, 150), np.uint8))
    monkeypatch.setattr(B, "bench_c", lambda *a: {"reads_per_s": 1.0})
    monkeypatch.setattr(B, "bench_engine", lambda *a: (
        {"name": "hot", "reads_per_s": 2.0}, {"name": "cold"}))
    monkeypatch.setattr(B, "launch_floor_ms", lambda d: {"median": 0.01})
    for fn, name in (("bench_barcodes", "barcodes"),
                     ("bench_breakdown", "breakdown"),
                     ("bench_routing_ab", "routing"),
                     ("bench_cluster", "cluster"),
                     ("bench_shards_curve", "shards")):
        monkeypatch.setattr(B, fn, point(name))
    summary = B.Summary
    monkeypatch.setattr(B, "Summary", lambda budget, info: summary(
        budget, info, detail=tmp_path / "d.json", out=sys.stdout))
    if outcome == "budget":
        monkeypatch.setitem(B.ESTIMATES, "cluster_200k_codes", 1e9)
    assert B.main() == rc
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["final"] is True
    want = ["barcodes", "breakdown", "routing", "cluster", "shards"]
    if outcome == "raised":
        want.remove("routing")
    if outcome == "budget":
        want.remove("cluster")
        assert last["skipped"][0]["reason"].startswith("budget: ")
    assert ran == want


def test_bench_never_writes_the_jax_bench_detail(points, tmp_path):
    assert B.DETAIL == ROOT / "chiprun_out" / "bench_torch_detail.json"
    jax_detail = ROOT / "BENCH_DETAIL.json"
    before = jax_detail.read_bytes()
    summ = B.Summary(10.0, {}, detail=tmp_path / "d.json", out=io.StringIO())
    summ.points = [points["hot"]]
    summ.emit()
    assert jax_detail.read_bytes() == before
    assert "BENCH_DETAIL" not in Path(B.__file__).read_text()


def test_main_without_cuda_prints_one_line_and_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main() != 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert head["value"] == 0 and "no CUDA device" in head["note"]
    r = subprocess.run([sys.executable, "-m", "hash10x_tpu_torch.bench"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert json.loads(r.stdout.strip().splitlines()[-1])["value"] == 0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "hash10x_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "hash10x_tpu"), (f, name)
        text = f.read_text()
        assert "import jax" not in text and "hash10x_tpu." not in \
            text.replace("hash10x_tpu_torch", ""), f
