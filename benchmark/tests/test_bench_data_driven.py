"""A later change adds a cell, a traffic mix, a reference and a metric by
adding files and manifest entries alone: in a copy of the benchmark, a new
configuration, traffic files, a reference and a metric reader make runnable
cells, and no file of the copy is edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.conftest import REPO, TINY


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    cfg = json.loads((REPO / "benchmark/configs/chr20_30x.json").read_text())
    n, codes, genome = TINY["chr20_30x"]
    cfg.update(n_reads=n // 2, n_barcodes=codes // 2, genome_len=genome,
               table_bits=12, batch_reads=1000)
    return cfg


def _add(tmp_path, files: dict, configs=(), cells=(), per_layer=()):
    for rel, text in files.items():
        (tmp_path / rel).write_text(text)
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"] += list(configs)
    m["workloads"] += list(cells)
    m["per_layer"] += list(per_layer)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))


def _run(tmp_path, cell, trace):
    code = ("import json, torch\nfrom benchmark.run import run_cell\n"
            f"print(json.dumps(run_cell({cell!r}, 12, 0.3, {trace}, "
            "torch.device('cpu'))))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def _tiny():
    return {"name": "tiny", "source": "a test",
            "file": "benchmark/configs/tiny.json", "reduced": [],
            "why": "a test"}


def _cell(name, traffic):
    return {"name": name, "config": "tiny", "traffic": traffic, "chips": 1,
            "why": "a test"}


def test_a_cell_added_by_files_alone(tmp_path):
    cfg = _copy(tmp_path)
    before = _digests(tmp_path)
    traffic = json.loads((REPO / "benchmark/traffic/main.json").read_text())
    traffic["engine"] = {"flush_batches": 1}
    cell = "tiny.one_batch_steps"
    _add(tmp_path, {
        "benchmark/configs/tiny.json": json.dumps(cfg),
        "benchmark/traffic/one_batch_steps.json": json.dumps(traffic),
        "benchmark/metrics/passes_in_window.py":
            "def read(ctx):\n"
            "    return len(ctx['passes']) * 1000 + ctx['passes'][0]"
            "['stats']['dispatches']\n"},
        configs=[_tiny()], cells=[_cell(cell, "one_batch_steps")],
        per_layer=[{"name": "passes_in_window", "unit": "passes",
                    "better": "higher", "source": "host_clock",
                    "layer": "engine count pass", "moves": "reads_per_s",
                    "workloads": [cell]}])
    r = _run(tmp_path, cell, True)
    assert r["correct"] is True
    passes, steps = divmod(r["metrics"]["passes_in_window"]["value"], 1000)
    # flush_batches 1: a step per batch, four batches of 1,000 reads in
    # each of count and incidence
    assert passes >= 1 and steps == 8
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(tmp_path) for p in
        (tmp_path / "benchmark/configs/tiny.json",
         tmp_path / "benchmark/traffic/one_batch_steps.json",
         tmp_path / "benchmark/metrics/passes_in_window.py")}


# a reference that a new mix brings: the band alone, its own file
BAND_REFERENCE = """
from . import pipeline


def reference(lane, cfg, device, control=False):
    packed, bcs = pipeline.on_device(lane, device)
    lo, hi = cfg["band"]
    retained, counts, _, _, emitted = pipeline.band_and_incidence(
        packed, bcs, lane.read_len, lane.n_codes, cfg["k"], cfg["w"],
        cfg["hash_seed"], lo, hi, distinct_barcodes=not control)
    return {"band": [retained, counts]}, {"emitted": emitted}
"""


def test_count_only_mixes_added_by_files_alone(tmp_path):
    """A count-only mix that names the count table's reference, and a
    band-only mix that brings a reference of its own: files alone."""
    cfg = _copy(tmp_path)
    before = _digests(tmp_path)
    count = {"why": "count and histogram", "stages": [
        {"span": "count", "call": "count", "args": ["lane"]},
        {"span": "histogram", "call": "histogram", "keep": "histogram"}],
        "reference": "count_table",
        "compare": {"histogram": {"outputs": ["histogram"], "limit": 0}}}
    band = {"why": "count and band", "stages": [
        {"span": "count", "call": "count", "args": ["lane"]},
        {"span": "band", "call": "filter"}],
        "reference": "band_only",
        "compare": {"band": {"outputs": ["retained_hashes",
                                         "retained_counts"], "limit": 0}}}
    _add(tmp_path, {
        "benchmark/configs/tiny.json": json.dumps(cfg),
        "benchmark/traffic/count_only.json": json.dumps(count),
        "benchmark/traffic/band_only.json": json.dumps(band),
        "benchmark/reference/band_only.py": BAND_REFERENCE},
        configs=[_tiny()], cells=[_cell("tiny.count_only", "count_only"),
                                     _cell("tiny.band_only", "band_only")])
    for cell, checks in (("tiny.count_only", {"histogram"}),
                         ("tiny.band_only", {"band"})):
        for trace in (False, True):
            r = _run(tmp_path, cell, trace)
            assert r["correct"] is True and set(r["checks"]) == checks
            if trace:
                # no per-layer metric lists these cells
                assert r["metrics"] == {} and "breakdown" in r
            else:
                assert r["metrics"]["reads_per_s"]["value"] > 0
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before
    assert len(set(after) - set(before)) == 4
