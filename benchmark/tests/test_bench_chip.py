"""The harness on a CUDA card, and a run that has to print no result: with
no card, or in a directory that holds only the benchmark."""

import io
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.conftest import REPO

ARGS = ["-m", "benchmark.run", "--workload", "chr20_30x_slice.main",
        "--seed", "9", "--seconds", "1", "--trace", "0"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["chr20_30x_slice.main", "chr20_30x.count"])
def test_a_tiny_cell_on_the_card(tiny, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = bench_run.run_cell(cell, 2**31 + 3, 1.0, True,
                           torch.device("cuda", 0), root=tiny,
                           log=io.StringIO())
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert 0 < r["metrics"]["sketch_roofline"]["value"] <= 105
    assert 0 <= r["metrics"]["device_idle_share"]["value"] < 100


def test_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, *ARGS], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout == ""
