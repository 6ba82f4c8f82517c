"""Fixtures of the benchmark's tests: tiny copies of the cells, made in a
temporary root that holds ``BENCHMARK.json`` and the configurations."""

import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# the configurations' shape at a CPU test's size: (reads, barcodes, genome),
# 40 reads a barcode at 30x
TINY = {"chr20_30x_slice": (8000, 200, 400_000),
        "chr20_30x": (8000, 200, 400_000)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


def tiny_root(tmp: Path) -> Path:
    """A root whose ``BENCHMARK.json`` is the repository's and whose
    configuration files are cut to ``TINY`` (table bits 12)."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        n, codes, genome = TINY[c["name"]]
        cfg.update(n_reads=n, n_barcodes=codes, genome_len=genome,
                   table_bits=12)
        path = tmp / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
