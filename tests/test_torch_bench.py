"""The port's lane generators (``hash10x_tpu_torch/bench.py``) are the JAX
package's bench's, and the port and ``chip_smoke.py`` import nothing of
JAX."""

import ast
import sys
from pathlib import Path

import numpy as np

from hash10x_tpu_torch import bench as B

ROOT = Path(__file__).resolve().parent.parent


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
