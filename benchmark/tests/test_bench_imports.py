"""Nothing the benchmark imports is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import REPO

BENCH = REPO / "benchmark"


def _imports(path):
    """Absolute names of the modules ``path`` imports (relative imports
    resolved against its package)."""
    pkg = list(path.relative_to(REPO).with_suffix("").parts[:-1])
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return names


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not {_top(n) for n in _imports(path)} & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for n in _imports(path):
        assert _top(n) != "hash10x_tpu_torch"
        if _top(n) == "benchmark":
            assert n.startswith("benchmark.reference")


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json;"
                          "print(json.dumps(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=REPO, capture_output=True,
                         text=True, check=True, env=dict(os.environ))
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_chip_path_loads_no_jax():
    top = _loaded("import benchmark.run as r, benchmark.program, "
                  "benchmark.trace, benchmark.control\n"
                  "import benchmark.reference.molecules, "
                  "benchmark.reference.count_table\n"
                  "import torch.profiler")
    assert "hash10x_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import benchmark.reference.molecules, "
                  "benchmark.reference.count_table")
    assert not top & (set(FORBIDDEN) | {"hash10x_tpu_torch"})


def test_the_guard_compares_whole_names(monkeypatch):
    import hash10x_tpu_torch  # noqa: F401  (the port's name begins with
    #                           the JAX package's)
    monkeypatch.setitem(sys.modules, "hash10x_tpu_x.y", sys)
    assert "hash10x_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in forbidden_modules()


# what a later file could load once the window has closed: a metric reader
# or a reference that brings in a module named as JAX or the JAX package
PLANTS = {
    "none": {},
    "metric_reader": {
        "benchmark/metrics/loads_jax.py":
            "import sys, types\n\n\ndef read(ctx):\n"
            "    sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
            "    return 1.0\n"},
    "reference": {
        "benchmark/reference/count_table.py":
            "import sys, types\n\nfrom . import pipeline  # noqa: F401\n"
            "from .count_table_plain import reference as _plain\n\n\n"
            "def reference(*a, **kw):\n"
            "    sys.modules.setdefault('hash10x_tpu.core',"
            " types.ModuleType('hash10x_tpu.core'))\n"
            "    return _plain(*a, **kw)\n"},
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_a_run_that_loads_jax_prints_no_result(tmp_path, plant):
    """The harness looks at the loaded modules last, once the readers and the
    reference have run: a planted load leaves no result."""
    import shutil

    from benchmark.tests.conftest import tiny_root
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny_root(tmp_path)
    cell = "chr20_30x.count"
    shutil.copy(tmp_path / "benchmark/reference/count_table.py",
                tmp_path / "benchmark/reference/count_table_plain.py")
    for rel, text in PLANTS[plant].items():
        (tmp_path / rel).write_text(text)
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["end_to_end"].append({"name": "loads_jax", "unit": "s",
                            "better": "lower", "bound": 0.1,
                            "source": "host_clock", "workloads": [cell]})
    if plant != "metric_reader":
        m["end_to_end"].pop()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from benchmark import run\n"
            "real = run.run_cell\n"
            "run.run_cell = lambda w, s, sec, tr, dev: real("
            "w, s, sec, tr, torch.device('cpu'))\n"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '5', "
            "'--seconds', '0.2', '--trace', '0']))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{REPO}"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    if plant == "none":
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
    else:
        assert out.returncode != 0 and out.stdout == ""
        name = "jax" if plant == "metric_reader" else "hash10x_tpu"
        assert f"loaded by the run: {name}" in out.stderr
