"""The whole slice: the port's CLI (``--device cpu``) against
``python -m hash10x_tpu``'s CLI and the C stand-in ``native/c_ref`` on one
FQB lane, plus the port's guarantees that it never imports JAX and never
runs on the CPU unless asked.  Comparisons are byte-exact; the one allowed
difference is the number after ``table slots`` (each package grows its
count table on its own schedule)."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hash10x_tpu.cli.main import main as jax_main
from hash10x_tpu_torch.cli.main import main, run
from hash10x_tpu_torch.core.encode import pack_2bit
from hash10x_tpu_torch.io.fqb import Fqb, save_fqb
from hash10x_tpu_torch.kernels import minimizer as MK

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
K, W, SEED, SHARE = 21, 7, 17, 4
PARAMS = ["-k", str(K), "-w", str(W), "-r", str(SEED), "-B", "14",
          "--minCount", "2", "--maxCount", "64", "--friendShare", str(SHARE)]
SIM = ("genome_len=20000,n_barcodes=6,molecules_per_barcode=1,"
       "molecule_len=3000,reads_per_molecule=20,read_len=100,seed=2")
SLOTS = re.compile(r"^table slots \d+ ", re.M)


def _cmds(lane, tmp, tag):
    return ["--readFQB", lane, "--hashInfo", "--hashDist", "--codeClusters",
            "--clusterSplit", "--clusterReport",
            "--writeCounts", str(tmp / f"{tag}.counts"),
            "--writeClusters", str(tmp / f"{tag}.clusters")]


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """A molecule lane (the tests/test_c_ref.py pattern) as .fqb and as the
    C stand-in's binary inputs, and the JAX CLI's output on it."""
    tmp = tmp_path_factory.mktemp("lane")
    rng = np.random.default_rng(0)
    n_reads, n_codes, L = 3000, 60, 120
    genome = rng.integers(0, 4, size=400_000).astype(np.uint8)
    mol_starts = rng.integers(0, len(genome) - 12_000, size=n_codes)
    bc = np.repeat(np.arange(n_codes, dtype=np.int32), n_reads // n_codes)
    offs = rng.integers(0, 12_000 - L, size=len(bc))
    reads = genome[(mol_starts[bc] + offs)[:, None] + np.arange(L)]
    fqb = str(tmp / "lane.fqb")
    save_fqb(fqb, Fqb(packed=pack_2bit(reads),
                      lengths=np.full(n_reads, L, np.int32), barcode_ids=bc,
                      barcode_keys=np.arange(n_codes, dtype=np.uint32),
                      read_len=L))
    rb, bb = tmp / "reads.bin", tmp / "bc.bin"
    with open(rb, "wb") as f:
        np.array([n_reads, L], np.uint32).tofile(f)
        reads.tofile(f)
    bc.astype(np.uint32).tofile(bb)
    out, err = io.StringIO(), io.StringIO()
    assert jax_main(PARAMS + _cmds(fqb, tmp, "jax"), out=out, err=err) == 0
    return dict(tmp=tmp, fqb=fqb, rb=str(rb), bb=str(bb),
                jax_out=out.getvalue())


@pytest.fixture(scope="module")
def port(lane):
    out, err = io.StringIO(), io.StringIO()
    plain0, launches0 = MK.PLAIN_CALLS, MK.LAUNCHES
    assert main(["--device", "cpu"] + PARAMS
                + _cmds(lane["fqb"], lane["tmp"], "port"),
                out=out, err=err) == 0
    return dict(out=out.getvalue(), err=err.getvalue(),
                plain=MK.PLAIN_CALLS - plain0,
                launches=MK.LAUNCHES - launches0)


def _read(path):
    with open(path) as f:
        return f.read()


def test_cli_output_matches_jax_cli(lane, port):
    jo, to = lane["jax_out"], port["out"]
    assert "code 59 nKmers" in to and to.startswith("table slots ")
    assert SLOTS.sub("table slots N ", to) == SLOTS.sub("table slots N ", jo)
    tmp = lane["tmp"]
    for ext in ("counts", "clusters"):
        assert _read(tmp / f"port.{ext}") == _read(tmp / f"jax.{ext}"), ext
    assert port["plain"] > 0 and port["launches"] == 0
    for stage in ("[count:", "[incidence:", "[cluster:", "[split:", "[report:"):
        assert stage in port["err"]


def test_cli_output_matches_c_ref(lane, port, tmp_path):
    exe = str(tmp_path / "hash10x_ref")
    subprocess.run(["gcc", "-O2", "-o", exe,
                    os.path.join(ROOT, "native", "c_ref", "hash10x_ref.c")],
                   check=True, capture_output=True)
    dump, clus, rep = (str(tmp_path / n) for n in
                       ("counts.bin", "clusters.txt", "report.txt"))
    subprocess.run([exe, lane["rb"], str(K), str(W), str(SEED), "20",
                    "--barcodes", lane["bb"], "--minCount", "2",
                    "--maxCount", "64", "--friendShare", str(SHARE),
                    "--cluster", "--dump", dump, "--dumpClusters", clus,
                    "--report", rep], check=True, capture_output=True)
    with open(dump, "rb") as f:
        m = int(np.fromfile(f, np.uint64, 1)[0])
        hashes = np.fromfile(f, np.uint64, m)
        counts = np.fromfile(f, np.uint32, m)
    c_counts = "".join(f"{int(h):x}\t{int(c)}\n"
                       for h, c in zip(hashes, counts))
    assert _read(lane["tmp"] / "port.counts") == c_counts
    assert _read(lane["tmp"] / "port.clusters") == _read(clus)
    out = port["out"]
    assert out[out.index("code 0 nKmers"):] == _read(rep)


def test_port_never_imports_jax(tmp_path):
    code = ("import sys, io\n"
            "from hash10x_tpu_torch.cli.main import main\n"
            f"main(['--device', 'cpu', '--simulate', {SIM!r}, '--hashInfo',"
            " '--codeClusters', '--clusterSplit', '--clusterReport'],"
            " out=io.StringIO(), err=io.StringIO())\n"
            "import hash10x_tpu_torch.convert, hash10x_tpu_torch.engine\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'hash10x_tpu'))\n"
            "assert not bad, bad\n"
            "print('no jax')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "no jax"


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check needs none")
    with pytest.raises(SystemExit, match="--device cpu"):
        run(["--simulate", SIM, "--hashInfo"], io.StringIO(), io.StringIO())


def test_help_and_unknown_flag():
    out = io.StringIO()
    assert main(["--help"], out=out) == 0
    assert "--device" in out.getvalue() and "--codeClusters" in out.getvalue()
    with pytest.raises(SystemExit, match="unknown argument"):
        run(["--nonsense"], io.StringIO(), io.StringIO())
