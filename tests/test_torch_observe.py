"""The port's observability flags (``--metrics``, ``--devMem``,
``--profile``) against ``python -m hash10x_tpu``, and its native FASTQ
loader (``hash10x_tpu_torch/io/native_loader.py``, the shared
``native/loader/h10x_loader.c``) against the numpy parser."""

import gzip
import io
import json
import os

import numpy as np
import pytest
import torch

from hash10x_tpu.cli.main import main as jax_main
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu_torch.cli.main import main
from hash10x_tpu_torch.io import fqb as FB
from hash10x_tpu_torch.io import native_loader
from hash10x_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)

SIM = ("genome_len=20000,n_barcodes=6,molecules_per_barcode=1,"
       "molecule_len=3000,reads_per_molecule=20,read_len=100,seed=2")
CMDS = ["-k", "15", "-w", "5", "-B", "14", "--simulate", SIM, "--hashInfo",
        "--errorFix", "1", "--codeClusters", "--clusterSplit",
        "--clusterReport"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_jsonl_matches_jax_cli(tmp_path):
    """Same stage labels and keys as the JAX CLI; the port also times
    --clusterReport (a stage the JAX package does not time).  --devMem is
    accepted on the CPU and adds nothing there in either package."""
    recs = {}
    for name, fn, pre in (("jax", jax_main, []),
                          ("port", main, ["--device", "cpu"])):
        path = str(tmp_path / f"{name}.jsonl")
        err = io.StringIO()
        assert fn(pre + ["--metrics", path, "--devMem"] + CMDS,
                  out=io.StringIO(), err=err) == 0
        recs[name] = _records(path)
        assert len(recs[name]) == err.getvalue().count("\n")
    port = [r for r in recs["port"] if not r["stage"].startswith("report:")]
    assert len(port) == len(recs["port"]) - 1
    assert [r["stage"] for r in port] == [r["stage"] for r in recs["jax"]]
    assert [sorted(r) for r in recs["port"]] == \
        [sorted(recs["jax"][0])] * len(recs["port"])
    assert "hbm_in_use_mb" not in recs["port"][0]
    t = [r["t_total_s"] for r in recs["port"]]
    assert t == sorted(t) and all(r["wall_s"] >= 0 for r in recs["port"])


def test_stage_timer_sinks(tmp_path):
    path = tmp_path / "m.jsonl"
    silent = StageTimer(None)
    assert not silent.enabled
    silent.stage("nothing")
    log = io.StringIO()
    timer = StageTimer(log, str(path), device_mem=True, device="cpu")
    assert timer.enabled
    timer.stage("one")
    timer.close()
    timer.stage("two")             # stderr only after close
    assert [r["stage"] for r in _records(path)] == ["one"]
    assert log.getvalue().startswith("[one] wall ") and "[two]" in \
        log.getvalue() and "HBM" not in log.getvalue()
    assert timer.total() >= 0


def test_profile_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    err = io.StringIO()
    out = io.StringIO()
    assert main(["--device", "cpu", "--profile", str(trace_dir)] + CMDS,
                out=out, err=err) == 0
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]
    assert f"[profile] trace written to {trace_dir}" in err.getvalue()
    assert "code 5 nKmers" in out.getvalue()


# -- native FASTQ loader -----------------------------------------------------

def _write_fastq(path, recs):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for name, seq in recs:
            f.write(b"@" + name + b"\n" + seq + b"\n+\n"
                    + b"I" * len(seq) + b"\n")


def _lane_records(rng, n=60):
    """Records with invalid barcodes (an N), N bases in the sequence, lower
    case, and lengths 20-140 after the barcode."""
    bases = b"ACGT"
    recs = []
    for i in range(n):
        bc = bytearray(bases[b] for b in rng.integers(0, 4, 16))
        if i % 7 == 0:
            bc[3] = ord("N")
        seq = bytearray(bases[b] for b in rng.integers(0, 4,
                                                      rng.integers(20, 141)))
        if i % 5 == 0:
            seq[10] = ord("N")
        if i % 11 == 0:
            seq = seq.lower()
        recs.append((b"r%d" % i, bytes(bc) + bytes(seq)))
    return recs


def _same_fqb(a, b):
    assert a.read_len == b.read_len
    for f in ("packed", "lengths", "barcode_ids", "barcode_keys"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and (x == y).all(), f
    assert (a.nmask is None) == (b.nmask is None)
    if a.nmask is not None:
        assert (a.nmask == b.nmask).all()


@pytest.mark.parametrize("name", ["lane.fastq", "lane.fastq.gz"])
def test_native_loader_matches_numpy(tmp_path, rng, name):
    assert native_loader.available(), "gcc could not build the loader"
    p = tmp_path / name
    _write_fastq(p, _lane_records(rng))
    native = FB.fastq_to_fqb(p, prefer_native=True)
    plain = FB.fastq_to_fqb(p, prefer_native=False)
    _same_fqb(native, plain)
    _same_fqb(native, JFB.fastq_to_fqb(p, prefer_native=False))
    assert native.nmask is not None and (native.barcode_ids == -1).any()
    so = list(native_loader.BUILD_DIR.glob("h10x_loader_*.so"))
    assert so, "the loader was not built into _build/"
    capped = FB.fastq_to_fqb(p, max_len=50)
    _same_fqb(capped, FB.fastq_to_fqb(p, max_len=50, prefer_native=False))


def test_native_loader_rejects_malformed(tmp_path):
    p = tmp_path / "bad.fastq"
    p.write_bytes(b"not a fastq\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="malformed"):
        native_loader.load_fastq_native(p)
    with pytest.raises(OSError):
        native_loader.load_fastq_native(tmp_path / "missing.fastq")


def test_read_fastq_cli_matches_jax_cli(tmp_path):
    """--readFastq through the native loader gives the JAX CLI's output."""
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 30_000)
    recs = []
    for i in range(400):
        bc = np.array([(i // 40) >> (2 * (15 - j)) & 3 for j in range(16)])
        s = int(rng.integers(0, len(genome) - 120))
        seq = np.concatenate([bc, genome[s:s + 100]])
        recs.append((b"r%d" % i, bytes(b"ACGT"[c] for c in seq)))
    p = tmp_path / "lane.fastq"
    _write_fastq(p, recs)
    outs = []
    for fn, pre in ((jax_main, []), (main, ["--device", "cpu"])):
        out = io.StringIO()
        assert fn(pre + ["-k", "15", "-w", "5", "-B", "14", "--friendShare",
                         "2", "--readFastq", str(p), "--hashDist",
                         "--codeClusters", "--clusterReport"],
                  out=out, err=io.StringIO()) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and "code 9 nKmers" in outs[1]
    assert os.path.getsize(p) > 0
