"""``BENCHMARK.json`` holds to the benchmark's contract: its keys, names,
units, bounds and cells, and a file for every configuration, traffic mix
and metric it names."""

import json
import re

import pytest

from benchmark.tests.conftest import REPO

M = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = {w["name"]: w for w in M["workloads"]}
E2E = {m["name"]: m for m in M["end_to_end"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(map(_line, M["command"]))
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and (REPO / p).is_dir()


def test_run_seconds_fit_a_full_check():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(M["paths"][0] + "/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert "source" in cfg and "assumed" in cfg
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24 and len(CELLS) == len(
        M["workloads"])
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        traffic = json.loads((REPO / "benchmark/traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (REPO / "benchmark/reference"
                / f"{traffic['reference']}.py").is_file()
        assert traffic["compare"] and all(
            c["outputs"] and c["limit"] >= 0
            for c in traffic["compare"].values())
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(M["workloads"])


@pytest.mark.parametrize("m", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (REPO / "benchmark/metrics" / f"{m['name']}.py").is_file()
    assert set(m.get("workloads", [])) <= set(CELLS)
    if m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_every_cell_reports_enough():
    assert E2E["setup_s"]["bound"] <= 0.25
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    for cell in CELLS:
        e2e = {m["name"] for m in M["end_to_end"]
               if cell in m.get("workloads", [cell])}
        layer = [m for m in M["per_layer"]
                 if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
