"""BENCHMARK.json against the contract's form, and every file it names
found by name."""
import re

import pytest

from ttbench import harness
from ttbench.tests.tiny import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    m = manifest()
    assert set(m) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32
    assert all(one_line(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in m["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in m["paths"])


def test_run_seconds_fits_the_full_check():
    rs = manifest()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    m = manifest()
    names = [e["name"] for e in m[kind]]
    assert len(names) == len(set(names))
    for e in m[kind]:
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert one_line(e[key])
        if kind == "configs":
            assert one_line(e["source"])


def test_configs_found_by_name():
    m = manifest()
    assert 1 <= len(m["configs"]) <= 24
    files = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"ttbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert (harness.HERE / "inputs" / f"{cfg['kind']}.py").exists()
        assert any(w["config"] == c["name"] for w in m["workloads"])


def test_cells_found_by_name_and_complete():
    m = manifest()
    assert 1 <= len(m["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)
    pairs = set()
    configs = {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.Cell(m, w["name"])
        assert (harness.HERE / "methods" /
                f"{cell.traffic['method']}.py").exists()
        for part in ("request", "reference", "work"):
            assert callable(getattr(cell.method, part))
        e2e = {x["name"] for x in cell.metrics["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics["per_layer"]
        for metric in cell.metrics["per_layer"]:
            assert metric["moves"] in e2e


def test_metrics_found_by_name():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(m["per_layer"]) <= 128
    cells = {w["name"] for w in m["workloads"]}
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        assert set(x.get("workloads", cells)) <= cells
        assert (harness.HERE / "metrics" / f"{x['name']}.py").exists()
    assert e2e["setup_s"]["bound"] == 0.25
    layers = {}
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert x["moves"] in e2e
        listed = set(x.get("workloads", cells))
        assert listed <= cells
        assert listed <= set(e2e[x["moves"]].get("workloads", cells))
        assert (harness.HERE / "metrics" / f"{x['name']}.py").exists()
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_traffic_files_are_data():
    for w in manifest()["workloads"]:
        t = harness.load_json(harness.HERE / "traffic" / f"{w['name']}.json")
        limits = t["check"]["limits"]
        assert limits and all(0 < v < 1 for v in limits.values())
        assert t["check"]["control"] in ("tf32", "bfloat16")
