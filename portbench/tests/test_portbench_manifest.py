"""BENCHMARK.json against the benchmark's contract, and every name it holds
resolving to its files."""
import json
import math
import os
import re

import pytest

from tiny import REPO  # noqa: F401  (puts the repository on the path)

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert os.path.getsize(os.path.join(manifest.REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in bench[group]}) == len(bench[group])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_what_the_contract_asks(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.cell(bench, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e
            assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("group", ["configs", "traffic", "limits"])
def test_every_name_resolves(bench, group):
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        if group == "configs":
            conf = cell["config_entry"]
            path = os.path.join(manifest.REPO, conf["file"])
            assert conf["file"].startswith("portbench/") and os.path.isfile(path)
            with open(path) as f:
                body = json.load(f)
            assert body["reduced"] == conf["reduced"]
            assert set(body["config"]) == {"encoder", "model", "train", "data", "verbose", "out_dir"}
        elif group == "traffic":
            assert cell["traffic"]["kind"] in manifest.RUNNERS
        else:
            assert cell["limits"] and all(math.isfinite(v) and v >= 0 for v in cell["limits"].values())


def test_no_file_outside_paths(bench):
    for word in bench["command"][1:]:
        assert word.startswith(tuple(bench["paths"]))
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
