"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) resolves to:

- its configuration: ``configs[].file``, a JSON object whose ``config`` is
  the port's whole ``Config`` as a nested dict;
- its traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind``
  picks the runner (``train``: ``train_cell.py``; ``serve_open``:
  ``serve_cell.py``);
- the limits of its comparison: ``portbench/limits/<workload>.json``;
- its metrics: every end-to-end metric that lists it (or lists no cell),
  every per-layer metric that lists it (or, listing none, moves one of
  those), each per-layer one read by ``portbench/metrics/<name>.py``, or
  where there is no such file by the reader of the name's part before its
  first dot (``idle_share.py`` reads ``idle_share.train`` and
  ``idle_share.serve``).

A cell, a mix, a configuration or a per-layer metric is added by adding its
files and its entries, with no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Mapping

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
RUNNERS = {"train": "portbench.harness.train_cell", "serve_open": "portbench.harness.serve_cell"}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = REPO) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _named(entries: List[Mapping], name: str, what: str) -> Mapping:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def cell(bench: Mapping, workload: str, root: str = REPO) -> Dict:
    wl = _named(bench["workloads"], workload, "workload")
    conf = _named(bench["configs"], wl["config"], "configuration")
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    traffic = load_json(os.path.join(PB, "traffic", f"{wl['traffic']}.json"))
    return {
        "workload": wl, "config_entry": conf, "config": load_json(os.path.join(root, conf["file"]))["config"],
        "traffic": traffic, "runner": RUNNERS[traffic["kind"]],
        "limits": load_json(os.path.join(PB, "limits", f"{workload}.json")),
        "end_to_end": end_to_end, "per_layer": per_layer,
    }


def reader(metric: str):
    """The `read(ctx)` of ``portbench/metrics/<metric>.py``, or of the file
    named by the metric's part before its first dot."""
    path = os.path.join(PB, "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        path = os.path.join(PB, "metrics", f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
