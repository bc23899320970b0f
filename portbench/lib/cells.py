"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's sizes are the JSON file its entry names; its
scene builder is ``configs/<config>.py`` and its plain reference
``reference/<config>.py``.  The mix is ``traffic/<mix>.json``.  Every
metric the cell reports has a reader ``metrics/<metric>.py``, and the
limits of its comparison with the reference are ``limits/<cell>.json``.  Nothing
here lists them: a later cell, configuration, mix or metric is a new file
and a new entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its entry's name
    traffic: dict  # the mix's file, with its name
    builder: ModuleType  # configs/<config>.py: build(config, traffic, seed, device)
    reference: ModuleType  # reference/<config>.py: Reference(config, traffic, device, dtype)
    end_to_end: list  # the BENCHMARK.json entries of the cell's end-to-end metrics
    per_layer: list  # ... and of its per-layer metrics
    readers: dict  # metric name -> its reader module (read(run) -> float | None)
    limits: dict  # limits/<cell>.json: each number compared -> its limit
    root: str  # the checkout's root: BENCHMARK.json and the benchmark's folder


def load_module(path: str, tag: str) -> ModuleType:
    """The Python file at ``path`` as a module of its own (names with dots,
    such as ``k1_us_per_frame.batch.py``, load as well)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    name = f"portbench_{tag}_" + "".join(
        c if c.isalnum() else "_" for c in os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _covers(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(workload: str, root: str) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files;
    raises where the cell or one of its files is missing."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = dict(_read_json(os.path.join(root, entry["file"])),
                  name=entry["name"])
    folder = os.path.join(root, os.path.dirname(os.path.dirname(entry["file"])))
    traffic = dict(_read_json(os.path.join(folder, "traffic",
                                           f"{w['traffic']}.json")),
                   name=w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _covers(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _covers(m, workload) and m["moves"] in reported]
    readers = {m["name"]: load_module(
        os.path.join(folder, "metrics", f"{m['name']}.py"), "metric")
        for m in e2e + layer}
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        builder=load_module(os.path.join(folder, "configs",
                                         f"{entry['name']}.py"), "config"),
        reference=load_module(os.path.join(folder, "reference",
                                           f"{entry['name']}.py"), "reference"),
        end_to_end=e2e, per_layer=layer, readers=readers,
        limits=_read_json(os.path.join(folder, "limits", f"{workload}.json")),
        root=root,
    )
