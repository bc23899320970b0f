"""BENCHMARK.json and its files: every cell resolves to its configuration,
builder, reference, mix, readers and limits by name; the file keeps the
contract's shape; a cell added as files alone runs through the harness."""
from __future__ import annotations

import json
import os
import re
import statistics
import time

import pytest

from conftest import REPO
from portbench.lib import cells, harness

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    cell = cells.resolve(workload, REPO)
    assert hasattr(cell.builder, "build") and hasattr(cell.builder, "inputs")
    assert hasattr(cell.reference, "Reference")
    assert cell.traffic["loop"] in ("ahead", "closed")
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert "setup_s" in names and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert set(cell.readers) == names
    assert all(hasattr(r, "read") for r in cell.readers.values())
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    pairs = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and set(w) == {
            "name", "config", "traffic", "chips", "why"}
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and "bound" not in m
        reported = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(reported)
    all_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(all_names) == len(set(all_names))
    assert all(NAME.match(n) for n in all_names)


def test_new_cell_from_files_alone(bench_root):
    """A throwaway cell (``dragon_nh.tiny2``: a new mix file, a limits
    file and entries) runs through the harness as it stands, on the
    port's plain twins."""
    result, compared = harness.run_cell(
        "dragon_nh.tiny2", 2**31 + 5, 0.3, False, bench_root, "cpu",
        time.perf_counter())
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"body_substeps_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert all(v <= lim for v, lim in compared.values())


@pytest.mark.parametrize("cell", ["dragon_nh.tinyview", "box2_nh.tinyahead",
                                  "box2_nh.tinyview"])
def test_tiny_cells_correct(bench_root, cell):
    result, compared = harness.run_cell(cell, 12345, 0.3, False, bench_root,
                                        "cpu", time.perf_counter())
    assert result["correct"], compared
    if "view" in cell:
        frames = result["attempted"]
        assert frames >= 2 and "frame_ms_p95" in result["metrics"]
        assert {"export_verts", "export_normals"} <= set(compared)


def test_same_seed_same_inputs(bench_root):
    cell = cells.resolve("box2_nh.tinyahead", bench_root)
    a = cell.builder.inputs(cell.config, cell.traffic, 2**31 + 9, "cpu")
    b = cell.builder.inputs(cell.config, cell.traffic, 2**31 + 9, "cpu")
    c = cell.builder.inputs(cell.config, cell.traffic, 2**31 + 10, "cpu")
    assert bool((a["vel"] == b["vel"]).all())
    assert not bool((a["vel"] == c["vel"]).all())
    assert statistics.fmean(a["vel"].abs().flatten().tolist()) > 0.02
