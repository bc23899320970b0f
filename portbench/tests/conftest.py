"""Test settings of the benchmark's own tests (``python -m pytest
portbench/tests``).  They import no JAX.  Tests that need the card carry
the ``card`` marker and skip inside a fixture where there is none.

``bench_root`` is a throwaway checkout: ``BENCHMARK.json`` and the
benchmark's folder copied into a temporary directory with the dragon's
asset, plus tiny cells added as files only (``TINY``), which the CPU tests
run through the harness on the port's plain twins.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

torch.set_num_threads(1)

TINY_TRAFFIC = {
    "tiny2": {"loop": "ahead", "bodies": 2, "backend": "fused",
              "jitter": 0.5, "frames_per_call": 2, "warmup_frames": 3,
              "start_calls": 1, "samples": 2, "trace_seconds": 0.2},
    "tinyahead": {"loop": "ahead", "bodies": 1, "frames_per_call": 2,
                  "warmup_frames": 2, "start_calls": 1, "samples": 1,
                  "trace_seconds": 0.2},
    "tinyview": {"loop": "closed", "bodies": 1, "render_export": True,
                 "grab": {"radius_m": 0.3, "hz": 0.5, "drag_frames": 3,
                          "free_frames": 2},
                 "warmup_frames": 1, "start_calls": 2, "samples": 2,
                 "trace_seconds": 0.2},
}
# cell -> (config, traffic, the real cell whose limits and metrics it takes)
TINY = {
    "dragon_nh.tiny2": ("dragon_nh", "tiny2", "dragon_nh.batch8"),
    "dragon_nh.tinyview": ("dragon_nh", "tinyview", "box56_nh.viewer"),
    "box2_nh.tinyahead": ("box2_nh", "tinyahead", "box56_nh.ahead"),
    "box2_nh.tinyview": ("box2_nh", "tinyview", "box56_nh.viewer"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def copy_checkout(dest: str) -> str:
    """BENCHMARK.json, the benchmark's folder (without its tests) and the
    dragon's asset under ``dest``; returns ``dest``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    assets = os.path.join(dest, "tetsim_tpu", "assets")
    os.makedirs(assets)
    shutil.copy(os.path.join(REPO, "tetsim_tpu", "assets", "dragon.npz"),
                assets)
    return dest


def add_tiny_cells(root: str) -> None:
    """The ``TINY`` cells as new files and entries: a 2x2x2 box
    configuration (``box2_nh``, the box's builder and reference copied
    under its name), the mixes, the limits of the real cells."""
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "box56_nh.json")) as f:
        box = json.load(f)
    box.update(dims=[2, 2, 2], particles=27, tets=48,
               origin=[-0.05, 0.5, -0.05])
    with open(os.path.join(pb, "configs", "box2_nh.json"), "w") as f:
        json.dump(box, f)
    for folder in ("configs", "reference"):
        shutil.copy(os.path.join(pb, folder, "box56_nh.py"),
                    os.path.join(pb, folder, "box2_nh.py"))
    for name, mix in TINY_TRAFFIC.items():
        with open(os.path.join(pb, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "box2_nh", "source": "a 2x2x2 box", "reduced": ["dims"],
        "file": "portbench/configs/box2_nh.json", "why": "CPU tests"})
    for cell, (config, traffic, like) in TINY.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
        shutil.copy(os.path.join(pb, "limits", f"{like}.json"),
                    os.path.join(pb, "limits", f"{cell}.json"))
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def bench_root(tmp_path):
    root = copy_checkout(str(tmp_path))
    add_tiny_cells(root)
    return root
