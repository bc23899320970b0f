"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level names (``tetsim_torch`` begins with ``tetsim_tpu``'s letters),
and the references load nothing of the port."""
from __future__ import annotations

import glob
import os
import subprocess
import sys
import textwrap

from conftest import REPO

CHECK = textwrap.dedent("""
    import importlib.util, json, sys
    sys.path.insert(0, {repo!r})
    {body}
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")


def _loaded(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", CHECK.format(repo=REPO, body=body)],
        capture_output=True, text=True, timeout=300, cwd=REPO, check=True)
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    """run.py's modules, every cell's builder, reference and readers, and a
    scene of the port built on the CPU."""
    top = _loaded(textwrap.dedent("""
        import runpy
        runpy.run_path("portbench/run.py", run_name="portbench_run")
        from portbench.lib import cells, harness
        import tetsim_torch.world
        for w in json.load(open("BENCHMARK.json"))["workloads"]:
            cells.resolve(w["name"], ".")
        c = cells.resolve("dragon_nh.batch8", ".")
        c.builder.build(c.config, c.traffic, c.builder.inputs(
            c.config, c.traffic, 1, "cpu"), "cpu").dispatch(1)
    """))
    assert "tetsim_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "tetsim_tpu"}


def test_references_load_nothing_of_the_port():
    files = sorted(glob.glob(os.path.join(REPO, "portbench", "reference",
                                          "*.py")))
    body = "from portbench.lib.cells import load_module\n" + "\n".join(
        f"load_module({f!r}, 'reference')" for f in files)
    top = _loaded(body)
    assert "torch" in top
    assert not top & {"tetsim_torch", "tetsim_tpu", "jax", "jaxlib", "flax"}


def test_whole_name_comparison(monkeypatch):
    from portbench.lib import harness

    monkeypatch.setitem(sys.modules, "tetsim_tpux", object())
    monkeypatch.setitem(sys.modules, "jaxon.core", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tetsim_tpu.mesh", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "tetsim_tpu.mesh"]
