"""The benchmark fails, and does not fall back, where there is no card,
and where the checkout holds only BENCHMARK.json and its own folder."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

from conftest import REPO, copy_checkout

ARGS = ["--workload", "dragon_nh.batch8", "--seed", "7", "--seconds", "1",
        "--trace", "0"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_bare_checkout_no_result(tmp_path):
    """Only BENCHMARK.json and portbench/ (and the dragon's asset): the
    port is missing, so the run fails though it is told a card exists."""
    root = copy_checkout(str(tmp_path))
    code = textwrap.dedent(f"""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: True
        sys.argv = ["portbench/run.py", *{ARGS!r}]
        runpy.run_path("portbench/run.py", run_name="__main__")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
