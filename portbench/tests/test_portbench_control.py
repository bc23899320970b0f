"""The control (the reference in bfloat16 in the port's place) fails the
cells' limits, at a size a test run holds; on the card at the cells' own
size the same runs through ``calibrate.py``."""
from __future__ import annotations

import time

import pytest

from portbench.lib import harness


@pytest.mark.parametrize("cell", ["dragon_nh.tiny2", "dragon_nh.tinyview",
                                  "box2_nh.tinyview"])
def test_control_fails_the_limits(bench_root, cell):
    result, compared = harness.run_cell(
        cell, 31337, 0.3, False, bench_root, "cpu", time.perf_counter(),
        controls=("bfloat16",))
    assert result["correct"]
    ctrl = result["control"]["bfloat16"]
    failed = {k for k, (_, lim) in compared.items() if ctrl[k] > lim}
    # the exact start and at least one number with a limit above 0
    assert "start_pos" in failed and failed & {"first_pos", "frame_pos"}, ctrl
