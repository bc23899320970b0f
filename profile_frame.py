#!/usr/bin/env python3
"""Where a frame of the PyTorch/CUDA port's fused frame kernel spends its
time, on one CUDA card.

    python3 profile_frame.py     # from the repository root, one CUDA card

For each dragon shape (greedy schedule at B = 1, 8, 64 and 132 bodies, the
ordered schedule at B = 1), stepped through ``FusedGSBody``, it prints one
JSON line:
  host_ms     synced host time per frame: a two-point fit over k1 and k2
              frames, each run ending in a data-dependent sync;
  enqueue_ms  host time per frame to enqueue k2 frames, with no sync;
  event_ms    CUDA-event span per frame over those same k2 frames;
  kernel_us   the kernel's device time per launch, torch.profiler over 20
              frames (null where the profiler records no device time);
  busy_share  kernel_us / event_ms: the share of a frame's span in which
              the kernel runs.
The card's name, power limit, SM clock and power draw are printed before
and after.  It exits non-zero where CUDA is unavailable.
"""
import json
import subprocess
import sys
import time

import torch

SHAPES = (("B=1 greedy", 1, "greedy", 50, 450),
          ("B=8 greedy", 8, "greedy", 50, 450),
          ("B=64 greedy", 64, "greedy", 50, 450),
          ("B=132 greedy", 132, "greedy", 50, 450),
          ("B=1 ordered", 1, "ordered", 20, 80))
PROFILED_FRAMES = 20


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synced_run(step, state_sum, k) -> float:
    t0 = time.perf_counter()
    step(k)
    float(state_sum())
    return time.perf_counter() - t0


def kernel_us_per_launch(step):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(PROFILED_FRAMES)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "gs_frame_kernel" in e.key]
    launches = sum(e.count for e in events)
    device_us = sum(e.self_device_time_total for e in events)
    return device_us / launches if launches and device_us else None


def measure(body, params, k1, k2) -> dict:
    def step(k):
        body.step(params, k)

    def state_sum():
        return body.pos.sum()

    synced_run(step, state_sum, 1)  # warm-up
    host_s = (synced_run(step, state_sum, k2)
              - synced_run(step, state_sum, k1)) / (k2 - k1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    step(k2)
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / k2
    kernel_us = kernel_us_per_launch(step)
    return {
        "host_ms": host_s * 1e3, "enqueue_ms": enqueue_s * 1e3 / k2,
        "event_ms": event_ms, "kernel_us": kernel_us,
        "busy_share": kernel_us / (event_ms * 1e3) if kernel_us else None,
        "substeps_per_s": params.num_substeps / host_s,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_frame: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import tetsim_torch as tt
    from tetsim_torch.kernels.gs_fused import FusedGSBody

    print(card(), flush=True)
    dragon = tt.load_dragon()
    params = tt.default_cpu_params()
    for name, b, coloring, k1, k2 in SHAPES:
        body = FusedGSBody(dragon, num_bodies=b, coloring=coloring,
                           device="cuda")
        print(name, json.dumps(measure(body, params, k1, k2)), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
