"""Runs one cell of BENCHMARK.json once on the card and prints one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a host with the cards the cell asks
for.  With ``--trace 0`` the line's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a profiler
session over a short tail of the same traffic after the window.  The last
lines on standard error, and the line's last key ``checks``, give each
number compared with the reference beside its limit.  Without CUDA, with
fewer cards than the cell asks for, or where JAX or the JAX package was
loaded, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches of whatever the port runs: fixed folders inside
# the checkout (the port builds its nvcc libraries in tetsim_torch/_build/)
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
sys.path.insert(0, ROOT)


def _json_number(x):
    return x if x is None or math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    import tetsim_torch

    here = os.path.dirname(os.path.realpath(tetsim_torch.__file__))
    if os.path.dirname(here) != os.path.realpath(ROOT):
        print(f"portbench: tetsim_torch comes from {here}, not from this "
              "checkout", file=sys.stderr)
        return 2
    from portbench.lib import harness

    result, compared = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), ROOT,
        "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print("portbench: loaded " + ", ".join(found), file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        c["value"] = _json_number(c["value"])
    for name, (value, limit) in compared.items():
        print(f"check {name} {value:.6g} limit "
              f"{'none' if limit is None else format(limit, '.6g')}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
