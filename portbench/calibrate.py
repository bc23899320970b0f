"""The readings that the limits of ``limits/<cell>.json`` are set from,
on the card at the cell's own size: the port's numbers on many seeds and
the control's (the reference in bfloat16 in the port's place) on some,
all in one process, each seed a short window of the cell's own traffic.

    python3 portbench/calibrate.py --workload <cell> --seconds 2 \\
        --seeds 11 12 13 ... --control-seeds 11 12 13

Prints one JSON line a seed and, last, the largest reading of the port
and the smallest of the control for each number.  The benchmark's own
runs never run the control.

``--fault <name>`` plants one of ``FAULTS`` in the port first, so that
the port's readings are the fault's.  ``--samples <n>`` samples n calls
of each window in place of the mix's count, and ``--tail <m>`` reports
every sampled call whose position gap passes m metres: its worst
particle, whether it touches the ground, and the reference's own spread
when its input is nudged by one ulp either way (a contact that flips
under such a nudge moves a grounded particle by its speed times a
substep).
"""
import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _short_call():
    """``World.step(k)`` runs k - 1 frames where k > 1."""
    import tetsim_torch.world as w

    real = w.World.step
    w.World.step = lambda self, frames=1: real(
        self, frames - 1 if frames > 1 else frames)


def _wrong_grab():
    """``start_grab`` holds the particle after the nearest one."""
    import tetsim_torch.world as w

    real = w._nearest_particle
    w._nearest_particle = lambda pos, point: (real(pos, point) + 1) % \
        pos.shape[0]


FAULTS = {"short_call": _short_call, "wrong_grab": _wrong_grab}


def tail(above: float):
    """An ``inspect`` for ``harness.run_cell``: the sampled calls whose
    largest position gap passes ``above`` (see the module's docstring),
    and the largest gap of every sampled call."""
    import numpy as np
    import torch

    from portbench.lib import verdict
    from portbench.reference import _xpbd

    def ulp(t, direction):
        return torch.nextafter(t, torch.full_like(t, direction))

    def look(ref, inputs, start, window):
        grabbed = {g.frame: g for g in window.grabs}
        gaps, over = [], []
        for s in window.samples:
            grab = None
            if s.grab is not None:
                g = grabbed[s.grab[0]]
                grab = (int(np.argmin(_xpbd.distances(g.positions, g.point))),
                        s.grab[1])
            pos, vel = s.before
            rp, _ = verdict.advance(ref, pos, vel, s.frames, grab)
            d = (s.after[0].double() - rp.double()).abs().amax(-1)  # [B, N]
            gaps.append(d.max().item())
            if gaps[-1] <= above:
                continue
            b, i = divmod(int(d.argmax()), d.shape[-1])
            nudged = [verdict.advance(ref, ulp(pos, x), vel, s.frames, grab)[0]
                      for x in (math.inf, -math.inf)]
            at = [x[b, i].double() for x in [rp] + nudged]
            mine = s.after[0][b, i].double()
            over.append({
                "frame": s.frame, "gap": gaps[-1], "particle": i,
                "particles_over": int((d > above).sum()),
                "y_before": pos[b, i, 1].item(),
                "y_port": mine[1].item(), "y_ref": at[0][1].item(),
                "speed_before": vel[b, i].double().norm().item(),
                "grabbed": None if grab is None else grab[0],
                "nudge_spread": max((x - at[0]).abs().max().item()
                                    for x in at[1:]),
                "nudge_spread_all": max(
                    (x.double() - rp.double()).abs().max().item()
                    for x in nudged),
                "port_to_nearest_ref": min((mine - x).abs().max().item()
                                           for x in at)})
        return {"sampled": len(gaps), "largest": max(gaps, default=0.0),
                "median": float(np.median(gaps)) if gaps else 0.0,
                "over": over}

    return look


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--samples", type=int)
    ap.add_argument("--tail", type=float)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from portbench.lib import harness

    if args.fault:
        FAULTS[args.fault]()
    look = None if args.tail is None else tail(args.tail)
    program, ctrl = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        result, compared = harness.run_cell(
            args.workload, seed, args.seconds, False, ROOT, "cuda", t0,
            controls=("bfloat16",) if seed in args.control_seeds else (),
            samples=args.samples, inspect=look)
        line = {"seed": seed, "correct": result["correct"],
                "frames": result["attempted"], "failed": result["failed"],
                "error": result.get("error"),
                "program": {k: v for k, (v, _) in compared.items()},
                "control": result.get("control", {}).get("bfloat16"),
                "inspect": result.get("inspect"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if seed in args.seeds:
            for k, v in line["program"].items():
                program[k] = max(program.get(k, 0.0), v)
        for k, v in (line["control"] or {}).items():
            ctrl[k] = min(ctrl.get(k, math.inf), v)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "program_largest": program,
                      "control_smallest": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
