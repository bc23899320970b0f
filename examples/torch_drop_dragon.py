"""Drop the dragon through the PyTorch/CUDA port (tetsim_torch), let it
settle with each engine, report diagnostics, save a checkpoint and
(optionally) serve the interactive viewer: ``examples/drop_dragon.py`` on
the port's public API.

  PYTHONPATH=. python examples/torch_drop_dragon.py           # on the card
  PYTHONPATH=. python examples/torch_drop_dragon.py --viewer  # then open the URL
  PYTHONPATH=. python examples/torch_drop_dragon.py --device cpu --frames 2
"""
import argparse
import os
import tempfile
import time

import tetsim_torch as tt
from tetsim_torch import checkpoint


def run(engine: str, frames: int, device: str):
    params = (tt.default_gpu_params() if engine == "polar"
              else tt.default_cpu_params())
    world = tt.World(params, device=device)
    body = world.add_body(tt.load_dragon(), engine=engine)
    t0 = time.perf_counter()
    world.step(frames)
    body.positions  # waits for the device
    dt = time.perf_counter() - t0
    rate = frames * params.num_substeps / dt
    print(f"[{engine:11s}] {frames} frames in {dt:.2f}s "
          f"({rate:,.0f} substeps/s) -> {world.diagnostics()['body0']}")
    return world, body


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint",
                    default=os.path.join(tempfile.gettempdir(),
                                         "dragon_settled.npz"))
    args = ap.parse_args(argv)

    for engine in ("neohookean", "polar"):
        world, body = run(engine, args.frames, args.device)

    checkpoint.save(args.checkpoint, body.state)
    print(f"checkpoint saved -> {args.checkpoint}")

    if args.viewer:
        from tetsim_torch.viewer import ViewerServer

        ViewerServer(world).start().serve_forever()
    return world


if __name__ == "__main__":
    main()
