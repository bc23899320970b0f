"""Scale demo through the PyTorch/CUDA port (tetsim_torch): a soft box of
N^3 cubes (6 N^3 tets) stepped by the stencil kernels with its state kept
packed across frames (``examples/scale_grid.py`` on the port's public API).

  PYTHONPATH=. python examples/torch_scale_grid.py            # 16^3, on the card
  PYTHONPATH=. python examples/torch_scale_grid.py --n 56     # 1,053,696 tets
  PYTHONPATH=. python examples/torch_scale_grid.py --viewer   # drag the box
  PYTHONPATH=. python examples/torch_scale_grid.py --engine neohookean
  PYTHONPATH=. python examples/torch_scale_grid.py --device cpu --n 2 --frames 2

Headless it drops the box, lets it settle on the floor and reports the
frame rate and the body's diagnostics.  On the CPU the kernels' plain
twins run.
"""
import argparse
import time

import tetsim_torch as tt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16, help="cubes per axis")
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--substeps", type=int, default=5)
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--engine", default="polar",
                    choices=["polar", "neohookean"],
                    help="stencil kernel family: polar shape matching or "
                    "Neo-Hookean Gauss-Seidel")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = args.n
    cell = 1.0 / n  # a box of about 1 m at any resolution
    params = tt.PhysicsParams(num_substeps=args.substeps)
    world = tt.World(params, device=args.device)
    grid_engine = ("neohookean_grid_pallas" if args.engine == "neohookean"
                   else "polar_grid_pallas")
    body = world.add_grid_body(
        (n, n, n), cell=cell, origin=(-0.5, 0.75, -0.5),
        engine=grid_engine, packed=True, with_edges=args.viewer and n <= 32,
    )
    print(f"grid {n}^3: {body.mesh.num_tets:,} tets / "
          f"{body.mesh.num_particles:,} particles")

    if args.viewer:
        from tetsim_torch.viewer import ViewerServer

        srv = ViewerServer(world, port=args.port).start()
        print(f"viewer: http://127.0.0.1:{srv.port}  (ctrl-c to stop)")
        srv.serve_forever()
        return world

    # the first run of the same frame count builds the kernels; the timed
    # run ends in a device-to-host copy of the positions
    body.step_many(params, args.frames)
    body.positions
    t0 = time.perf_counter()
    body.step_many(params, args.frames)
    body.positions
    dt = time.perf_counter() - t0
    rate = args.frames / dt
    d = world.diagnostics()["body0"]
    print(f"{args.frames} frames in {dt:.2f}s = {rate:,.1f} frames/s "
          f"({rate * args.substeps:,.0f} substeps/s)")
    print(f"settled: min_height={d['min_height']:.4f} "
          f"max_speed={d['max_speed']:.3f} nan={d['nan']}")
    return world


if __name__ == "__main__":
    main()
