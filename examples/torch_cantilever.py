"""Cantilever beam through the PyTorch/CUDA port (tetsim_torch): a
grid_mesh bar pinned at one end wall sags under gravity on the polar
stencil engine (``examples/cantilever.py`` on the port's public API).

  PYTHONPATH=. python examples/torch_cantilever.py           # on the card
  PYTHONPATH=. python examples/torch_cantilever.py --viewer  # interactive
                    # (particles + wireframe; grid meshes have no surface)
  PYTHONPATH=. python examples/torch_cantilever.py --device cpu --frames 2
"""
import argparse
import time

import numpy as np

import tetsim_torch as tt
from tetsim_torch.solvers import get_engine
from tetsim_torch.solvers.polar_grid import build_grid_arrays
from tetsim_torch.state import check_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--ny", type=int, default=4)
    ap.add_argument("--nz", type=int, default=4)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    dims = (args.nx, args.ny, args.nz)
    cell = 0.08
    mesh = tt.grid_mesh(*dims, cell=cell,
                        origin=(-1.0, 1.2, -args.nz * cell / 2),
                        with_edges=True)
    # pin the x=0 vertex wall (zero inverse mass): plane i=0 holds the first
    # gy*gz particle ids
    gy, gz = args.ny + 1, args.nz + 1
    wall = np.arange(gy * gz, dtype=np.int64)
    garr = build_grid_arrays(mesh, dims, pinned=wall, device=device)

    params = tt.PhysicsParams(num_substeps=8)
    step = get_engine("polar_grid").step_frame
    state = tt.init_state(mesh, device)
    controls = tt.Controls.none(device)

    t0 = time.perf_counter()
    for _ in range(args.frames):
        state, _ = step(state, garr, params, controls)
    pos = state.pos.cpu().numpy()
    dtime = time.perf_counter() - t0

    rest_tip = mesh.verts[-gy * gz:, 1].mean()
    tip = pos[-gy * gz:, 1].mean()  # free-end wall mean height
    root = pos[:gy * gz]
    drift = np.abs(root - mesh.verts[:gy * gz]).max()
    print(f"{mesh.num_tets} tets, {args.frames} frames in {dtime:.2f}s")
    print(f"root wall held: max drift {drift:.2e}")
    print(f"tip sagged {rest_tip - tip:.3f} m under gravity")
    assert np.isfinite(pos).all()
    assert drift == 0.0, "pins moved"
    # the JAX example's run of 240 frames asks for 0.01 m; any run sags
    assert tip < rest_tip - (0.01 if args.frames >= 60 else 0.0), \
        "beam did not sag"

    if args.viewer:
        from tetsim_torch.viewer import ViewerServer

        world = tt.World(params, device=device)
        body = world.add_body(mesh, engine="polar_grid", coloring=None,
                              arrays=garr)
        body.state = state
        ViewerServer(world).start().serve_forever()
    return state


if __name__ == "__main__":
    main()
