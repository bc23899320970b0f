"""Scene of ``box56_nh``: one grid box through ``World.add_grid_body``."""
from portbench.lib import scenes


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """What both sides get from the seed: every particle's starting
    velocity, drawn on the device."""
    return {"seed": int(seed),
            "vel": scenes.seeded_velocities(
                seed, (1, int(config["particles"]), 3),
                float(config["init_speed"]), device)}


def build(config: dict, traffic: dict, inputs: dict, device):
    """One ``grid_mesh`` box on the configuration's engine, packed, its
    velocities set from the inputs; with the mix's render export, its
    boundary surface as the viewer's ``--grid`` path sets it up."""
    import tetsim_torch as tt

    if int(traffic["bodies"]) != 1:
        raise ValueError("a grid box mix drives one body")
    world = tt.World(scenes.physics(config), device=device)
    export = bool(traffic.get("render_export"))
    body = world.add_grid_body(
        tuple(config["dims"]), cell=float(config["cell"]),
        origin=tuple(config["origin"]), engine=config["engine"], packed=True,
        with_surface=export)
    body.state = body.state.replace(vel=inputs["vel"][0])
    if export:
        surface = body._surface  # the tables the viewer hands over
        body.enable_render_export(surface.skin_ids, surface.skin_w,
                                  surface.tris)
    return scenes.PackedGridScene(world, body, 1)
