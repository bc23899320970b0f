"""Scene of ``dragon_nh``: the dragon through ``World.add_body_batch``
(mixes that name a backend) or ``World.add_body``."""
from portbench.lib import scenes


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """What both sides get from the seed: the seed itself (the batch's
    jitter is drawn from it)."""
    return {"seed": int(seed)}


def build(config: dict, traffic: dict, inputs: dict, device):
    """``add_body_batch`` where the mix names a backend, else ``add_body``
    with the configuration's colouring (and the render export where the
    mix asks for it)."""
    import tetsim_torch as tt

    world = tt.World(scenes.physics(config), device=device)
    mesh = tt.load_dragon()
    if "backend" in traffic:
        if traffic["backend"] == "fused" and config["coloring"] != "greedy":
            raise ValueError("add_body_batch(backend='fused') colours greedily")
        batch = world.add_body_batch(
            mesh, int(traffic["bodies"]), engine=config["engine"],
            backend=traffic["backend"], jitter=float(traffic["jitter"]),
            seed=scenes.program_seed(inputs["seed"]))
        return scenes.BatchScene(world, batch, int(traffic["bodies"]))
    if int(traffic["bodies"]) != 1:
        raise ValueError("a dragon mix without a backend drives one body")
    body = world.add_body(mesh, engine=config["engine"],
                          coloring=config["coloring"])
    if traffic.get("render_export"):
        body.enable_render_export()
    return scenes.BodyScene(world, body, 1)
