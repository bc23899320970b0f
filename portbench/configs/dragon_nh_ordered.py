"""Scene of ``dragon_nh_ordered``: a batch of dragons in the reference's
exact constraint order through ``World.add_body_batch``, on the backend
the mix names (``dense_ordered``: the dense engine's order-preserving
levels)."""
import os

from portbench.lib import scenes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the checkout: the mesh's path is from it


class DenseBatchScene(scenes.BatchScene):
    """A ``DenseBody``, whose state is [N, 3, B]: ``capture`` hands out
    [B, N, 3] views of it (no copy, no sync)."""

    def capture(self):
        return self.body.pos.movedim(-1, 0), self.body.vel.movedim(-1, 0)


def inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """What both sides get from the seed: the seed itself (the batch's
    jitter is drawn from it)."""
    return {"seed": int(seed)}


def build(config: dict, traffic: dict, inputs: dict, device):
    """The configuration's mesh, ``bodies`` of it on the mix's backend,
    jittered from the seed."""
    import tetsim_torch as tt

    world = tt.World(scenes.physics(config), device=device)
    mesh = tt.load_npz(os.path.join(ROOT, config["mesh"]))
    bodies = int(traffic["bodies"])
    batch = world.add_body_batch(
        mesh, bodies, engine=config["engine"], backend=traffic["backend"],
        jitter=float(traffic["jitter"]),
        seed=scenes.program_seed(inputs["seed"]))
    scene = (DenseBatchScene if traffic["backend"].startswith("dense")
             else scenes.BatchScene)
    return scene(world, batch, bodies)
