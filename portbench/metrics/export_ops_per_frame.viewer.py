"""Device ops (kernels, copies, memsets) a traced frame launched from
inside the render export (``tetsim.export`` and its children)."""
from portbench.lib import program


def read(run):
    p = program.of(run)
    return None if p is None else p.per_frame(
        "tetsim.export", p.total("tetsim.export", "device_ops"))
