"""Host time a traced frame inside the render export (the
``tetsim.export`` span with its positions, skinning and normals), in
us."""
from portbench.lib import program


def read(run):
    p = program.of(run)
    return None if p is None else p.per_frame(
        "tetsim.export", 1e6 * p.host_s("tetsim.export"))
