"""Host time a traced frame inside the port's grab calls (every
``tetsim.grab.*`` span: start, which reads the grabbed id back, move and
end), in us."""
from portbench.lib import program


def read(run):
    p = program.of(run)
    return None if p is None else p.per_frame(
        "tetsim.grab", 1e6 * p.host_s("tetsim.grab"))
