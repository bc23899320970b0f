"""Host time a traced frame inside the port's kernel entries (every
``tetsim.kernel.*`` span: on CUDA the wrapper's checks, allocations and
launch, up to the launch call's return), in us."""
from portbench.lib import program


def read(run):
    p = program.of(run)
    return None if p is None else p.per_frame(
        "tetsim.kernel", 1e6 * p.host_s("tetsim.kernel"))
