"""The port's own host time a traced frame in its kernel entries, in us:
the time inside every ``tetsim.kernel.*`` span (on CUDA the wrapper's
checks, allocations and ctypes call) outside the CUDA runtime's and
driver's calls.  Frames dispatched ahead fill the card's launch queue, and
a launch then waits in the runtime's call for room, at the kernel's pace:
that call is left out, its wait with its own few us."""
from portbench.lib import program


def read(run):
    p = program.of(run)
    return None if p is None else p.per_frame(
        "tetsim.kernel",
        1e6 * (p.host_s("tetsim.kernel") - p.runtime_s("tetsim.kernel")))
