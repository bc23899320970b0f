"""The card's idle time a traced frame while a kernel entry of the port
(a ``tetsim.kernel.*`` span) was the host's innermost span: the card
waiting on the wrapper's host path, in us."""
from portbench.lib import program


def read(run):
    p = program.of(run)
    return None if p is None else p.per_frame(
        "tetsim.kernel", 1e6 * p.total("tetsim.kernel", "idle_s"))
