"""The card's idle time a traced frame while the render export
(``tetsim.export`` or one of its children) was the host's innermost
span: the card waiting on the export's enqueue, in us."""
from portbench.lib import program


def read(run):
    p = program.of(run)
    return None if p is None else p.per_frame(
        "tetsim.export", 1e6 * p.total("tetsim.export", "idle_s"))
