"""95th percentile of every frame of the window, each from the start of
its grab call (the client's drag point given) through step_many_export to
its export's copy to pinned host memory being complete, in ms."""
import numpy as np


def read(run):
    w = run.window
    if not w.frame_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(w.frame_s), 95))
