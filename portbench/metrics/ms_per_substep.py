"""The window's wall time (first enqueue to the host's read of the last
state) over every substep it completed, in ms."""


def read(run):
    w = run.window
    if not w.frames:
        return None
    return 1e3 * w.wall_s / (w.frames * run.substeps)
