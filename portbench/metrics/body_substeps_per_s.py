"""Bodies x substeps of every frame the window completed, over its wall
time from the first enqueue to the return of the host's read of a
reduction of the last state."""


def read(run):
    w = run.window
    if not w.frames or w.wall_s <= 0:
        return None
    return w.frames * run.bodies * run.substeps / w.wall_s
