"""Host time a frame of the grab calls and step_many_export, which return
before the card has run the frame (start_grab, once a grab, reads its
particle back), over the traced run's window (no profiler), in us."""


def read(run):
    e = run.window.enqueue_s
    return 1e6 * sum(e) / len(e) if e else None
