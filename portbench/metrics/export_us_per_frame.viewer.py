"""The render export's device time a traced frame, in us: every op that
step_many_export launches but the solver kernel (skinning, normals, the
layout copy), and the copy of the export to pinned host memory."""


def read(run):
    t = run.trace
    if t is None or not t.frames:
        return None
    solver = run.cell.config["solver_kernel"]
    s = sum(v for name, v in t.by_span.get("step_export", {}).items()
            if solver not in name)
    s += sum(t.by_span.get("copy", {}).values())
    return 1e6 * s / t.frames if s > 0 else None
