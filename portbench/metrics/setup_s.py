"""Seconds from the harness's first statement to the first timed frame:
imports, the CUDA context, the scene's set-up from the seed, the first
build of the port's kernels where the checkout has none, the warm-up."""


def read(run):
    return run.setup_s
