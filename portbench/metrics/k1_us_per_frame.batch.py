"""K1 (gs_frame_kernel): its device time a traced frame, in us."""
from portbench.lib import readout


def read(run):
    s = readout.device_s_per_frame(run, "gs_frame_kernel")
    return None if s is None else 1e6 * s
