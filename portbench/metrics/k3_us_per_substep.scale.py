"""K3 (nh_grid_frame_kernel): its device time a traced substep, in us."""
from portbench.lib import readout


def read(run):
    s = readout.device_s_per_frame(run, "nh_grid_frame_kernel")
    return None if s is None else 1e6 * s / run.substeps
