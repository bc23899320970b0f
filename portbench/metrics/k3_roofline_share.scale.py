"""K3's least time a frame (frozen counts at the published FP32 and HBM
peaks) over its device time a traced frame, in percent."""
from portbench.lib import readout


def read(run):
    s = readout.device_s_per_frame(run, "nh_grid_frame_kernel")
    return None if s is None else 100.0 * readout.k3_bound_s(run) / s
