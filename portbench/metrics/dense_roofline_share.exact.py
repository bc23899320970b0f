"""The dense frame kernel's least time a frame (frozen counts at the
published FP32 and HBM peaks, ``lib/work_dense.py``) over its device time
a traced frame, in percent."""
from portbench.lib import readout, work_dense


def read(run):
    s = readout.device_s_per_frame(run, "dense_frame_kernel")
    return None if s is None else 100.0 * work_dense.bound_s(run) / s
