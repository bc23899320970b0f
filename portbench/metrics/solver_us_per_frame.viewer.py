"""The cell's solver kernel (the configuration's ``solver_kernel``: K1 or
K3): its device time a traced frame, in us."""
from portbench.lib import readout


def read(run):
    s = readout.device_s_per_frame(run, run.cell.config["solver_kernel"])
    return None if s is None else 1e6 * s
