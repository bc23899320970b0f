"""Plain PyTorch references of the configurations, one file per
configuration (``<config>.py``) over the shared XPBD arithmetic of
``_xpbd.py``.  Nothing here imports tetsim_torch: each reference re-derives
from the mesh, the seed and the inputs what the port's set-up derives."""
