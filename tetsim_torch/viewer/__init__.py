"""Interactive viewer (counterpart of ``tetsim_tpu/viewer``): the simulation
and the skinning run on the device, and the JAX package's WebGL2 browser
client, served by path, renders what the server exports and sends grab
rays back."""
from .server import ViewerServer  # noqa: F401
