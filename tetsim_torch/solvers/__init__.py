"""Solver backends: every engine name of the JAX package's registry.  The
Neo-Hookean and polar engines, their structured-grid forms, and the pieces
engines for one large unstructured mesh (``polar_pieces``, ``nh_pieces``,
in ``kernels/``).

Each grid pair keeps both of the JAX package's names: ``polar_grid`` and
``neohookean_grid`` report the XLA engines' per-substep diagnostics (0 and
the mean det F - 1), ``polar_grid_pallas`` and ``neohookean_grid_pallas``
(``kernels/polar_stencil.py``, ``kernels/nh_stencil.py``) report NaN as the
fused kernels do.  Both names of a pair run the pair's CUDA kernels on a
CUDA state and the plain-torch engine on a CPU state; so do the pieces
engines, which report NaN too."""
import importlib

from . import common, neohookean, neohookean_grid, polar, polar_grid  # noqa: F401

ENGINES = {
    "neohookean": neohookean,
    "neohookean_grid": neohookean_grid,
    "polar": polar,
    "polar_grid": polar_grid,
}

# engines that live in kernels/, imported at first use (they import this
# package)
_LAZY_ENGINES = {
    "polar_grid_pallas": "tetsim_torch.kernels.polar_stencil",
    "neohookean_grid_pallas": "tetsim_torch.kernels.nh_stencil",
    "polar_pieces": "tetsim_torch.kernels.polar_pieces",
    "nh_pieces": "tetsim_torch.kernels.nh_pieces",
}

GRID_ENGINES = ("polar_grid", "polar_grid_pallas", "neohookean_grid",
                "neohookean_grid_pallas")


def get_engine(name: str):
    if name in _LAZY_ENGINES:
        return importlib.import_module(_LAZY_ENGINES[name])
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; available: "
            f"{sorted(set(ENGINES) | set(_LAZY_ENGINES))}"
        ) from None
