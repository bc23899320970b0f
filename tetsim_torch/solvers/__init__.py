"""Solver backends.  This package carries the Neo-Hookean and polar engines
and their structured-grid forms; the others of the JAX package are listed
as still to port in ROADMAP.md.

Each grid pair keeps both of the JAX package's names: ``polar_grid`` and
``neohookean_grid`` report the XLA engines' per-substep diagnostics (0 and
the mean det F - 1), ``polar_grid_pallas`` and ``neohookean_grid_pallas``
(``kernels/polar_stencil.py``, ``kernels/nh_stencil.py``) report NaN as the
fused kernels do.  Both names of a pair run the pair's CUDA kernels on a
CUDA state and the plain-torch engine on a CPU state."""
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
            f"{sorted(set(ENGINES) | set(_LAZY_ENGINES))} (the other engines "
            "are not ported yet, see ROADMAP.md)"
        ) from None
