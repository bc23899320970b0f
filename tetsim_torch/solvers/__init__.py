"""Solver backends.  This package carries the Neo-Hookean and polar engines;
the others of the JAX package are listed as still to port in ROADMAP.md."""
from . import common, neohookean, polar  # noqa: F401

ENGINES = {"neohookean": neohookean, "polar": polar}


def get_engine(name: str):
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; available: {sorted(ENGINES)} "
            "(the other engines are not ported yet, see ROADMAP.md)"
        ) from None
