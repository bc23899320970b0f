"""Solver backends.  This package carries the Neo-Hookean engine only;
the others of the JAX package are listed as still to port in ROADMAP.md."""
from . import common, neohookean  # noqa: F401

ENGINES = {"neohookean": neohookean}


def get_engine(name: str):
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; available: {sorted(ENGINES)} "
            "(the other engines are not ported yet, see ROADMAP.md)"
        ) from None
