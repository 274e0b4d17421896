"""The run's check that the JAX reference package never loaded.

Compared by whole top-level name (the part before the first dot): the
port `repro_torch` begins with `repro` and is allowed, `repro` and
`repro.core` are not.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(names) -> list[str]:
    """The names whose top-level package is forbidden, sorted."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> list[str]:
    return forbidden(list(sys.modules))
