"""What a traced run adds around the program, from the benchmark's side.

`launches()` logs every kernel launch the port counts
(`kernels/_build.count_launch`), with its shape: it wraps that name of
the port's module for the length of a `with` block and puts it back
after it; untraced runs never install it.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def launches():
    """Yields a list that receives (counter, attribute, n, shape) for each
    count the port makes while the block runs."""
    from repro_torch.kernels import _build

    orig = _build.count_launch
    log: list[tuple[str, str, int, tuple | None]] = []

    def count_launch(wrapper, attr="launches", n=1, shape=None):
        log.append((wrapper.__name__, attr, int(n), shape))
        return orig(wrapper, attr, n, shape)

    _build.count_launch = count_launch
    try:
        yield log
    finally:
        _build.count_launch = orig


def launched(log, counter: str):
    """[(shape, n)] of one kernel's launches in a launches() log."""
    return [(shape, n) for c, a, n, shape in log
            if c == counter and a == "launches"]
