"""What a traced run adds around the program, from the benchmark's side.

Both hooks wrap names of the port's modules for the length of a `with`
block and put them back after it; untraced runs never install them.

  launches()           every kernel launch the port counts
                       (`kernels/_build.count_launch`), with its shape;
  ranges(module, ...)  a `torch.profiler.record_function` range named
                       `perfbench.<label>.<function>` around each call of
                       the named functions of `module`, so device time can
                       be split by the layer that launched it.
"""
from __future__ import annotations

import contextlib
import functools


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


@contextlib.contextmanager
def ranges(module, names, label: str):
    import torch

    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(f"perfbench.{label}.{name}"):
                return fn(*args, **kwargs)
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def launched(log, counter: str):
    """[(shape, n)] of one kernel's launches in a launches() log."""
    return [(shape, n) for c, a, n, shape in log
            if c == counter and a == "launches"]
