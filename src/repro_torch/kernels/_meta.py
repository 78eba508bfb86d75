"""A kernel's plain version run on meta tensors, as a counter sees it.

On ``meta`` tensors (shape and dtype, no data) :mod:`repro_torch.kernels.ops`
takes each kernel's plain version, so that a step can be counted without a
card (:mod:`repro_torch.roofline.count`).  A kernel keeps its intermediates
on chip, where its plain version materialises them: :func:`run` tells each
listener where a plain version starts and ends, so a counter can charge the
kernel's inputs and outputs to memory once and count its products' FLOPs.
"""
from __future__ import annotations

import contextlib
from collections.abc import Callable, Iterator

__all__ = ["run", "listening"]

_listeners: list[Callable] = []


@contextlib.contextmanager
def listening(fn: Callable) -> Iterator[None]:
    """Inside, ``fn("enter", name, inputs)`` and ``fn("exit", name,
    outputs)`` around every plain version :func:`run` runs."""
    _listeners.append(fn)
    try:
        yield
    finally:
        _listeners.remove(fn)


def run(name: str, fn: Callable, inputs: tuple, *args, **kwargs):
    """``fn(*args, **kwargs)``, announced to the listeners as kernel
    ``name`` reading the tensors ``inputs``."""
    for hook in _listeners:
        hook("enter", name, inputs)
    out = fn(*args, **kwargs)
    for hook in _listeners:
        hook("exit", name, out if isinstance(out, tuple) else (out,))
    return out
