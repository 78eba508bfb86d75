"""Helpers for the planning layer's parity tests: the same call made in
the JAX package ``repro`` and in the port ``repro_torch``, whose numpy
modules are copies, must give exactly equal results (no tolerance)."""
from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np

PACKAGES = ("repro", "repro_torch")


def both(module: str) -> tuple:
    """``(repro.<module>, repro_torch.<module>)``."""
    return tuple(importlib.import_module(f"{pkg}.{module}") for pkg in PACKAGES)


def assert_same(a, b, path: str = "result", skip: tuple[str, ...] = ()) -> None:
    """``a`` (the reference's) and ``b`` (the port's) are exactly equal:
    dataclasses field by field (by class name, since each package has its
    own classes; fields named in ``skip`` — wall-clock times — are not
    compared), arrays by dtype, shape and value, floats bit for bit (NaN
    equals NaN), containers item by item."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, f"{path}: {type(a)} vs {type(b)}"
        for f in dataclasses.fields(a):
            if f.name not in skip:
                assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}", skip)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), f"{path}: {type(b)}"
        assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), f"{path} differs"
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{path}: keys differ"
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]", skip)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), f"{path}: {len(a)} vs {len(b)} items"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", skip)
    elif isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), f"{path}: {type(b)}"
        assert a == b or (math.isnan(a) and math.isnan(b)), f"{path}: {a!r} != {b!r}"
    else:
        assert type(a).__name__ == type(b).__name__ and a == b, f"{path}: {a!r} != {b!r}"


def findings(fs) -> list[tuple[str, str, str]]:
    """A lint run as ``(rule id, severity, message)`` triples."""
    return [(f.rule_id, f.severity, f.message) for f in fs]
