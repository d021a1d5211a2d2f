"""Launch counters that the CUDA graphs add to when they are read.

The kernel wrappers count their launches in module-level integers
(`riccati_hkd.LAUNCHES`, ...). A graph whose loops stop on the device
counts the runs of its pieces in a device tensor, which a replay does not
read (a step replay reads nothing on the host); the device programs fold
those runs into the integers whenever one of them is read or set from
outside its module (the fold that `solver/graphs.py` hands to `fold_with`
when it is imported). `install(module, names)` makes that so: each name
becomes a property of the module's class, which folds and then reads or
writes the module's own global. Inside the module the global is read and
written as before (`global LAUNCHES; LAUNCHES += 1`). `install` also
records each (module, name) in `REGISTRY`, the counters that the device
programs record at capture and fold into."""

from __future__ import annotations

import sys
import types

REGISTRY: list = []   # (module, name) of every installed counter, in order


def _fold() -> None:
    """Nothing to fold until the device programs hand theirs over."""


def fold_with(fold) -> None:
    """Have `fold()` called before a counter is read or set from outside
    its module."""
    global _fold
    _fold = fold


def _counter(name):
    def get(mod):
        _fold()
        return mod.__dict__[name]

    def put(mod, value):
        _fold()
        mod.__dict__[name] = value

    return property(get, put)


def install(module_name: str, names) -> None:
    """Make each of `names` (integers defined in the module) a counter that
    is folded when read or set from outside the module, and record it in
    `REGISTRY`."""
    mod = sys.modules[module_name]
    mod.__class__ = type("CountingModule", (types.ModuleType,),
                         {n: _counter(n) for n in names})
    REGISTRY.extend((mod, n) for n in names)


def raw(mod, name) -> int:
    """The counter as it stands, without folding (the graphs' own reads)."""
    return mod.__dict__[name]


def set_raw(mod, name, value) -> None:
    mod.__dict__[name] = value
