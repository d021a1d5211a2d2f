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
programs record at capture and fold into.

A count that depends on the data (the rows a masked launch swept) is not a
piece's runs times what it recorded at capture: `tally(module, name,
amount)` adds a device tensor to a running total on that tensor's device,
in the stream's order (captured with the piece, it adds at every replay),
and reads nothing on the host. Reading or setting the counter from outside
its module first folds what its totals gained since the last fold (one
host read a device), for every such counter alike."""

from __future__ import annotations

import sys
import types

import torch

REGISTRY: list = []   # (module, name) of every installed counter, in order
_TALLIES: dict = {}   # (module, name) -> {device: [running total, folded]}


def _fold() -> None:
    """Nothing to fold until the device programs hand theirs over."""


def fold_with(fold) -> None:
    """Have `fold()` called before a counter is read or set from outside
    its module."""
    global _fold
    _fold = fold


def _fold_tallies(mod, name) -> None:
    """Add to the counter what its device totals gained since the last
    fold."""
    for total in _TALLIES.get((mod, name), {}).values():
        now = int(total[0])
        mod.__dict__[name] += now - total[1]
        total[1] = now


def _counter(name):
    def get(mod):
        _fold()
        _fold_tallies(mod, name)
        return mod.__dict__[name]

    def put(mod, value):
        _fold()
        _fold_tallies(mod, name)
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


def tally(module_name: str, name, amount) -> None:
    """Add `amount` (a 0-d integer tensor) to the counter `name` of the
    module on `amount`'s device, without reading it; the
    first tally of a device makes its total, which a CUDA graph capture
    cannot do (run the piece once before its capture, as a warm-up
    does)."""
    mod = sys.modules[module_name]
    totals = _TALLIES.setdefault((mod, name), {})
    dev = amount.device
    if dev not in totals:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"counter {module_name}.{name}: its first "
                               f"tally on {dev} is inside a CUDA graph "
                               "capture; run the body once before")
        totals[dev] = [torch.zeros((), dtype=torch.int64, device=dev), 0]
    totals[dev][0].add_(amount)


def raw(mod, name) -> int:
    """The counter as it stands, without folding (the graphs' own reads)."""
    return mod.__dict__[name]


def set_raw(mod, name, value) -> None:
    mod.__dict__[name] = value
