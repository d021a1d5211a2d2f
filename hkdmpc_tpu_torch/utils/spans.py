"""Host spans of the program: where the host half of a solve or of a fleet
tick spends its time, on the host clock that the device programs' stage
clocks are put on (`solver.graphs.replay_records`, `outside_program`).

    with spans.span("fleet.update", request=mpc_iter):
        ...

Each span, when it ends, leaves one record in a bounded ring (the last
`RING` records, on `time.time_ns()`): its name, the span open in the same
thread when it began (`parent`, `parent_id`), the request it serves (a
fleet tick's `mpc_iter`, a solve's replay index), its start and end.
While a `torch.profiler` runs, a span is also a host-side
profiler event `hkd.<name>` (`_EVENT`), so it sits in the profiler's trace
beside the device's operations; with no profiler it makes no profiler
event. The
ring is always on and has no switch: a span costs two clock reads and an
append.

The spans the program opens, and the metric that reads each
(`benchmark/metrics/`):

- `graphs.build` (a device program's capture and assembly), `graphs.load`
  (the input copies), `graphs.launch`, `graphs.clone` (a solve's result
  clones): the labels of `graphs.outside_program` (`outside_program_ms.*`);
- `fleet.initialize`; `fleet.dispatch` holding `fleet.update`
  (`fused.host_step`: `fleet_update_ms`) and `fleet.pack` (the measurement
  pack); `fleet.complete` holding `fleet.wait` (the step's event),
  `fleet.copy` (the bundle to the host) and `fleet.unpack`
  (`fleet_fetch_ms`: copy and unpack).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

RING = 65_536
PREFIX = "hkd."

Record = collections.namedtuple(
    "Record", "id name parent parent_id request start_ns end_ns")

# the profiler event of a span: a host-side range (function scope). A
# user-scope `torch.profiler.record_function` would also make the profiler
# draw a device-side range over every kernel launched inside the span (a
# program's launch: its whole replay), which a reading of the trace's
# device operations would take for device work.
_EVENT = torch._C._profiler._RecordFunctionFast

_RECORDS: collections.deque = collections.deque(maxlen=RING)
_IDS = itertools.count()
_LOCAL = threading.local()


def _open() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def profiling() -> bool:
    """Whether a torch.profiler records in this process now."""
    return torch.autograd._profiler_enabled()


class span:
    """A host span (see the module's docstring); a context manager."""

    __slots__ = ("name", "request", "id", "parent", "start", "_event")

    def __init__(self, name: str, request=None):
        self.name, self.request = name, request

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self)
        self._event = None
        if profiling():
            self._event = _EVENT(PREFIX + self.name)
            self._event.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._event is not None:
            self._event.__exit__(*exc)
        _open().pop()
        p = self.parent
        _RECORDS.append(Record(self.id, self.name,
                               None if p is None else p.name,
                               None if p is None else p.id, self.request,
                               self.start, end))
        return False


def records(name: str | None = None) -> list:
    """The records in the ring, oldest first (those named `name` only,
    where given)."""
    out = list(_RECORDS)
    return out if name is None else [r for r in out if r.name == name]


def clear() -> None:
    """Empty the ring."""
    _RECORDS.clear()
