"""The traced window: `torch.profiler` over a stretch of the cell's own
work, reduced to what the per-layer readers and the result line need.

The harness marks its own calls into the program with spans named
`bench.<what>` (`span`); the profiler records them beside the device's
operations. The reduction reads the raw events of the profiler's results
(no event tree is built): each device operation (kernels, copies, sets)
with its name, start and length, and the harness's spans. From them:

- `busy_s`: the union of the device operations' intervals within the
  window, in seconds; `window_s`: the window's length, from its span;
- `by_name`: device seconds by operation name;
- `idle_gaps`: the stretches inside the window where no device operation
  ran, each labelled by the innermost harness span open at its middle
  (`host` where none is).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "traced_window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def log_times(what: str, ms) -> None:
    """One diagnostic line on standard error: the distribution of the
    window's per-call (or per-tick) host-clock times, and the medians of
    its first and second halves (a drift shows there)."""
    raw = np.asarray(ms, np.float64)
    if raw.size < 2:
        return
    q = lambda a, p: float(np.percentile(a, p))
    h = raw.size // 2
    print(f"# {raw.size} {what}s, ms: min {raw.min():.3f} p10 {q(raw, 10):.3f}"
          f" median {q(raw, 50):.3f} p90 {q(raw, 90):.3f} max "
          f"{raw.max():.3f}; median of the first half {q(raw[:h], 50):.3f},"
          f" of the second {q(raw[h:], 50):.3f}", file=sys.stderr, flush=True)


def span(name: str):
    """A harness span `bench.<name>` in the trace (a no-op cost when no
    profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: list            # (name, start_ns, end_ns) of each device operation
    by_name: dict        # name -> device seconds
    idle_gaps: list      # (label, seconds), longest first

    def op_seconds(self, match) -> tuple:
        """(seconds, count) of the device operations whose name `match`
        accepts."""
        hits = [e - s for n, s, e in self.ops if match(n)]
        return sum(hits) / 1e9, len(hits)


@contextlib.contextmanager
def traced(device):
    """Profile the body (CPU and CUDA activity) as the traced window; the
    summary is set on the yielded holder's `.summary` once the body ends."""
    from torch.profiler import ProfilerActivity, profile
    holder = type("Traced", (), {"summary": None})()
    on_card = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
        lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            yield holder
            sync()
        host_s = time.perf_counter() - t0
    holder.summary = summarize(prof.profiler.kineto_results.events(), host_s)


def _activity(ev) -> str:
    return ev.activity_type() if hasattr(ev, "activity_type") else ""


def summarize(events, host_s: float) -> TraceSummary:
    """Reduce the profiler's raw events (KinetoEvent) to a TraceSummary;
    host_s is the window's length by the host clock, used where the
    window's span is missing."""
    ops, spans = [], []
    w0 = w1 = None
    for ev in events:
        name = ev.name()
        act = _activity(ev)
        is_device = str(ev.device_type()).endswith("CUDA")
        if is_device and (act in DEVICE_ACTIVITIES
                          or (not act and not name.startswith(SPAN_PREFIX))):
            s = ev.start_ns()
            ops.append((name, s, s + ev.duration_ns()))
        elif not is_device and name.startswith(SPAN_PREFIX):
            s = ev.start_ns()
            if name == WINDOW_SPAN:
                w0, w1 = s, s + ev.duration_ns()
            else:
                spans.append((name[len(SPAN_PREFIX):], s,
                              s + ev.duration_ns()))
    if w0 is None:
        starts = [s for _, s, _ in ops] or [0]
        w0 = min(starts)
        w1 = w0 + int(host_s * 1e9)
    ops.sort(key=lambda o: o[1])
    by_name: dict = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    busy, gaps = _union(ops, w0, w1)
    spans.sort(key=lambda sp: sp[2] - sp[1])          # innermost first
    labelled = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = next((n for n, s, e in spans if s <= mid <= e), "host")
        labelled.append((label, (g1 - g0) / 1e9))
    labelled.sort(key=lambda lg: -lg[1])
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                        ops=ops, by_name=by_name, idle_gaps=labelled)


def _union(ops, w0: int, w1: int) -> tuple:
    """(covered ns, [(gap start, gap end)]) of the sorted intervals within
    [w0, w1]."""
    covered, gaps, cur = 0, [], w0
    for _, s, e in ops:
        s, e = max(s, w0), min(e, w1)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        covered += e - cur
        cur = e
    if cur < w1:
        gaps.append((cur, w1))
    return covered, gaps


def median_gap_ns(summary: TraceSummary):
    """The median, over the traced window's device operations in order of
    their start, of the time from the end of every operation before one to
    its start, in ns (negative where it overlaps them): inside a device
    program, the launch gap between consecutive nodes. None with fewer than
    two operations."""
    if summary is None or len(summary.ops) < 2:
        return None
    starts = np.array([s for _, s, _ in summary.ops], np.int64)
    ends = np.maximum.accumulate(np.array([e for _, _, e in summary.ops],
                                          np.int64))
    return float(np.median(starts[1:] - ends[:-1]))


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps, with what the host was doing."""
    ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps[:top]]}
