"""The device programs' stage clock on a CUDA device (`solver/graphs.py`,
the lap and stamp kernels of `csrc/graph_while.cu`): in every replay the
stages sum to the replay's span, its first lap to its last, which lies
inside the CUDA events around the call; the laps per stage follow the
pieces' runs; the clock offset against the host is known to within
`graphs.ALIGN_NS`, and puts a replay inside the host's reads around it;
`outside_program` gives a host span between two replays its time. Skipped
without a card. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stage_clock_gpu.py
"""
import time

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.utils import spans
from hkdmpc_tpu_torch.workload import trot_problem

pytestmark = pytest.mark.gpu

BATCH = 256


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lap kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def solve(cuda):
    _, prob, state, opt = trot_problem(dtype=torch.float32, device=cuda)
    prob, state = replicate_problem(prob, state, BATCH)
    prob = perturb_scenarios(prob, noise=np.random.default_rng(3)
                             .standard_normal((BATCH, 24)))
    optr = opt.runtime()
    graphs.clear_graphs()
    return lambda: ddp.solve_batch(prob, state, optr, kernel_jac=True)


def _program(head):
    got = [g for g in graphs._GRAPHS.values() if g.label.startswith(head)]
    assert len(got) == 1
    return got[0]


def _sleep_cycles(ms):
    """Cycles of `torch.cuda._sleep` that last about `ms` on this card at
    its present clock, from a timed trial sleep."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    return int(10_000_000 * ms / a.elapsed_time(b))


def test_stages_sum_to_the_replay_span_inside_the_events(solve):
    """The stage clock's stages sum to its replay span, and the span lies
    within the CUDA events around the call. The device sleeps (about 10 ms)
    while the host enqueues each call, so the events time only the call's
    device work: host gaps inside a call are not what this test sees."""
    solve()
    torch.cuda.synchronize()
    cycles = _sleep_cycles(10.0)
    event_ms = []
    for _ in range(4):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        a.record()
        solve()
        b.record()
        torch.cuda.synchronize()
        event_ms.append(a.elapsed_time(b))
    graphs.fold_counts()
    g = _program(f"solve_batch(B={BATCH},")
    rows = graphs.ring(g.clock)
    assert [k for k, _ in rows][-4:] == list(range(g.replays - 4,
                                                   g.replays))
    for _, row in rows:
        assert int(row[2:].sum()) == int(row[1] - row[0]) > 0
    for (_, row), ms in zip(rows[-4:], event_ms):
        span_ms = (row[1] - row[0]) / 1e6
        assert 0.9 * ms <= span_ms <= ms + 0.01, (span_ms, ms)
    # the laps per stage follow the pieces' runs (no retry on these inputs)
    runs = dict(zip((p.name for p in g.pieces), g.last_runs))
    laps = dict(zip(graphs.STAGES, g.clock[0, 2:].tolist()))
    assert runs["retry"] == 0
    assert laps["rollout"] == g.replays * (runs["carry0"]
                                           + runs["inner_b"])
    assert laps["backward"] == g.replays * (runs["inner_a"]
                                            + runs["inner_b"])
    assert laps["lq"] == laps["step_io"] == 0
    st = [s for s in graphs.stats() if s["label"] == g.label][0]
    assert st["device_ms"] == pytest.approx(np.median(
        [(r[1] - r[0]) / 1e6 for _, r in rows]))
    assert sum(st["stage_ms"].values()) == pytest.approx(st["device_ms"],
                                                         rel=0.02)


def test_clock_offset_is_known_and_puts_a_replay_inside_its_call(solve,
                                                                  cuda):
    solve()
    _, off, unc = graphs.clock_offset(cuda)
    assert 0 <= unc < graphs.ALIGN_NS
    _, off2, unc2 = graphs.clock_offset(cuda)
    assert abs(off2 - off) <= unc + unc2 + 10_000
    torch.cuda.synchronize()
    t0 = time.time_ns()
    solve()
    torch.cuda.synchronize()
    t1 = time.time_ns()
    rec = [r for r in graphs.replay_records()
           if r["label"].startswith(f"solve_batch(B={BATCH},")][-1]
    assert rec["uncertainty_ns"] < graphs.ALIGN_NS
    slack = rec["uncertainty_ns"] + 10_000
    assert t0 - slack <= rec["start_ns"] <= rec["end_ns"] <= t1 + slack


def test_outside_program_gives_a_host_span_its_time(solve):
    solve()
    torch.cuda.synchronize()
    with spans.span("test.pause"):
        time.sleep(0.005)
    solve()
    torch.cuda.synchronize()
    gap = graphs.outside_program()[-1]
    assert gap["ms"] >= 5.0
    assert sum(gap["by_span"].values()) == pytest.approx(gap["ms"])
    assert gap["by_span"]["test.pause"] >= 4.9
    assert "unaligned" not in gap["by_span"]


def test_spans_are_host_events_under_a_card_profiler(solve):
    """Under a profiler of the card a span is a host-side event only: no
    device-side range over the kernels launched inside it."""
    from torch.profiler import ProfilerActivity, profile
    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    hkd = [(e.name(), str(e.device_type()))
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(spans.PREFIX)]
    assert ("hkd.graphs.launch", "DeviceType.CPU") in hkd
    assert all(dev.endswith("CPU") for _, dev in hkd), hkd
