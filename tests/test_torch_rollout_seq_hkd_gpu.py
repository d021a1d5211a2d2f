"""The sequential rollout's CUDA kernel
(`hkdmpc_tpu_torch/csrc/rollout_seq_hkd.cu`) against its plain version
(`solver.rollout.hybrid_rollout_plain`, the loop over T) on a CUDA device,
and its place in the programs: skipped without a card (the kernel has no
CPU mode). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rollout_seq_hkd_gpu.py

Inputs: problems that are not all-shooting, as a fleet's sequential step
solves them: the trot at plan 0.6 s (T = 75) after 2 receding-horizon
updates at B = 1024 and B = 1, and at plan 2.0 s (T = 250) after 2
updates at B = 256, x0 perturbed. Multiple shooting (the restart mask is
the shooting nodes) on the state an eager sequential solve with multiple
shooting leaves (its nominal Xbar, Ubar, the last search direction dX,
the last sweep's K and dU), single shooting (the shooting nodes that start
a phase) on the state a single-shooting solve leaves, as the solver rolls
out its own iterates; in float32 and, cast, in float64; every fifth
scenario's velocity at nodes 10-20 pushed past the divergence norm, so
that its `success` is False. The oracle is the plain version in float64
on the same inputs.
Tolerances as tests/test_torch_rollout_hkd_gpu.py's, on the largest
magnitude of the oracle's trajectory (X and Xsim; the defect is their
difference) or of its controls (U): in float32 1e-5 of it or ten times the
plain float32 version's own error, whichever is larger; in float64 1e-13
of it. `success` equal on every row; the values of a row whose oracle
diverges (the pushed rows, and any that single shooting over the long plan
sends past the norm) are not compared."""
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.ops import rollout_seq_hkd
from hkdmpc_tpu_torch.solver import ddp, graphs, rollout as ro
from hkdmpc_tpu_torch.solver.structs import Rollout, tree_map

pytestmark = pytest.mark.gpu

# name -> (plan, updates, batch)
CASES = {"trot_b1024": (0.6, 2, 1024), "trot_b1": (0.6, 2, 1),
         "trot_t250_b256": (2.0, 2, 256)}
EPS = (1.0, 0.1, 0.01, 0.001)
FORCED_EVERY = 5     # every fifth scenario diverges after node 10
SEQ_NODES = 5_000    # the sequential step program's nodes, at most


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def sequential_problem(plan, updates, batch, seed=0):
    """(prob, state, opt runtime) of `batch` scenarios of the trot at
    `plan` after `updates` receding-horizon updates, in float32 on the
    card, x0 perturbed by a draw seeded `seed`; raises unless the problem
    is not all-shooting."""
    from hkdmpc_tpu_torch.mpc.solver import default_stand_state
    from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                                 replicate_problem)
    from hkdmpc_tpu_torch.workload import trot_problem
    pb, _, _, opt = trot_problem(plan, dtype=torch.float32, device="cuda")
    for _ in range(updates):
        pb.update(1)
    if pb.all_shooting():
        raise AssertionError("the updated trot is all-shooting")
    prob, state = pb.build(default_stand_state(pb.phases[0].contact))
    prob, state = replicate_problem(prob, state, batch)
    prob = perturb_scenarios(prob, noise=np.random.default_rng(seed)
                             .standard_normal((batch, 24)))
    return prob, state, opt.runtime()


def _as(dtype, tree):
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    tree)


@pytest.fixture(scope="module")
def solved(cuda):
    """(name, ms) -> (prob, state, forced) in float32: the state of an
    eager sequential solve with multiple (ms True) or single shooting, as
    the solver rolls out its own iterates; every FORCED_EVERY-th
    scenario's velocity at nodes 10-20 at 2e6."""
    out = {}
    for name, (plan, updates, batch) in CASES.items():
        prob, state, opt = sequential_problem(plan, updates, batch)
        forced = torch.arange(batch, device="cuda") % FORCED_EVERY \
            == FORCED_EVERY - 1
        for ms in (True, False):
            st = ddp._solve_batch(prob, state,
                                  dataclasses.replace(opt, MS=ms),
                                  kernel_jac=True,
                                  parallel_rollout=False).state
            Xbar = st.Xbar.clone()
            Xbar[forced, 10:21, 9] = 2e6
            out[name, ms] = (prob, dataclasses.replace(st, Xbar=Xbar),
                             forced)
    torch.cuda.synchronize()
    return out


def _check(got, plain, oracle, dtype, forced):
    """got, plain: lists of Rollouts of the kernel and of the plain version
    in `dtype`; oracle: the plain version's in float64."""
    for k, q, o in zip(got, plain, oracle):
        assert torch.equal(k.success, o.success)
        assert not bool(k.success[forced].any())
        keep = ~forced & o.success
        assert bool(keep.any())
        xscale = float(torch.cat([o.X[keep], o.Xsim[keep]]).abs().max())
        for name in ("X", "U", "Xsim", "defect"):
            kv, qv, ov = (getattr(r, name)[keep] for r in (k, q, o))
            assert kv.dtype == dtype and kv.shape == ov.shape
            assert bool(torch.isfinite(kv).all()), name
            scale = float(ov.abs().max()) if name == "U" else xscale
            err = float((kv.double() - ov).abs().max())
            if dtype == torch.float64:
                limit = 1e-13 * scale
            else:
                limit = max(1e-5 * scale,
                            10 * float((qv.double() - ov).abs().max()))
            assert err <= limit, (name, err, limit, scale)


def _split(r: Rollout) -> list:
    """A Rollout with a leading candidate axis as one Rollout a candidate."""
    return [tree_map(lambda a: a[i], r) for i in range(r.X.shape[0])]


def _plain(prob, state, eps, ms):
    return [ro.hybrid_rollout_plain(prob, state, eps[i], ms)
            for i in range(eps.shape[0])]


def _launches():
    return rollout_seq_hkd.LAUNCHES, rollout_seq_hkd.LAUNCHES_F64


@pytest.mark.parametrize("ms", [True, False], ids=["ms", "single_shooting"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_candidates_match_plain(solved, name, dtype, ms):
    """The line search's launch: every candidate in one launch."""
    prob, state, forced = solved[name, ms]
    p, s = _as(dtype, prob), _as(dtype, state)
    eps = torch.tensor(EPS, dtype=dtype, device="cuda")
    before = _launches()
    got = ro.hybrid_rollout_seq_candidates(p, s, eps, ms)
    f64 = int(dtype == torch.float64)
    assert _launches() == (before[0] + 1, before[1] + f64)
    assert got.Xsim is not None
    plain = _plain(p, s, eps, ms)
    oracle = _plain(_as(torch.float64, prob), _as(torch.float64, state),
                    eps.double(), ms)
    torch.cuda.synchronize()
    _check(_split(got), plain, oracle, dtype, forced)


@pytest.mark.parametrize("ms", [True, False], ids=["ms", "single_shooting"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_nominal_matches_plain(solved, name, dtype, ms):
    """The nominal rollout: `hybrid_rollout` at eps = 0.0, one launch."""
    prob, state, forced = solved[name, ms]
    p, s = _as(dtype, prob), _as(dtype, state)
    before = _launches()
    got = ro.hybrid_rollout(p, s, 0.0, ms)
    assert _launches()[0] == before[0] + 1
    plain = ro.hybrid_rollout_plain(p, s, 0.0, ms)
    oracle = ro.hybrid_rollout_plain(_as(torch.float64, prob),
                                     _as(torch.float64, state), 0.0, ms)
    torch.cuda.synchronize()
    _check([got], [plain], [oracle], dtype, forced)


@pytest.mark.parametrize("eps", ["number", "0-dim", "per-scenario"])
def test_step_size_forms(solved, eps):
    """A number and a 0-dim tensor take one launch; a (B,) tensor, a step
    size per scenario, which the kernel does not take, the plain loop."""
    prob, state, forced = solved["trot_b1024", True]
    p64, s64 = _as(torch.float64, prob), _as(torch.float64, state)
    nb = prob.kind.shape[0]
    e = {"number": 0.3, "0-dim": torch.tensor(0.1, device="cuda"),
         "per-scenario": torch.linspace(0.001, 1.0, nb, device="cuda")}[eps]
    before = _launches()
    got = ro.hybrid_rollout(prob, state, e, True)
    assert _launches()[0] == before[0] + int(eps != "per-scenario")
    plain = ro.hybrid_rollout_plain(prob, state, e, True)
    oracle = ro.hybrid_rollout_plain(
        p64, s64, e.double() if isinstance(e, torch.Tensor) else e, True)
    torch.cuda.synchronize()
    _check([got], [plain], [oracle], torch.float32, forced)


def test_more_candidates_than_a_pass(solved):
    """More candidates than a block has chain warps take more passes of
    one launch, into one set of outputs."""
    prob, state, forced = solved["trot_t250_b256", True]
    eps = torch.logspace(0, -3, 9, device="cuda")
    before = _launches()
    got = _split(ro.hybrid_rollout_seq_candidates(prob, state, eps, True))
    assert _launches()[0] == before[0] + 1 and len(got) == 9
    oracle = _plain(_as(torch.float64, prob), _as(torch.float64, state),
                    eps.double(), True)
    torch.cuda.synchronize()
    _check(got, _plain(prob, state, eps, True), oracle, torch.float32,
           forced)


def test_graph_capture_equals_eager(solved):
    """A captured CUDA graph of the candidates' launch gives what the eager
    launch gives, bit for bit, and reads its step sizes on replay."""
    prob, state, _ = solved["trot_b1024", True]
    eps = torch.tensor(EPS, device="cuda")
    run = lambda: ro.hybrid_rollout_seq_candidates(prob, state, eps, True)
    want = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = run()
    g.replay()
    torch.cuda.synchronize()
    for f in dataclasses.fields(Rollout):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.is_floating_point():
            a, b = a.nan_to_num(7.0), b.nan_to_num(7.0)
        assert torch.equal(a, b), f.name
    eps.copy_(torch.tensor(EPS[::-1], device="cuda"))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got.X.nan_to_num(7.0),
                       want.X.flip(0).nan_to_num(7.0))
    assert torch.equal(got.success, want.success.flip(0))


def test_refusals(solved):
    prob, state, _ = solved["trot_t250_b256", True]
    s = state
    args = lambda **kw: {**dict(
        kind=prob.kind, x0=prob.x0, contact=prob.contact,
        contact_next=prob.contact_next, dt=prob.dt, restart=prob.ss_mask,
        Xbar=s.Xbar, dX=s.dX, Ubar=s.Ubar, dU=s.dU, K=s.K,
        eps=torch.ones(1, device="cuda")), **kw}
    before = _launches()
    for eps in (1.0, torch.ones(2, 3, device="cuda"),
                torch.ones((), device="cuda")):
        with pytest.raises(ValueError, match="eps: expected an"):
            rollout_seq_hkd.rollout_seq_hkd_cuda(**args(eps=eps))
    with pytest.raises(TypeError, match="eps: dtype"):
        rollout_seq_hkd.rollout_seq_hkd_cuda(**args(
            eps=torch.ones(1, device="cuda", dtype=torch.float64)))
    with pytest.raises(TypeError, match="float32 or float64"):
        rollout_seq_hkd.rollout_seq_hkd_cuda(**args(Xbar=s.Xbar.half()))
    with pytest.raises(TypeError, match="restart: dtype"):
        rollout_seq_hkd.rollout_seq_hkd_cuda(**args(
            restart=prob.ss_mask > 0))
    with pytest.raises(ValueError, match="K: not contiguous"):
        rollout_seq_hkd.rollout_seq_hkd_cuda(**args(K=s.K.transpose(-1, -2)))
    with pytest.raises(ValueError, match="Xbar: data pointer"):
        flat = torch.empty(s.Xbar.numel() + 1, device="cuda")
        rollout_seq_hkd.rollout_seq_hkd_cuda(**args(Xbar=flat[1:].view(
            s.Xbar.shape)))
    assert _launches() == before


def test_solves_never_run_the_plain_loop(cuda, monkeypatch):
    """An eager sequential solve on the card launches the kernel once for
    the nominal rollout and once per line search (2 AL x 1 DDP on the
    trot), and never runs the loop."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain sequential rollout ran on the card")

    monkeypatch.setattr(ro, "hybrid_rollout_plain", refuse)
    prob, state, opt = sequential_problem(0.6, 2, 1024, seed=3)
    rollout_seq_hkd.LAUNCHES = 0
    res = ddp._solve_batch(prob, state, opt, kernel_jac=True,
                           parallel_rollout=False)
    torch.cuda.synchronize()
    assert rollout_seq_hkd.LAUNCHES == 3 and not bool(res.solve_failed.any())


def test_programs_launch_by_rollout_kind(cuda, tmp_path):
    """A fleet step replays one of two step programs; once both are built,
    a sequential step launches the kernel 3 times (carry0 and one per run
    of inner_b) and runs fewer than SEQ_NODES graph nodes, a parallel step
    never launches it; nor does a sweep's replay."""
    from hkdmpc_tpu_torch import bench
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    graphs.clear_graphs()
    f = FleetMPC(gait_file("trot", str(tmp_path)), 16, config=FleetConfig(),
                 dtype=torch.float32, device="cuda")
    f.initialize()
    stream = meas_stream(16, 4)
    seen = {}
    for k in range(40):
        d = stream(k)
        held = {st["label"]: st["replays"] for st in graphs.stats()}
        before = rollout_seq_hkd.LAUNCHES
        f.step(d["rpy"], d["p"], d["v"], d["omega"], d["qJ"])
        launched = rollout_seq_hkd.LAUNCHES - before
        replayed = [st for st in graphs.stats()
                    if st["replays"] > held.get(st["label"], 0)]
        assert len(replayed) == 1, [st["label"] for st in replayed]
        st = replayed[0]
        if st["label"] in held:          # built at an earlier step
            parallel = "parallel_rollout=True" in st["label"]
            want = 0 if parallel else 1 + st["pieces"]["inner_b"]["runs"]
            assert launched == want and (parallel or want == 3), k
            assert st["launches"]["rollout_seq_hkd.LAUNCHES"] == want
            if not parallel:
                assert st["nodes_run"] < SEQ_NODES, st["nodes_run"]
                assert st["launches"]["rollout_hkd.LAUNCHES"] == 0
            seen[st["label"]] = parallel
    assert sorted(seen.values()) == [False, True], seen
    prob, state, opt = bench.scenarios("trot", 1024, 0, "cuda")
    ddp.solve_batch(prob, state, opt, kernel_jac=True)    # the capture
    before = rollout_seq_hkd.LAUNCHES
    ddp.solve_batch(prob, state, opt, kernel_jac=True)
    torch.cuda.synchronize()
    assert rollout_seq_hkd.LAUNCHES == before
    graphs.clear_graphs()
