"""The parallel rollout's CUDA kernel (`hkdmpc_tpu_torch/csrc/rollout_hkd.cu`)
against its plain PyTorch version on a CUDA device, and its place in the
solves: skipped without a card (the kernel has no CPU mode). This file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rollout_hkd_gpu.py

Inputs: the state an eager solve leaves (its nominal Xbar, Ubar, the last
search direction dX, the last sweep's K and dU) of the trot at B = 4096,
the interleaved trot + flytrot batch at B = 1024, the 2.0 s plan (T = 250,
RESETs, PADs and a late last node) at B = 256 and one trot scenario, in
float32 and, cast, in float64; every fifth scenario's nodes 10-20 pushed
past the divergence norm, so that its `success` is False. The oracle is the
plain version in float64 on the same inputs. Tolerances, on the largest
magnitude of the oracle's trajectory (X and Xsim; the defect is their
difference) or of its controls (U): the kernel contracts eps dX + Xbar,
eps du + Ubar and the maps' products into fused multiply-adds and sums K dX
in another order than the plain version, so in float32 each output is held
to 1e-5 of that magnitude or ten times the plain float32 version's own
error, whichever is larger; in float64 to 1e-13 of it. `success` equal on
every row; the pushed rows' values are not compared."""
import dataclasses

import pytest
import torch

from hkdmpc_tpu_torch import bench
from hkdmpc_tpu_torch.ops import precise, rollout_hkd
from hkdmpc_tpu_torch.solver import ddp, graphs, rollout as ro
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import Rollout, tree_map

pytestmark = pytest.mark.gpu

CASES = ("trot_b4096", "mixed_b1024", "trot_t250_b256", "trot_b1")
EPS = (1.0, 0.1, 0.01, 0.001)
FORCED_EVERY = 5     # every fifth scenario diverges after node 10


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _problem(name):
    if name == "mixed_b1024":
        cases, opt = bench.mixed_layouts("cuda", 1024)
        return (*cases["interleaved"], opt)
    if name == "trot_t250_b256":
        return bench.scenarios("trot", 256, 0, "cuda", 2.0)
    return bench.scenarios("trot", int(name.split("_b")[1]), 0, "cuda")


def _as(dtype, tree):
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    tree)


@pytest.fixture(scope="module")
def solved(cuda):
    """name -> (prob, state, forced) in float32: the state of an eager
    solve, every FORCED_EVERY-th scenario's velocity at nodes 10-20 at 2e6
    (a DYN transition from one of them diverges)."""
    out = {}
    for name in CASES:
        prob, state, opt = _problem(name)
        st = ddp._solve_batch(prob, state, opt, kernel_jac=True).state
        forced = torch.arange(prob.kind.shape[0], device="cuda") \
            % FORCED_EVERY == FORCED_EVERY - 1
        Xbar = st.Xbar.clone()
        Xbar[forced, 10:21, 9] = 2e6
        out[name] = (prob, dataclasses.replace(st, Xbar=Xbar), forced)
    torch.cuda.synchronize()
    return out


def _check(got, plain, oracle, dtype, forced):
    """got, plain: lists of Rollouts of the kernel and of the plain version
    in `dtype`; oracle: the plain version's in float64."""
    keep = ~forced
    for k, q, o in zip(got, plain, oracle):
        assert torch.equal(k.success, o.success)
        assert not bool(k.success[forced].any())
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


def _plain_candidates(prob, state, eps):
    du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
    return [rollout_hkd.rollout_plain(prob, state, eps[i], du_eff)
            for i in range(eps.shape[0])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_candidates_match_plain(solved, name, dtype):
    """The line search's launch: every candidate in one launch."""
    prob, state, forced = solved[name]
    p, s = _as(dtype, prob), _as(dtype, state)
    eps = torch.tensor(EPS, dtype=dtype, device="cuda")
    before = (rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64)
    got = _split(rollout_hkd.rollout_hkd_candidates(p, s, eps))
    f64 = int(dtype == torch.float64)
    assert (rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64) == (
        before[0] + 1, before[1] + f64)
    plain = _plain_candidates(p, s, eps)
    p64, s64 = _as(torch.float64, prob), _as(torch.float64, state)
    oracle = _plain_candidates(p64, s64, eps.double())
    torch.cuda.synchronize()
    _check(got, plain, oracle, dtype, forced)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("eps", ["zero", "number", "per-scenario"])
def test_single_step_size_matches_plain(solved, eps, dtype):
    """`hybrid_rollout_parallel` on the card: the nominal rollout (0.0), a
    number, a (B,) tensor; and the candidates with (n_eps, B) step sizes,
    on the batch whose rows follow two schedules."""
    prob, state, forced = solved["mixed_b1024"]
    assert not torch.equal(prob.kind[0], prob.kind[1])
    p, s = _as(dtype, prob), _as(dtype, state)
    p64, s64 = _as(torch.float64, prob), _as(torch.float64, state)
    nb = prob.kind.shape[0]
    e = {"zero": 0.0, "number": 0.3,
         "per-scenario": torch.linspace(0.001, 1.0, nb, device="cuda")}[eps]
    got = ro.hybrid_rollout_parallel(p, s, e)
    plain = rollout_hkd.rollout_plain(p, s, e)
    oracle = rollout_hkd.rollout_plain(
        p64, s64, e.double() if isinstance(e, torch.Tensor) else e)
    torch.cuda.synchronize()
    _check([got], [plain], [oracle], dtype, forced)
    if isinstance(e, torch.Tensor):
        cand = torch.stack([e, e.flip(0)])
        got = _split(ro.hybrid_rollout_candidates(p, s, cand.to(dtype)))
        plain = _plain_candidates(p, s, cand.to(dtype))
        oracle = _plain_candidates(p64, s64, cand.double())
        _check(got, plain, oracle, dtype, forced)


def test_du_eff_given(solved):
    """With du_eff given, the kernel reads it in the place of dU + K dX."""
    prob, state, forced = solved["trot_t250_b256"]
    du_eff = state.dU + 0.25
    got = ro.hybrid_rollout_parallel(prob, state, 0.5, du_eff=du_eff)
    plain = rollout_hkd.rollout_plain(prob, state, 0.5, du_eff)
    s64 = _as(torch.float64, state)
    oracle = rollout_hkd.rollout_plain(_as(torch.float64, prob), s64, 0.5,
                                       du_eff.double())
    _check([got], [plain], [oracle], torch.float32, forced)


def test_more_candidates_than_a_launch_holds(solved):
    """More than MAX_EPS candidates take one launch for each MAX_EPS, into
    one set of outputs, and match the plain version."""
    prob, state, forced = solved["trot_t250_b256"]
    n = rollout_hkd.MAX_EPS + 8
    eps = torch.logspace(0, -3, n, device="cuda")
    before = rollout_hkd.LAUNCHES
    got = _split(rollout_hkd.rollout_hkd_candidates(prob, state, eps))
    assert rollout_hkd.LAUNCHES == before + 2 and len(got) == n
    plain = _plain_candidates(prob, state, eps)
    oracle = _plain_candidates(_as(torch.float64, prob),
                               _as(torch.float64, state), eps.double())
    torch.cuda.synchronize()
    _check(got, plain, oracle, torch.float32, forced)


def test_graph_capture_equals_eager(solved):
    """A captured CUDA graph of the candidates' launch gives what the eager
    launch gives, bit for bit, and reads its step sizes on replay."""
    prob, state, _ = solved["trot_b4096"]
    eps = torch.tensor(EPS, device="cuda")
    want = rollout_hkd.rollout_hkd_candidates(prob, state, eps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        rollout_hkd.rollout_hkd_candidates(prob, state, eps)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = rollout_hkd.rollout_hkd_candidates(prob, state, eps)
    g.replay()
    torch.cuda.synchronize()
    got, want = _split(got), _split(want)
    for a, b in zip(got, want):
        for f in dataclasses.fields(Rollout):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    eps.copy_(torch.tensor(EPS[::-1], device="cuda"))
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want[::-1]):
        assert torch.equal(a.X, b.X) and torch.equal(a.success, b.success)


def test_refusals(solved):
    prob, state, _ = solved["trot_t250_b256"]
    s = state
    args = lambda **kw: {**dict(
        kind=prob.kind, x0=prob.x0, contact=prob.contact,
        contact_next=prob.contact_next, dt=prob.dt, Xbar=s.Xbar, dX=s.dX,
        Ubar=s.Ubar, dU=s.dU, K=s.K, eps=1.0), **kw}
    before = rollout_hkd.LAUNCHES
    with pytest.raises(TypeError, match="eps as a number or a tensor"):
        rollout_hkd.rollout_hkd_cuda(**args(eps="1"))
    with pytest.raises(ValueError, match="eps: shape"):
        rollout_hkd.rollout_hkd_cuda(**args(
            eps=torch.ones(2, 3, device="cuda")))
    with pytest.raises(TypeError, match="eps: dtype"):
        rollout_hkd.rollout_hkd_cuda(**args(
            eps=torch.ones(2, device="cuda", dtype=torch.float64)))
    with pytest.raises(TypeError, match="float32 or float64"):
        rollout_hkd.rollout_hkd_cuda(**args(Xbar=s.Xbar.half()))
    with pytest.raises(TypeError, match="dU: dtype"):
        rollout_hkd.rollout_hkd_cuda(**args(dU=s.dU.double()))
    with pytest.raises(ValueError, match="K: not contiguous"):
        rollout_hkd.rollout_hkd_cuda(**args(K=s.K.transpose(-1, -2)))
    with pytest.raises(ValueError, match="Xbar: data pointer"):
        flat = torch.empty(s.Xbar.numel() + 1, device="cuda")
        rollout_hkd.rollout_hkd_cuda(**args(Xbar=flat[1:].view(
            s.Xbar.shape)))
    with pytest.raises(ValueError, match="U.*shape"):
        rollout_hkd.rollout_hkd_cuda(**args(Ubar=s.Xbar))
    assert rollout_hkd.LAUNCHES == before


@pytest.mark.parametrize("kernel_jac", [True, False], ids=["K1", "swing"])
def test_solves_never_run_the_plain_version(cuda, monkeypatch, kernel_jac):
    """An eager solve on the card launches the kernel once for the nominal
    rollout and once per line search (2 AL x 1 DDP on the trot), for the
    default model and the swing-clearance spec, and never calls the plain
    version."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain rollout ran on the card")

    from hkdmpc_tpu_torch.parallel.batch import replicate_problem
    from hkdmpc_tpu_torch.workload import trot_problem

    monkeypatch.setattr(rollout_hkd, "rollout_plain", refuse)
    model = None if kernel_jac else hkd_model_spec(swing_constraint=True)
    _, prob, state, opt = trot_problem(dtype=torch.float32, device="cuda",
                                       model=model)
    prob, state = replicate_problem(prob, state, 1024)
    opt = opt.runtime()
    rollout_hkd.LAUNCHES = 0
    res = ddp._solve_batch(prob, state, opt, kernel_jac=kernel_jac,
                           model=model)
    torch.cuda.synchronize()
    assert rollout_hkd.LAUNCHES == 3 and not bool(res.solve_failed.any())


def _record(head):
    got = [st for st in graphs.stats() if st["label"].startswith(head)]
    assert len(got) == 1, [st["label"] for st in graphs.stats()]
    return got[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_program_launches_once_and_per_inner_b(cuda, dtype):
    """A solve program's replay launches the kernel once in its `carry0`
    piece (the nominal rollout) and once per run of its `inner_b` piece
    (the line search), counted on the device and folded in when read, in
    the dtype's counter; and the replay equals the eager body bit for
    bit."""
    prob, state, opt = _problem("trot_b1024")
    prob, state = _as(dtype, prob), _as(dtype, state)
    graphs.clear_graphs()
    ddp.solve_batch(prob, state, opt, kernel_jac=True)   # the capture
    torch.cuda.synchronize()
    rollout_hkd.LAUNCHES = rollout_hkd.LAUNCHES_F64 = 0
    got = ddp.solve_batch(prob, state, opt, kernel_jac=True)
    torch.cuda.synchronize()
    st = _record("solve_batch(B=1024,")
    inner_b = st["pieces"]["inner_b"]["runs"]
    assert inner_b == 2 and st["pieces"]["carry0"]["runs"] == 1
    assert rollout_hkd.LAUNCHES == 1 + inner_b
    assert rollout_hkd.LAUNCHES_F64 == (
        1 + inner_b if dtype == torch.float64 else 0)
    assert st["launches"]["rollout_hkd.LAUNCHES"] == 1 + inner_b
    for piece, n in (("carry0", 1), ("inner_b", 1), ("inner_a", 0)):
        assert st["pieces"][piece]["launches"]["rollout_hkd.LAUNCHES"] == n
    want = ddp._solve_batch(prob, state, opt, kernel_jac=True)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        for x, y in zip(graphs.leaves(a), graphs.leaves(b)):
            assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)), f.name
    graphs.clear_graphs()


def test_fleet_steps_launch_by_rollout_kind(cuda, tmp_path):
    """A fleet step replays one of two step programs; once both are built,
    a parallel-rollout step launches the kernel once and once per run of
    its `inner_b` (3 a step on the trot), a sequential-rollout step never."""
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
        before = rollout_hkd.LAUNCHES
        f.step(d["rpy"], d["p"], d["v"], d["omega"], d["qJ"])
        launched = rollout_hkd.LAUNCHES - before
        replayed = [st for st in graphs.stats()
                    if st["replays"] > held.get(st["label"], 0)]
        assert len(replayed) == 1, [st["label"] for st in replayed]
        st = replayed[0]
        if st["label"] in held:          # built at an earlier step
            parallel = "parallel_rollout=True" in st["label"]
            want = 1 + st["pieces"]["inner_b"]["runs"] if parallel else 0
            assert launched == want and (want == 3 or not parallel), k
            seen[st["label"]] = parallel
    assert sorted(seen.values()) == [False, True], seen
    graphs.clear_graphs()
