"""The cost kernel (`hkdmpc_tpu_torch/csrc/cost_hkd.cu`) against its plain
PyTorch version on a CUDA device, and its place in the solves: skipped
without a card (the kernel has no CPU mode). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cost_hkd_gpu.py

Inputs: the state an eager solve leaves (its nominal Xbar, Ubar, the last
search direction, gains and constraint state, the AL and ReB rows updated)
of the trot at B = 4096, 1024 and 1, the interleaved trot + flytrot batch at
B = 1024 and the 2.0 s plan (T = 250) at B = 256, in float32 and, cast, in
float64; the evaluations are the line search's four candidates from the
rollout kernel. The oracle is the plain version (`compute_cost`,
`dynamics_feasibility`, `max_violations`) in float64 on the same inputs.
Tolerances, on the largest magnitude of the oracle's output: the kernel sums
in another order than the plain version and contracts products into fused
multiply-adds, so in float32 each output is held to 1e-5 of that magnitude
or ten times the plain float32 version's own error, whichever is larger; in
float64 to 1e-13 of it. The maxima are minima and maxima of the kernel's
own rows: equal to `max_violations` of them, bit for bit."""
import dataclasses

import pytest
import torch

from hkdmpc_tpu_torch import bench
from hkdmpc_tpu_torch.ops import cost_hkd, rollout_hkd
from hkdmpc_tpu_torch.solver import ddp, graphs, rollout as ro
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import tree_map

pytestmark = pytest.mark.gpu

CASES = ("trot_b4096", "trot_b1024", "mixed_b1024", "trot_t250_b256",
         "trot_b1")
EPS = (1.0, 0.1, 0.01, 0.001)
NAMES = ("cost", "g_all", "h", "feas", "max_pconstr", "max_tconstr")


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
    """name -> (prob, state, (X, U, defect)) in float32: the state of an
    eager solve and the line search's four candidates on it (a leading
    candidate axis)."""
    out = {}
    for name in CASES:
        prob, state, opt = _problem(name)
        st = ddp._solve_batch(prob, state, opt, kernel_jac=True).state
        r = rollout_hkd.rollout_hkd_candidates(
            prob, st, torch.tensor(EPS, device="cuda"))
        out[name] = (prob, st, (r.X, r.U, r.defect))
    torch.cuda.synchronize()
    return out


def _inputs(solved, name, dtype):
    prob, st, xud = solved[name]
    return _as(dtype, prob), _as(dtype, st.constr), [a.to(dtype)
                                                     for a in xud]


def _plain(prob, constr, X, U, D, reb=True, al=True):
    return [torch.stack(f) for f in zip(*(
        (c, g, h, f, mp, mt) for c, (g, h), f, (mp, mt) in (
            ro._evaluate_plain(prob, X[i], U[i], D[i], constr, reb, al, None,
                               True)
            for i in range(X.shape[0]))))]


def _kernel(prob, constr, X, U, D, reb=True, al=True):
    return list(cost_hkd.cost_hkd(prob, X, U, D, constr, reb, al))


def _check(prob, got, plain, oracle, dtype):
    """got, plain: the kernel's and the plain version's outputs in dtype;
    oracle: the plain version's in float64."""
    for name, k, q, o in zip(NAMES, got, plain, oracle):
        assert k.dtype == dtype and k.shape == o.shape, name
        assert bool(torch.isfinite(k).all()), name
        scale = max(float(o.abs().max()), 1e-30)
        err = float((k.double() - o).abs().max())
        if dtype == torch.float64:
            limit = 1e-13 * scale
        else:
            limit = max(1e-5 * scale, 10 * float((q.double() - o).abs().max()))
        assert err <= limit, (name, err, limit, scale)
    for e in range(got[0].shape[0]):
        mp, mt = ro.max_violations(prob, got[1][e], got[2][e])
        assert torch.equal(got[4][e], mp) and torch.equal(got[5][e], mt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_candidates_match_plain(solved, name, dtype):
    """The line search's launch: every candidate in one launch."""
    prob, constr, (X, U, D) = _inputs(solved, name, dtype)
    before = (cost_hkd.LAUNCHES, cost_hkd.LAUNCHES_F64)
    got = _kernel(prob, constr, X, U, D)
    f64 = int(dtype == torch.float64)
    assert (cost_hkd.LAUNCHES, cost_hkd.LAUNCHES_F64) == (
        before[0] + 1, before[1] + f64)
    plain = _plain(prob, constr, X, U, D)
    p64, c64, xud64 = _inputs(solved, name, torch.float64)
    oracle = _plain(p64, c64, *xud64)
    torch.cuda.synchronize()
    _check(prob, got, plain, oracle, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_candidates_equal_single_launches(solved, dtype):
    """An n_eps-candidate launch gives what n_eps launches of one
    evaluation give, bit for bit, and `evaluate` of one trajectory is the
    same launch without the evaluation axis."""
    prob, constr, (X, U, D) = _inputs(solved, "mixed_b1024", dtype)
    got = _kernel(prob, constr, X, U, D)
    for e in range(X.shape[0]):
        one = _kernel(prob, constr, X[e:e + 1], U[e:e + 1], D[e:e + 1])
        for name, a, b in zip(NAMES, got, one):
            assert torch.equal(a[e], b[0]), (name, e)
    cost, (g, h), feas, (mp, mt) = ro.evaluate(prob, X[2], U[2], D[2], constr,
                                               True, True)
    for name, a, b in zip(NAMES, got, (cost, g, h, feas, mp, mt)):
        assert torch.equal(a[2], b), name


@pytest.mark.parametrize("reb,al", [(False, True), (True, False),
                                    (False, False)])
def test_flags(solved, reb, al):
    """The ReB barrier, the AL penalty or both off, in float32 and float64
    on the trot at B = 1024."""
    for dtype in (torch.float32, torch.float64):
        prob, constr, (X, U, D) = _inputs(solved, "trot_b1024", dtype)
        got = _kernel(prob, constr, X, U, D, reb, al)
        plain = _plain(prob, constr, X, U, D, reb, al)
        p64, c64, xud64 = _inputs(solved, "trot_b1024", torch.float64)
        oracle = _plain(p64, c64, *xud64, reb, al)
        _check(prob, got, plain, oracle, dtype)


def test_shared_references_are_read_at_stride_zero(solved):
    """References shared across the batch (an expanded row, batch stride 0)
    give what their contiguous copies give, bit for bit."""
    prob, constr, (X, U, D) = _inputs(solved, "trot_b1024", torch.float32)
    nb = prob.kind.shape[0]
    shared = dataclasses.replace(
        prob, xr=prob.xr[:1].expand_as(prob.xr),
        ur=prob.ur[:1].expand_as(prob.ur),
        foot_r=prob.foot_r[:1].expand_as(prob.foot_r),
        term_mask=prob.term_mask[:1].expand_as(prob.term_mask),
        dt=prob.dt[:1].expand(nb))
    copied = dataclasses.replace(
        shared, **{k: getattr(shared, k).contiguous()
                   for k in ("xr", "ur", "foot_r", "term_mask", "dt")})
    assert shared.xr.stride(0) == 0
    for a, b in zip(_kernel(shared, constr, X, U, D),
                    _kernel(copied, constr, X, U, D)):
        assert torch.equal(a, b)


def test_nan_reaches_what_the_plain_version_reaches(solved):
    """A NaN in one candidate's joint angle makes its scenario's cost and
    touchdown maximum NaN, as in the plain version, and nothing else."""
    prob, constr, (X, U, D) = _inputs(solved, "trot_b1024", torch.float32)
    X = X.clone()
    X[1, 3, 30, 13] = float("nan")
    got = _kernel(prob, constr, X, U, D)
    plain = _plain(prob, constr, X, U, D)
    for name, a, b in zip(NAMES, got, plain):
        assert torch.equal(a.isnan(), b.isnan()), name
    assert bool(got[0][1, 3].isnan()) and int(got[0].isnan().sum()) == 1


def test_graph_capture_equals_eager(solved):
    """A captured CUDA graph of the candidates' launch gives what the eager
    launch gives, bit for bit, and reads its inputs on replay."""
    prob, constr, xud = _inputs(solved, "trot_b4096", torch.float32)
    X, U, D = (a.clone() for a in xud)
    want = _kernel(prob, constr, X, U, D)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        _kernel(prob, constr, X, U, D)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = _kernel(prob, constr, X, U, D)
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a in (X, U, D):
        a.copy_(a.flip(0))
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b.flip(0))


def test_refusals(solved):
    prob, constr, (X, U, D) = _inputs(solved, "trot_t250_b256",
                                      torch.float32)
    args = lambda **kw: {**dict(
        X=X, U=U, defect=D, kind=prob.kind, dt=prob.dt, xr=prob.xr,
        ur=prob.ur, foot_r=prob.foot_r, contact=prob.contact,
        term_contact=prob.term_contact, td_mask=prob.td_mask,
        term_mask=prob.term_mask, reb_delta=constr.reb_delta,
        reb_eps=constr.reb_eps, al_sigma=constr.al_sigma,
        al_lambda=constr.al_lambda), **kw}
    before = cost_hkd.LAUNCHES
    with pytest.raises(TypeError, match="float32 or float64"):
        cost_hkd.cost_hkd_cuda(**args(X=X.half()))
    with pytest.raises(TypeError, match="U: dtype"):
        cost_hkd.cost_hkd_cuda(**args(U=U.double()))
    with pytest.raises(ValueError, match="X: shape"):
        cost_hkd.cost_hkd_cuda(**args(X=X[0]))
    with pytest.raises(ValueError, match="defect: not contiguous"):
        cost_hkd.cost_hkd_cuda(**args(defect=D.transpose(2, 3)
                                      .contiguous().transpose(2, 3)))
    with pytest.raises(ValueError, match="xr: rows not contiguous"):
        cost_hkd.cost_hkd_cuda(**args(xr=prob.xr.transpose(1, 2)
                                      .contiguous().transpose(1, 2)))
    with pytest.raises(TypeError, match="kind: dtype"):
        cost_hkd.cost_hkd_cuda(**args(kind=prob.kind.long()))
    with pytest.raises(ValueError, match="reb_delta: shape"):
        cost_hkd.cost_hkd_cuda(**args(reb_delta=constr.reb_delta[..., :4]))
    assert cost_hkd.LAUNCHES == before


@pytest.mark.parametrize("path", ["K1", "dense", "swing"])
def test_solves_never_run_the_plain_version(cuda, monkeypatch, path):
    """An eager solve on the card launches the kernel for the nominal
    rollout, once per DDP iteration and once per line search (5 on the trot:
    2 AL x 1 DDP), with the default model on K1 and on the dense path, and
    never evaluates by the plain version; the swing-clearance spec launches
    it never."""
    from hkdmpc_tpu_torch.parallel.batch import replicate_problem
    from hkdmpc_tpu_torch.workload import trot_problem

    def refuse(*args, **kwargs):
        raise AssertionError("the plain cost ran on the card")

    model = hkd_model_spec(swing_constraint=True) if path == "swing" \
        else None
    if path != "swing":
        monkeypatch.setattr(ro, "_evaluate_plain", refuse)
    _, prob, state, opt = trot_problem(dtype=torch.float32, device="cuda",
                                       model=model)
    prob, state = replicate_problem(prob, state, 1024)
    opt = opt.runtime()
    cost_hkd.LAUNCHES = 0
    res = ddp._solve_batch(prob, state, opt, kernel_jac=path == "K1",
                           model=model)
    torch.cuda.synchronize()
    assert not bool(res.solve_failed.any())
    assert cost_hkd.LAUNCHES == (0 if path == "swing" else 5)


def _record(head):
    got = [st for st in graphs.stats() if st["label"].startswith(head)]
    assert len(got) == 1, [st["label"] for st in graphs.stats()]
    return got[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_program_launches_once_a_piece(cuda, dtype):
    """A solve program's replay launches the kernel once in `carry0` and
    once per run of `inner_a` and of `inner_b`, counted on the device and
    folded in when read, in the dtype's counter (5 on the trot); and the
    replay equals the eager body bit for bit."""
    prob, state, opt = _problem("trot_b1024")
    prob, state = _as(dtype, prob), _as(dtype, state)
    graphs.clear_graphs()
    ddp.solve_batch(prob, state, opt, kernel_jac=True)   # the capture
    torch.cuda.synchronize()
    cost_hkd.LAUNCHES = cost_hkd.LAUNCHES_F64 = 0
    got = ddp.solve_batch(prob, state, opt, kernel_jac=True)
    torch.cuda.synchronize()
    st = _record("solve_batch(B=1024,")
    runs = {p: st["pieces"][p]["runs"] for p in ("carry0", "inner_a",
                                                  "inner_b")}
    assert runs == {"carry0": 1, "inner_a": 2, "inner_b": 2}
    assert cost_hkd.LAUNCHES == 5
    assert cost_hkd.LAUNCHES_F64 == (5 if dtype == torch.float64 else 0)
    assert st["launches"]["cost_hkd.LAUNCHES"] == 5
    for piece in runs:
        assert st["pieces"][piece]["launches"]["cost_hkd.LAUNCHES"] == 1
    want = ddp._solve_batch(prob, state, opt, kernel_jac=True)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        for x, y in zip(graphs.leaves(a), graphs.leaves(b)):
            assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)), f.name
    graphs.clear_graphs()


def test_fleet_steps_launch_in_both_programs(cuda, tmp_path):
    """A fleet step replays one of two step programs; once both are built,
    each step launches the kernel once for its nominal rollout and once per
    run of its `inner_a` and `inner_b`, the parallel and the sequential
    step alike (the sequential line search's candidates stacked)."""
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
        before = cost_hkd.LAUNCHES
        f.step(d["rpy"], d["p"], d["v"], d["omega"], d["qJ"])
        launched = cost_hkd.LAUNCHES - before
        replayed = [st for st in graphs.stats()
                    if st["replays"] > held.get(st["label"], 0)]
        assert len(replayed) == 1, [st["label"] for st in replayed]
        st = replayed[0]
        if st["label"] in held:          # built at an earlier step
            pieces = st["pieces"]
            want = (1 + pieces["inner_a"]["runs"]
                    + pieces["inner_b"]["runs"])
            assert launched == want and want > 0, k
            seen[st["label"]] = "parallel_rollout=True" in st["label"]
    assert sorted(seen.values()) == [False, True], seen
    graphs.clear_graphs()
