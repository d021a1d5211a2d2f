"""The linear rollout's CUDA kernel (`hkdmpc_tpu_torch/csrc/
linear_rollout_hkd.cu`) against its plain PyTorch version on a CUDA device,
and its place in the solves: skipped without a card (the kernel has no CPU
mode). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_linear_rollout_gpu.py

Inputs: the state an eager solve leaves (its nominal X, U, defect, the last
sweep's K and dU, the constraint rows) of the trot at B = 4096 and
B = 1024, the interleaved trot + flytrot batch at B = 1024 and the 2.0 s
plan (T = 250, RESETs, PADs and a late last node) at B = 256, in float32
and, cast, in float64. The oracle is the plain version in float64 on the
same inputs. Tolerances: the kernel sums in another order than the plain
version (a row's 24 products in two partial sums, dV by lane and then over
the warp), so in float32 each output is held to 1e-5 of the oracle's
largest magnitude or ten times the plain float32 version's own error,
whichever is larger (the readings are near 1e-6); in float64 to 1e-12 of
the largest magnitude (readings near 1e-15)."""
import dataclasses

import pytest
import torch

from hkdmpc_tpu_torch import bench
from hkdmpc_tpu_torch.ops import linear_rollout_hkd as lr
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.solver.structs import tree_map

pytestmark = pytest.mark.gpu

CASES = ("trot_b4096", "trot_b1024", "mixed_b1024", "trot_t250_b256")
FLAGS = [(True, True), (False, True), (True, False), (False, False)]


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
    """name -> (prob, state) in float32: the state of an eager solve."""
    out = {}
    for name in CASES:
        prob, state, opt = _problem(name)
        res = ddp._solve_batch(prob, state, opt, kernel_jac=True)
        out[name] = (prob, res.state)
    torch.cuda.synchronize()
    return out


def _run(fn, prob, state, reb=True, al=True):
    s = state
    return fn(prob, s, s.Xbar, s.Ubar, s.defect_bar, 1.0, reb, al)


def _check(prob, state, dtype, reb=True, al=True):
    p, s = _as(dtype, prob), _as(dtype, state)
    before = (lr.LAUNCHES, lr.LAUNCHES_F64)
    got = _run(lr.linear_rollout_hkd, p, s, reb, al)
    f64 = int(dtype == torch.float64)
    assert (lr.LAUNCHES, lr.LAUNCHES_F64) == (before[0] + 1, before[1] + f64)
    plain = _run(lr.linear_rollout_hkd_plain, p, s, reb, al)
    oracle = _run(lr.linear_rollout_hkd_plain, _as(torch.float64, prob),
                  _as(torch.float64, state), reb, al)
    torch.cuda.synchronize()
    for name, k, q, o in zip(("dX", "dv1", "dv2"), got, plain, oracle):
        assert k.dtype == dtype and k.shape == o.shape
        assert bool(torch.isfinite(k).all()), name
        scale = float(o.abs().max())
        err = float((k.double() - o).abs().max())
        if dtype == torch.float64:
            limit = 1e-12 * scale
        else:
            limit = max(1e-5 * scale,
                        10 * float((q.double() - o).abs().max()))
        assert err <= limit, (name, err, limit, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(solved, name, dtype):
    prob, state = solved[name]
    _check(prob, state, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("reb,al", FLAGS, ids=lambda f: str(int(f)))
def test_flags_as_the_plain_version(solved, reb, al, dtype):
    """Each (reb_active, al_active) combination, on the batch whose rows
    follow two schedules."""
    prob, state = solved["mixed_b1024"]
    assert not torch.equal(prob.kind[0], prob.kind[1])
    _check(prob, state, dtype, reb, al)


def test_refusals(solved):
    prob, state = solved["trot_b1024"]
    s, c = state, state.constr
    args = lambda **kw: {**dict(
        kind=prob.kind, X=s.Xbar, U=s.Ubar, contact=prob.contact,
        contact_next=prob.contact_next, xr=prob.xr, ur=prob.ur,
        foot_r=prob.foot_r, reb_delta=c.reb_delta, reb_eps=c.reb_eps,
        term_contact=prob.term_contact, td_mask=prob.td_mask,
        al_sigma=c.al_sigma, al_lambda=c.al_lambda,
        term_mask=prob.term_mask, defect=s.defect_bar, dU=s.dU, K=s.K,
        dt=prob.dt, eps=1.0), **kw}
    before = lr.LAUNCHES
    with pytest.raises(TypeError, match="eps as a number"):
        lr.linear_rollout_hkd_cuda(**args(eps=torch.ones((), device="cuda")))
    with pytest.raises(TypeError, match="float32 or float64"):
        lr.linear_rollout_hkd_cuda(**args(X=s.Xbar.half()))
    with pytest.raises(TypeError, match="dU: dtype"):
        lr.linear_rollout_hkd_cuda(**args(dU=s.dU.double()))
    with pytest.raises(ValueError, match="K: not contiguous"):
        lr.linear_rollout_hkd_cuda(**args(K=s.K.transpose(-1, -2)))
    with pytest.raises(ValueError, match="K: data pointer"):
        flat = torch.empty(s.K.numel() + 1, device="cuda")
        lr.linear_rollout_hkd_cuda(**args(K=flat[1:].view(s.K.shape)))
    with pytest.raises(ValueError, match="U: shape"):
        lr.linear_rollout_hkd_cuda(**args(U=s.Xbar))
    assert lr.LAUNCHES == before


def test_solves_never_run_the_plain_version(solved, monkeypatch):
    """An eager solve on the card launches the kernel once per inner
    iteration with MS on and never calls the plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain linear rollout ran on the card")

    monkeypatch.setattr(lr, "linear_rollout_hkd_plain", refuse)
    prob, state, opt = _problem("trot_b1024")
    lr.LAUNCHES = 0
    res = ddp._solve_batch(prob, state, opt, kernel_jac=True)
    torch.cuda.synchronize()
    assert lr.LAUNCHES == 2 and not bool(res.solve_failed.any())


def _record(head):
    got = [st for st in graphs.stats() if st["label"].startswith(head)]
    assert len(got) == 1, [st["label"] for st in graphs.stats()]
    return got[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_program_launches_equal_inner_b_runs(cuda, dtype):
    """A solve program's replay launches the kernel once per run of its
    `inner_b` piece (2 on the trot: 2 AL x 1 DDP), counted on the device
    and folded in when read, in the dtype's counter; and the replay equals
    the eager body bit for bit."""
    prob, state, opt = _problem("trot_b1024")
    prob, state = _as(dtype, prob), _as(dtype, state)
    graphs.clear_graphs()
    ddp.solve_batch(prob, state, opt, kernel_jac=True)   # the capture
    torch.cuda.synchronize()
    lr.LAUNCHES = lr.LAUNCHES_F64 = 0
    got = ddp.solve_batch(prob, state, opt, kernel_jac=True)
    torch.cuda.synchronize()
    st = _record("solve_batch(B=1024,")
    inner_b = st["pieces"]["inner_b"]["runs"]
    assert inner_b == 2
    assert lr.LAUNCHES == inner_b
    assert lr.LAUNCHES_F64 == (inner_b if dtype == torch.float64 else 0)
    assert st["launches"]["linear_rollout_hkd.LAUNCHES"] == inner_b
    assert st["pieces"]["inner_b"]["launches"][
        "linear_rollout_hkd.LAUNCHES"] == 1
    want = ddp._solve_batch(prob, state, opt, kernel_jac=True)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        for x, y in zip(graphs.leaves(a), graphs.leaves(b)):
            assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)), f.name
    graphs.clear_graphs()


def test_fleet_step_launches_equal_inner_b_runs(cuda, tmp_path):
    """A fleet step replays one of two step programs (parallel or
    sequential rollout); once both are built, every step launches the
    kernel once per run of the replayed program's `inner_b`, 2 a step on
    the trot."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    graphs.clear_graphs()
    f = FleetMPC(gait_file("trot", str(tmp_path)), 16, config=FleetConfig(),
                 dtype=torch.float32, device="cuda")
    f.initialize()
    stream = meas_stream(16, 4)
    seen = set()
    for k in range(40):
        d = stream(k)
        held = {st["label"]: st["replays"] for st in graphs.stats()}
        before = lr.LAUNCHES
        f.step(d["rpy"], d["p"], d["v"], d["omega"], d["qJ"])
        launched = lr.LAUNCHES - before
        replayed = [st for st in graphs.stats()
                    if st["replays"] > held.get(st["label"], 0)]
        assert len(replayed) == 1, [st["label"] for st in replayed]
        st = replayed[0]
        if st["label"] in held:          # built at an earlier step
            assert launched == st["pieces"]["inner_b"]["runs"] == 2, k
            seen.add(st["label"])
    assert len(seen) == 2, seen
    graphs.clear_graphs()
