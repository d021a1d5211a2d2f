"""The float64 instantiations of the CUDA Riccati kernels (K1,
`csrc/riccati_hkd.cu`, and K2, `csrc/riccati_dense.cu`; each library holds
both instantiations) against their f64 plain versions, and the f64 entry points
that run them on the card (batched solves, their device programs, the fleet
and the single robot) against the same entry points in f64 on the CPU.
Skipped without a CUDA device: the kernels have no CPU mode. This file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_f64_gpu.py

Tolerances: a kernel's outputs within 1e-8 of its f64 plain version on the
same inputs, relative to the plain output's largest magnitude (the two
eliminate in different orders, and a sweep of 60 steps compounds the
rounding of double precision to about 1e-12 of a value; 1e-8 leaves room for
the conditioning of Quu), `ok` equal on every row. A solve, step or update
on the card against the CPU: final costs within 1e-7 relative (the
decisions of the line search are the same in f64; the sums are taken in
another order)."""
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import backward, ddp, lq, rollout as ro
from hkdmpc_tpu_torch.solver.structs import tree_map
from hkdmpc_tpu_torch.workload import trot_problem

pytestmark = pytest.mark.gpu

F64 = torch.float64
KERNEL_REL = 1e-8
SOLVE_REL = 1e-7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _trot(nb, device, plan=0.6, seed=9, spread=2.0):
    """nb perturbed trot scenarios in f64 with nonzero nominal controls."""
    _, prob, state, opt = trot_problem(plan, dtype=F64, device=device)
    prob, state = replicate_problem(prob, state, nb)
    rng = np.random.default_rng(seed)
    prob = perturb_scenarios(prob, noise=rng.standard_normal((nb, 24)))
    T = prob.T
    state.Ubar = prob.ur[:, :T] + torch.as_tensor(
        spread * rng.standard_normal((nb, T, 24)), device=device)
    return prob, state, opt


def _hkd_args(prob, state):
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    c = state.constr
    nb = prob.kind.shape[0]
    reg = ((torch.arange(nb, device=prob.kind.device) % 3) * 0.02).to(F64)
    return (prob.kind, r.X, r.U, prob.contact, prob.contact_next, prob.xr,
            prob.ur, prob.foot_r, c.reb_delta, c.reb_eps, prob.term_contact,
            prob.td_mask, c.al_sigma, c.al_lambda, prob.term_mask, r.defect,
            reg, ro.last_active_node(prob), prob.dt)


def _dense_args(prob, state):
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    l = lq.lq_approximation(prob, r.X, r.U, state.constr, True, True)
    nb = prob.kind.shape[0]
    reg = ((torch.arange(nb, device=prob.kind.device) % 3) * 0.02).to(F64)
    args = (prob.kind, l.A, l.B, l.lxx, l.luu, l.lx, l.lu, r.defect, l.phix,
            l.phixx, reg, ro.last_active_node(prob))
    return tuple(a.contiguous() for a in args)


KERNELS = {
    "K1": (riccati_hkd, riccati_hkd.backward_sweep_hkd,
           riccati_hkd.backward_sweep_hkd_plain, _hkd_args),
    "K2": (riccati_dense, riccati_dense.backward_sweep_dense,
           riccati_dense.backward_sweep_dense_plain, _dense_args),
}


def _assert_f64_close(got, plain):
    """Each output within KERNEL_REL of the plain one's largest magnitude;
    `ok` equal."""
    for name, g, p in zip(("dU", "K", "dv1", "dv2"), got, plain):
        assert g.dtype == F64 and bool(torch.isfinite(g).all()), name
        scale = max(float(p.abs().max()), 1e-300)
        err = float((g - p).abs().max())
        assert err <= KERNEL_REL * scale, (name, err, scale)
    assert torch.equal(got[4], plain[4])


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("nb,plan", [(37, 0.6), (5, 2.0)],
                         ids=["B37", "T250"])
def test_f64_kernel_matches_f64_plain(cuda, kernel, nb, plan):
    """The f64 kernel against its f64 plain version at B = 37 and at
    T = 250 (the ring wraps many times, 19 RESET items); PAD and RESET rows
    of K and dU are zeros; the f64 launch is counted."""
    module, fn, plain, args_of = KERNELS[kernel]
    prob, state, _ = _trot(nb, cuda, plan)
    assert prob.T == (250 if plan == 2.0 else 75)
    args = args_of(prob, state)
    before, before64 = module.LAUNCHES, module.LAUNCHES_F64
    got = fn(*args)
    torch.cuda.synchronize()
    assert module.LAUNCHES == before + 1
    assert module.LAUNCHES_F64 == before64 + 1
    _assert_f64_close(got, plain(*args))
    idle = args[0] != 1
    assert not bool(got[1][idle].any()) and not bool(got[0][idle].any())


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_f64_kernel_masks(cuda, kernel):
    """A retry launch in f64: with no scenario active nothing is written;
    with every other one active those rows get the full sweep's values bit
    for bit and the others are untouched; counted as f64 retries."""
    module, fn, _, args_of = KERNELS[kernel]
    prob, state, _ = _trot(12, cuda)
    args = args_of(prob, state)
    full = fn(*args)
    out = tuple(torch.full_like(f, float("nan")) if f.is_floating_point()
                else torch.zeros_like(f) for f in full)
    blank = tuple(o.clone() for o in out)
    before = module.RETRY_LAUNCHES_F64
    fn(*args, active=torch.zeros(12, dtype=torch.bool, device=cuda), out=out)
    torch.cuda.synchronize()
    for o, b in zip(out, blank):
        assert torch.equal(o.nan_to_num(7.0), b.nan_to_num(7.0))
    half = torch.arange(12, device=cuda) % 2 == 0
    fn(*args, active=half, out=out)
    torch.cuda.synchronize()
    assert module.RETRY_LAUNCHES_F64 == before + 2
    for o, f, b in zip(out, full, blank):
        assert torch.equal(o[half], f[half])
        assert torch.equal(o[~half].nan_to_num(7.0), b[~half].nan_to_num(7.0))


@pytest.mark.parametrize("spread", [0.0, 2.0], ids=["calm", "perturbed"])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_f64_forced_retries_match_cpu(cuda, kernel, spread):
    """The regularization retry loop on the f64 kernel against the same
    loop on the CPU's f64 plain version, on rows that need no retry, some
    and many (K1: the ReB weight scaled by (1, -1e-3, -0.1, -100)), and on
    K2 rows that fail past REG_MAX too (luu shifted by -(0, 1e-3, 1, 1000)
    I), at the nominal controls and at the file's perturbed ones: the same
    ok and failed rows, the same retries, reg and outputs close. Which rows
    fail is pinned at the nominal controls."""
    out, sweeps = {}, {}
    for dev in (cuda, torch.device("cpu")):
        prob, state, _ = _trot(8, dev, spread=spread)
        state = tree_map(lambda x: x.clone(), state)
        c = state.constr
        r = ro.hybrid_rollout_parallel(prob, state, 0.0)
        last = ro.last_active_node(prob)
        if kernel == "K1":
            scale = torch.tensor((1.0, -1e-3, -0.1, -100.0) * 2, dtype=F64,
                                 device=dev)
            route = dict(kernel_jac_XU=(
                r.X, r.U, c.reb_delta,
                (c.reb_eps * scale[:, None, None]).contiguous(), c.al_sigma,
                c.al_lambda))
        else:
            shift = torch.tensor((0.0, 1e-3, 1.0, 1000.0) * 2, dtype=F64,
                                 device=dev)
            l = lq.lq_approximation(prob, r.X, r.U, c, True, True)
            l = dataclasses.replace(l, luu=l.luu - shift[:, None, None, None]
                                    * torch.eye(24, dtype=F64, device=dev))
            route = dict(lq=dataclasses.replace(
                l, **{f: getattr(l, f).contiguous() for f in
                      ("A", "B", "lxx", "luu", "lx", "lu", "phix", "phixx")}))
        s0 = backward.RETRY_SWEEPS
        out[dev.type] = backward.backward_sweep_regularized(
            prob, r.defect, 0.0, 2.0, last, **route)
        sweeps[dev.type] = backward.RETRY_SWEEPS - s0
    g, w = out["cuda"], out["cpu"]
    assert sweeps["cuda"] == sweeps["cpu"] >= 1
    assert torch.equal(g[5].cpu(), w[5]) and torch.equal(g[6].cpu(), w[6])
    assert bool(w[5].any())
    if spread == 0.0:
        assert bool(w[6].any()) == (kernel == "K2") and not bool(w[6].all())
    np.testing.assert_allclose(g[4].cpu().numpy(), w[4].numpy(), rtol=1e-12)
    ok = w[5]
    for a, b in zip(g[:4], w[:4]):
        a = a.cpu()[ok]
        b = b[ok]
        assert float((a - b).abs().max()) <= KERNEL_REL * max(
            float(b.abs().max()), 1e-300)


# the solve's inputs: the trot at the nominal controls, the file's
# perturbed controls, and the nominal one with the ReB weight scaled per
# row by (1, -1e-3, -0.1, -100) (no retry, retries, a failure past REG_MAX)
PROGRAM_INPUTS = {"calm": dict(seed=6, spread=0.0), "perturbed": {},
                  "forced": dict(seed=6, spread=0.0)}
REB_SCALE = (1.0, -1e-3, -0.1, -100.0)


def _program_batch(device, inputs):
    prob, state, opt = _trot(8, device, **PROGRAM_INPUTS[inputs])
    if inputs == "forced":
        scale = torch.tensor(REB_SCALE * 2, dtype=F64, device=device)
        state = dataclasses.replace(state, constr=dataclasses.replace(
            state.constr, reb_eps=state.constr.reb_eps
            * scale[:, None, None]))
    return prob, state, opt


@pytest.mark.parametrize("inputs", list(PROGRAM_INPUTS))
@pytest.mark.parametrize("kernel_jac", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("unroll_caps", [True, False],
                         ids=["unrolled", "while"])
def test_f64_program_equals_eager_body(cuda, kernel_jac, unroll_caps,
                                       inputs):
    """solve_batch in f64 replays its device program: after the build (a
    call of its own: the build runs every piece once, the retry piece
    too), each of two replays equals the eager body's result bit for bit,
    with the same retries (some, and failed rows, on the forced inputs);
    its f64 kernel is launched; the final costs and failed rows are the
    f64 CPU solve's."""
    from hkdmpc_tpu_torch.config import HSDDPOption
    from hkdmpc_tpu_torch.solver import graphs
    prob, state, opt = _program_batch(cuda, inputs)
    opt = opt.runtime() if unroll_caps else HSDDPOption()
    module = riccati_hkd if kernel_jac else riccati_dense
    flags = dict(kernel_jac=kernel_jac, unroll_caps=unroll_caps)
    r0 = backward.RETRY_SWEEPS
    eager = ddp._solve_batch(prob, state, opt, **flags)
    eager_retries = backward.RETRY_SWEEPS - r0
    ddp.solve_batch(prob, state, opt, **flags)      # builds the program
    for _ in range(2):
        l0, r0 = module.LAUNCHES_F64, backward.RETRY_SWEEPS
        got = ddp.solve_batch(prob, state, opt, **flags)
        torch.cuda.synchronize()
        assert module.LAUNCHES_F64 > l0
        assert backward.RETRY_SWEEPS - r0 == eager_retries
        for x, y in zip(graphs.leaves(got), graphs.leaves(eager)):
            assert torch.equal(x.nan_to_num(), y.nan_to_num())
    failed = got.solve_failed.cpu()
    if inputs == "forced":
        assert eager_retries > 0
        assert bool(failed[3]) and not bool(failed[0])
    else:
        assert not bool(failed.any())
    cpu = ddp.solve_batch(*_program_batch(torch.device("cpu"), inputs)[:2],
                          opt, **flags)
    assert torch.equal(failed, cpu.solve_failed)
    rel = ((got.cost.cpu() - cpu.cost).abs() / cpu.cost.abs())[~failed]
    assert float(rel.max()) <= SOLVE_REL, rel


def test_f64_fleet_on_card_matches_cpu(cuda, tmp_path):
    """FleetMPC in f64 with the default config takes K1 on the card (its
    f64 instantiation): cold solve and 3 steps against the f64 fleet on the
    CPU with the same measurements, final costs within 1e-7 relative."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    nb = 8
    ref = gait_file("trot", str(tmp_path))
    stream = meas_stream(nb, 0)
    meas = [stream(k) for k in range(3)]
    costs = {}
    for dev in ("cuda", "cpu"):
        f = FleetMPC(ref, nb, config=FleetConfig(), dtype=F64, device=dev)
        assert f._kernel_jac == (dev == "cuda")
        assert f.initialize()["n_failed"] == 0
        before = riccati_hkd.LAUNCHES_F64
        costs[dev] = []
        for k, m in enumerate(meas):
            out = f.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time=0.01 * k)
            assert not np.any(out["scalars"][:, 5])
            costs[dev].append(np.asarray(out["scalars"][:, 0], np.float64))
        if dev == "cuda":
            assert riccati_hkd.LAUNCHES_F64 >= before + 2 * len(meas)
    for k, (g, w) in enumerate(zip(costs["cuda"], costs["cpu"])):
        rel = np.abs(g - w) / np.abs(w)
        assert float(rel.max()) <= SOLVE_REL, (k, rel)


def test_f64_robot_on_card_matches_cpu(cuda, tmp_path):
    """HKDMPCSolver in f64 with assoc off (K2 at B = 1 on the card, its f64
    instantiation), fused step: cold solve and 4 updates (one on the
    sequential rollout) against the f64 solver on the CPU: costs within 1e-6
    relative and controls within 1e-6 of their magnitude, no failure."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    ref = gait_file("trot", str(tmp_path))
    stream = meas_stream(1, 0)
    meas = [{k: v[0] for k, v in stream(k).items()} for k in range(4)]
    cfg = MPCConfig(fused_step=True, assoc_linear=False, assoc_backward=False)
    res = {}
    for dev in ("cuda", "cpu"):
        s = HKDMPCSolver(ref, config=cfg, dtype=F64, device=dev)
        s.initialize()
        before = riccati_dense.LAUNCHES_F64
        res[dev] = []
        for k, m in enumerate(meas):
            cmd = s.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                           mpc_time=0.01 * k)
            assert not bool(s.last_result.solve_failed)
            res[dev].append((float(s.last_result.cost),
                             np.asarray(cmd.hkd_controls, np.float64)))
        if dev == "cuda":
            assert riccati_dense.LAUNCHES_F64 >= before + 2 * len(meas)
        s.close()
    for (cg, ug), (cw, uw) in zip(res["cuda"], res["cpu"]):
        assert abs(cg - cw) <= 1e-6 * abs(cw)
        assert np.max(np.abs(ug - uw)) <= 1e-6 * max(1.0, np.max(np.abs(uw)))


def test_half_precision_still_refused_on_card(cuda):
    """float16 and bfloat16 have no kernel: both wrappers raise TypeError,
    the dense dispatch and route NotImplementedError naming the scan
    sweep."""
    prob, state, _ = _trot(4, cuda)
    for half in (torch.float16, torch.bfloat16):
        cast = lambda args: tuple(a.to(half) if a.is_floating_point() else a
                                  for a in args)
        with pytest.raises(TypeError, match="float32 or float64"):
            riccati_hkd.backward_sweep_hkd_cuda(*cast(_hkd_args(prob, state)))
        dense = cast(_dense_args(prob, state))
        with pytest.raises(TypeError, match="float32 or float64"):
            riccati_dense.backward_sweep_dense_cuda(*dense)
        with pytest.raises(NotImplementedError, match="scan_backward=True"):
            riccati_dense.backward_sweep_dense(*dense)
