"""The CUDA Riccati kernels (`hkdmpc_tpu_torch/csrc/riccati_hkd.cu`, K1, and
`csrc/riccati_dense.cu`, K2) against their plain PyTorch versions, and both
solve paths against the CPU, on a CUDA device. Skipped without one: the
kernels have no CPU mode. This file imports no JAX, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_gpu.py

Inputs: a batch that interleaves trot and hop scenarios (T = 75 both, so
neighbouring blocks take different branches at the same step), per-scenario
regularization, and rolled-out nominal trajectories with nonzero GRFs. A
kernel's error against the plain version in f64 must stay within
max(10 x the plain-f32 error, 1e-5) per output, and `ok` agree on at least
99.9% of scenarios, as in chip_smoke.py. The f32 solves on the card are held
to the f64 solves on the CPU (the analog of
test_fast_paths.py::test_f32_batch_final_cost_matches_f64_oracle), and so
are the fleet, the single-robot solver and the MPC service; a model that is
not 24 wide solves on the card through the scan sweep."""
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch.solver import backward, ddp, lq, rollout as ro
from hkdmpc_tpu_torch.solver.problem import HKDProblem
from hkdmpc_tpu_torch.solver.structs import tree_map
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.workload import trot_problem

pytestmark = pytest.mark.gpu

GAITS = {"trot": (("trot", 2.0, 0.5),), "hop": (("hop", 1.0, 0.2),)}
PER_GAIT = 8


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _gait_batch(tmp_path, gait, dtype, device):
    path = GaitSynthesizer().write(str(tmp_path / f"{gait}.csv"), GAITS[gait])
    pb = HKDProblem(QuadReference.from_file(path), dtype=dtype, device=device)
    pb.initialization()
    prob, state = pb.build(default_stand_state(pb.phases[0].contact))
    return replicate_problem(prob, state, PER_GAIT)


@pytest.fixture(scope="module")
def mixed(cuda, tmp_path_factory):
    """Interleaved trot/hop scenarios (f64 on the card), perturbed x0,
    nonzero nominal controls."""
    tmp = tmp_path_factory.mktemp("gaits")
    (pa, sa), (pb, sb) = (_gait_batch(tmp, g, torch.float64, cuda)
                          for g in ("trot", "hop"))
    prob, state = _interleave(pa, pb), _interleave(sa, sb)
    nb = prob.kind.shape[0]
    rng = np.random.default_rng(4)
    prob = perturb_scenarios(prob, noise=rng.standard_normal((nb, 24)))
    T = prob.T
    noise = torch.as_tensor(rng.standard_normal((nb, T, 24)), device=cuda)
    state.Ubar = prob.ur[:, :T] + 3.0 * noise
    return prob, state


def _interleave(a, b):
    """Scenario-interleave two batched structs: a0, b0, a1, b1, ..."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: _interleave(getattr(a, f.name),
                                              getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    if not isinstance(a, torch.Tensor):
        assert a == b       # a host-side note, the same on both
        return a
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def _args(prob, state, dtype):
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    c = state.constr
    nb = prob.kind.shape[0]
    reg = (torch.arange(nb, device=prob.kind.device) % 3) * 0.02
    args = (prob.kind, r.X, r.U, prob.contact, prob.contact_next, prob.xr,
            prob.ur, prob.foot_r, c.reb_delta, c.reb_eps, prob.term_contact,
            prob.td_mask, c.al_sigma, c.al_lambda, prob.term_mask, r.defect,
            reg, ro.last_active_node(prob), prob.dt)
    return tuple(a.to(dtype).contiguous() if a.is_floating_point() else a
                 for a in args)


def test_kernel_matches_plain_on_mixed_batch(mixed):
    prob, state = mixed
    args32 = _args(prob, state, torch.float32)
    args64 = _args(prob, state, torch.float64)
    before = riccati_hkd.LAUNCHES
    got = riccati_hkd.backward_sweep_hkd(*args32)
    assert riccati_hkd.LAUNCHES == before + 1
    plain = riccati_hkd.backward_sweep_hkd_plain(*args32)
    oracle = riccati_hkd.backward_sweep_hkd_plain(*args64)
    torch.cuda.synchronize()
    _assert_sweep_close(got, plain, oracle)
    # trot and hop lanes really differ
    assert not torch.equal(prob.kind[0], prob.kind[1])


def test_kernel_accepts_controls_with_t_plus_1_rows(mixed):
    prob, state = mixed
    args = list(_args(prob, state, torch.float32))
    a = riccati_hkd.backward_sweep_hkd(*args)
    args[2] = torch.cat([args[2], args[2][:, -1:]], dim=1).contiguous()
    b = riccati_hkd.backward_sweep_hkd(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_regularization_retry_on_card_matches_cpu(mixed):
    """One scenario with an indefinite Quu (negative ReB weight) retries
    with growing reg; the retry decisions match the CPU f64 run."""
    prob, state = mixed
    state = tree_map(lambda x: x.clone(), state)
    state.constr.reb_eps[1] = -30.0
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        p = tree_map(lambda x: (x.to(dtype) if x.is_floating_point() else x)
                     .to(dev).contiguous(), prob)
        s = tree_map(lambda x: x.to(dtype).to(dev).contiguous(), state)
        r = ro.hybrid_rollout_parallel(p, s, 0.0)
        c = s.constr
        out[dev] = backward.backward_sweep_regularized(
            p, r.defect, 0.0, 2.0, ro.last_active_node(p),
            kernel_jac_XU=(r.X, r.U, c.reb_delta, c.reb_eps, c.al_sigma,
                           c.al_lambda))
    g, w = out["cuda"], out["cpu"]
    assert torch.equal(g[5].cpu(), w[5]) and torch.equal(g[6].cpu(), w[6])
    np.testing.assert_allclose(g[4].cpu().double().numpy(), w[4].numpy(),
                               rtol=1e-6)
    assert float(w[4][1]) > float(w[4][0])


def _on(x, dev, dtype):
    return (x.to(dtype) if x.is_floating_point() else x).to(dev).contiguous()


@pytest.mark.parametrize("kernel_jac", [True, False], ids=["K1", "K2"])
def test_solve_on_card_matches_cpu(mixed, kernel_jac):
    """Each solve path on the mixed batch: CUDA f32 (kernel) against CPU
    f64 (plain version): same decisions, final costs within 1e-3
    relative."""
    prob, state = mixed
    optr = HSDDPOption().runtime()
    g = ddp.solve_batch(tree_map(lambda x: _on(x, "cuda", torch.float32), prob),
                        tree_map(lambda x: _on(x, "cuda", torch.float32),
                                 state), optr, kernel_jac=kernel_jac)
    w = ddp.solve_batch(tree_map(lambda x: _on(x, "cpu", torch.float64), prob),
                        tree_map(lambda x: _on(x, "cpu", torch.float64),
                                 state), optr, kernel_jac=kernel_jac)
    assert torch.equal(g.solve_failed.cpu(), w.solve_failed)
    rel = ((g.cost.cpu().double() - w.cost).abs() / w.cost.abs()).max()
    assert float(rel) <= 1e-3


@pytest.mark.parametrize("kernel_jac", [True, False], ids=["K1", "K2"])
def test_f32_batch_final_cost_matches_f64_oracle(cuda, kernel_jac):
    """16 perturbed trot scenarios: the f32 solve on the card reproduces the
    f64 solve on the CPU to 1e-4 relative in every final cost."""
    nb = 16
    noise = np.random.default_rng(0).standard_normal((nb, 24))
    costs = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        _, prob, state, opt = trot_problem(dtype=dtype, device=dev)
        prob_b, state_b = replicate_problem(prob, state, nb)
        prob_b = perturb_scenarios(prob_b, noise=noise)
        r = ddp.solve_batch(prob_b, state_b, opt.runtime(),
                            kernel_jac=kernel_jac)
        assert not bool(r.solve_failed.any())
        costs[dev] = r.cost.cpu().double()
    rel = (costs["cuda"] - costs["cpu"]).abs() / costs["cpu"].abs()
    assert float(rel.max()) < 1e-4, rel


def _dense_args(prob, state, dtype):
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    l = lq.lq_approximation(prob, r.X, r.U, state.constr, True, True)
    nb = prob.kind.shape[0]
    reg = (torch.arange(nb, device=prob.kind.device) % 3) * 0.02
    args = (prob.kind, l.A, l.B, l.lxx, l.luu, l.lx, l.lu, r.defect, l.phix,
            l.phixx, reg, ro.last_active_node(prob))
    return tuple(a.to(dtype).contiguous() if a.is_floating_point() else a
                 for a in args)


def test_dense_kernel_matches_plain_on_mixed_batch(mixed):
    prob, state = mixed
    args32 = _dense_args(prob, state, torch.float32)
    args64 = _dense_args(prob, state, torch.float64)
    before = riccati_dense.LAUNCHES
    got = backward.riccati_backward(*args32)
    assert riccati_dense.LAUNCHES == before + 1
    plain = riccati_dense.backward_sweep_dense_plain(*args32)
    oracle = riccati_dense.backward_sweep_dense_plain(*args64)
    torch.cuda.synchronize()
    _assert_sweep_close(got, plain, oracle)
    assert not torch.equal(prob.kind[0], prob.kind[1])


def _assert_sweep_close(got, plain, oracle):
    """A kernel's outputs against the f64 oracle within max(10 x the plain
    f32 version's error, 1e-5); the PSD gate can flip at the ulp level
    between elimination orders, so `ok` on 99.9%."""
    for name, g, p, o in zip(("dU", "K", "dv1", "dv2"), got, plain, oracle):
        assert bool(torch.isfinite(g).all()), name
        err = float((g.double() - o).abs().max())
        roundoff = float((p.double() - o).abs().max())
        assert err <= max(10.0 * roundoff, 1e-5), (name, err, roundoff)
    assert float((got[4] == oracle[4]).double().mean()) >= 0.999


@pytest.mark.parametrize("nb,plan", [(37, 0.6), (5, 2.0)],
                         ids=["B37", "T250"])
def test_kernels_on_odd_batch_and_long_horizon(cuda, nb, plan):
    """Both kernels against their plain versions at a batch that is a
    multiple of nothing convenient (B = 37, more blocks than fit a wave of
    a few SMs, fewer than the card holds) and at T = 250 (the 2.0 s plan:
    the ring wraps 40 times and more, with 19 RESET items between the DYN
    ones). The same gates as on the mixed batch."""
    _, prob, state, _ = trot_problem(plan, dtype=torch.float64, device=cuda)
    prob, state = replicate_problem(prob, state, nb)
    rng = np.random.default_rng(9)
    prob = perturb_scenarios(prob, noise=rng.standard_normal((nb, 24)))
    T = prob.T
    assert T == (250 if plan == 2.0 else 75)
    state.Ubar = prob.ur[:, :T] + torch.as_tensor(
        2.0 * rng.standard_normal((nb, T, 24)), device=cuda)
    for args_of, kernel, plain in (
            (_args, riccati_hkd.backward_sweep_hkd,
             riccati_hkd.backward_sweep_hkd_plain),
            (_dense_args, riccati_dense.backward_sweep_dense,
             riccati_dense.backward_sweep_dense_plain)):
        args32 = args_of(prob, state, torch.float32)
        got = kernel(*args32)
        torch.cuda.synchronize()
        assert got[1].shape == (nb, T, 24, 24)
        _assert_sweep_close(got, plain(*args32),
                            plain(*args_of(prob, state, torch.float64)))
        # PAD and RESET rows of K and dU are written as zeros
        idle = args32[0] != 1
        assert not bool(got[1][idle].any()) and not bool(got[0][idle].any())


def test_dense_wrapper_rejects_misaligned_input(mixed):
    """The bulk copies take 16-byte aligned sources: a contiguous view that
    starts 4 bytes into an allocation is refused, not copied."""
    prob, state = mixed
    args = list(_dense_args(prob, state, torch.float32))
    flat = torch.empty(args[5].numel() + 1, dtype=torch.float32,
                       device=args[5].device)
    shifted = flat[1:].view(args[5].shape)
    shifted.copy_(args[5])
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    args[5] = shifted
    with pytest.raises(ValueError, match="aligned"):
        riccati_dense.backward_sweep_dense_cuda(*args)


def test_dense_wrapper_rejects_bad_inputs(mixed):
    """Wrong dtype, width, shape or device: the dense dispatch raises on
    CUDA tensors instead of falling back."""
    prob, state = mixed
    args = list(_dense_args(prob, state, torch.float32))
    with pytest.raises(NotImplementedError):        # f64 on the card
        riccati_dense.backward_sweep_dense(*_dense_args(prob, state,
                                                        torch.float64))
    narrow = list(args)
    for i in (1, 2, 3, 4):
        narrow[i] = args[i][..., :2, :2].contiguous()
    with pytest.raises(NotImplementedError):        # not 24 wide
        riccati_dense.backward_sweep_dense(*narrow)
    bad_kind = list(args)
    bad_kind[0] = args[0].long()
    with pytest.raises(TypeError):
        riccati_dense.backward_sweep_dense_cuda(*bad_kind)
    short = list(args)
    short[7] = args[7][:, :-1].contiguous()
    with pytest.raises(ValueError, match="defect"):
        riccati_dense.backward_sweep_dense_cuda(*short)
    strided = list(args)
    strided[3] = args[3].transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        riccati_dense.backward_sweep_dense_cuda(*strided)
    split = list(args)
    split[10] = args[10].cpu()
    with pytest.raises(ValueError, match="reg"):
        riccati_dense.backward_sweep_dense_cuda(*split)


def test_kernel_wrapper_rejects_bad_inputs(mixed):
    prob, state = mixed
    args = list(_args(prob, state, torch.float32))
    bad_dtype = list(args)
    bad_dtype[1] = args[1].double()
    with pytest.raises(TypeError):
        riccati_hkd.backward_sweep_hkd_cuda(*bad_dtype)
    strided = list(args)
    strided[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        riccati_hkd.backward_sweep_hkd_cuda(*strided)
    short = list(args)
    short[15] = args[15][:, :-1].contiguous()
    with pytest.raises(ValueError, match="defect"):
        riccati_hkd.backward_sweep_hkd_cuda(*short)


@pytest.mark.parametrize("kernel_jac", [True, False], ids=["K1", "K2"])
def test_f32_fleet_on_card_matches_f64_cpu_fleet(cuda, kernel_jac, tmp_path):
    """A7's rule applied to the fleet: 16 robots on the trot (plan 0.6 s),
    cold solve and 3 warm-started receding-horizon steps, f32 on the card
    against f64 on the CPU with the same measurements; every step's final
    costs within 1e-4 relative, no failed robot."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    nb = 16
    ref = gait_file("trot", str(tmp_path))
    stream = meas_stream(nb, 0)
    meas = [stream(k) for k in range(3)]
    module = riccati_hkd if kernel_jac else riccati_dense
    costs = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        f = FleetMPC(ref, nb, config=FleetConfig(kernel_jac=kernel_jac),
                     dtype=dtype, device=dev)
        assert f.initialize()["n_failed"] == 0
        before = module.LAUNCHES
        costs[dev] = []
        for k, m in enumerate(meas):
            out = f.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time=0.01 * k)
            assert not np.any(out["scalars"][:, 5])
            costs[dev].append(out["scalars"][:, 0].astype(np.float64))
        if dev == "cuda":
            assert module.LAUNCHES >= before + 2 * len(meas)
    for k, (g, w) in enumerate(zip(costs["cuda"], costs["cpu"])):
        rel = np.abs(g - w) / np.abs(w)
        assert float(rel.max()) < 1e-4, (k, rel)


def test_dense_kernel_at_batch_one_matches_plain(cuda):
    """K2 at B = 1, the single-robot solver's batch: one block on the card
    against the plain version, on the trot's LQ data along a perturbed
    rollout."""
    _, prob, state, _ = trot_problem(dtype=torch.float64, device=cuda)
    prob, state = replicate_problem(prob, state, 1)
    rng = np.random.default_rng(11)
    prob = perturb_scenarios(prob, noise=rng.standard_normal((1, 24)))
    T = prob.T
    state.Ubar = prob.ur[:, :T] + torch.as_tensor(
        2.0 * rng.standard_normal((1, T, 24)), device=cuda)
    args32 = _dense_args(prob, state, torch.float32)
    before = riccati_dense.LAUNCHES
    got = riccati_dense.backward_sweep_dense(*args32)
    torch.cuda.synchronize()
    assert riccati_dense.LAUNCHES == before + 1
    assert got[1].shape == (1, T, 24, 24) and got[4].shape == (1,)
    _assert_sweep_close(got, riccati_dense.backward_sweep_dense_plain(*args32),
                        riccati_dense.backward_sweep_dense_plain(
                            *_dense_args(prob, state, torch.float64)))


@pytest.mark.parametrize("assoc", [True, False], ids=["assoc", "K2"])
def test_f32_single_robot_on_card_matches_f64_cpu(cuda, assoc, tmp_path):
    """The single-robot solver, cold solve and 4 updates (one of them on
    the sequential rollout), f32 on the card against f64 on the CPU with the
    same measurements and flags: every final cost within 1e-4 relative, no
    failed solve. assoc: the parallel-in-time recursions, the card's
    defaults; K2: both off, the CUDA kernel of the dense sweep at B = 1,
    launched at least twice an update."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    ref = gait_file("trot", str(tmp_path))
    stream = meas_stream(1, 0)
    meas = [{k: v[0] for k, v in stream(k).items()} for k in range(4)]
    cfg = MPCConfig(fused_step=True, assoc_linear=assoc,
                    assoc_backward=assoc)
    costs = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        s = HKDMPCSolver(ref, config=cfg, dtype=dtype, device=dev)
        s.initialize()
        assert not bool(s.last_result.solve_failed)
        costs[dev] = [float(s.last_result.cost)]
        before = riccati_dense.LAUNCHES
        shooting = []
        for k, m in enumerate(meas):
            s.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                     mpc_time=0.01 * k)
            assert not s.last_result.solve_failed
            costs[dev].append(float(s.last_result.cost))
            shooting.append(s.problem.all_shooting())
        assert not all(shooting)
        if dev == "cuda":
            launched = riccati_dense.LAUNCHES - before
            assert launched == 0 if assoc else launched >= 2 * len(meas)
    rel = np.abs(np.array(costs["cuda"]) - costs["cpu"]) / np.abs(
        costs["cpu"])
    assert float(rel.max()) < 1e-4, rel


class _ScriptedTransport:
    """An in-memory transport for the service: hands out its requests in
    order, records what is published."""

    def __init__(self, messages):
        self.todo, self.published = list(messages), []

    def subscribe(self, channel):
        pass

    def publish(self, channel, data):
        self.published.append((channel, bytes(data)))

    def receive(self, timeout_ms=100):
        return ("mpc_data", self.todo.pop(0)) if self.todo else None


def test_f32_service_on_card_matches_f64_cpu_service(cuda, tmp_path):
    """The MPC service on the card (f32, the fused step on K2 at B = 1)
    against the service on the CPU in f64, same requests: two updates, a
    single-shooting reset, an update. Every solver_info's final cost within
    5e-3 relative and every command's controls and body states within 1e-1
    of their magnitude (the worst-case limits chip_smoke.py holds f32
    single-robot runs to), K2 launched at least twice per update."""
    from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
    from hkdmpc_tpu_torch.mpc.runtime import MPCService
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.workload import (gait_file, lcmtypes_dir,
                                           meas_stream, mpc_data_message)

    ref = gait_file("trot", str(tmp_path))
    lcm_dir = lcmtypes_dir(str(tmp_path / "lcmtypes"))
    types = load_reference_types(lcm_dir)
    stream = meas_stream(1, 0)
    script = ((False, True), (False, True), (True, False), (False, False))
    requests = [types["hkd_data_lcmt"].encode(mpc_data_message(
        {k: v[0] for k, v in stream(i).items()}, 0.01 * i, reset_mpc=r,
        MS=ms)) for i, (r, ms) in enumerate(script)]
    cfg = MPCConfig(fused_step=True, assoc_linear=False, assoc_backward=False)
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        s = HKDMPCSolver(ref, config=cfg, dtype=dtype, device=dev)
        s.initialize()
        tx = _ScriptedTransport(requests)
        before = riccati_dense.LAUNCHES
        MPCService(s, tx, lcm_dir).run(max_messages=len(requests))
        if dev == "cuda":
            assert riccati_dense.LAUNCHES - before >= 2 * len(requests)
        assert not s.opt.MS
        out[dev] = (
            [types["hkd_command_lcmt"].decode(b) for c, b in tx.published
             if c == "mpc_command"],
            [types["solver_info_lcmt"].decode(b) for c, b in tx.published
             if c == "solver_info"])
    (cmds, infos), (cmds64, infos64) = out["cuda"], out["cpu"]
    assert len(cmds) == len(infos) == len(requests)
    for k in range(len(requests)):
        assert infos[k]["n_iter"] == infos64[k]["n_iter"] >= 1
        cost, cost64 = infos[k]["cost"][-1], infos64[k]["cost"][-1]
        assert abs(cost - cost64) <= 5e-3 * abs(cost64), (k, cost, cost64)
        for name in ("hkd_controls", "des_body_state"):
            a, b = cmds[k][name], cmds64[k][name]
            assert np.isfinite(a).all()
            assert np.max(np.abs(a - b)) <= 1e-1 * max(1.0, np.max(np.abs(b)))
        np.testing.assert_array_equal(cmds[k]["contacts"],
                                      cmds64[k]["contacts"])


def _falling_mass(device, dtype, heights):
    """A point mass (x = height, velocity; u = thrust), 12 Euler steps, a
    quadratic cost toward 1 m: the smallest ModelSpec problem, xs = 2,
    us = 1. Returns (spec, prob, state)."""
    from hkdmpc_tpu_torch.solver import model_api
    from hkdmpc_tpu_torch.solver import structs as S
    T, nb = 12, len(heights)

    def dyn(x, u, contact, dt):
        return torch.stack([x[..., 0] + dt * x[..., 1],
                            x[..., 1] + dt * (u[..., 0] - 9.81)], -1)

    def dyn_jac(x, u, contact, dt):
        A = torch.eye(2, dtype=x.dtype, device=x.device).expand(
            x.shape[:-1] + (2, 2)).clone()
        A[..., 0, 1] = dt
        B = x.new_zeros(x.shape[:-1] + (2, 1))
        B[..., 1, 0] = dt
        return A, B

    def e0(x, v):
        out = torch.zeros_like(x)
        out[..., 0] = v
        return out

    class Height(model_api.CostTerm):
        def running(self, x, u, ctx):
            d = x[..., 0] - 1.0
            return ctx["dt"] * (0.5 * d * d + 0.5e-3 * u[..., 0] ** 2)

        def running_partials(self, x, u, ctx):
            dt = ctx["dt"]
            lxx = x.new_zeros(x.shape + (2,))
            lxx[..., 0, 0] = dt
            return (e0(x, dt * (x[..., 0] - 1.0)), dt[..., None] * 1e-3 * u,
                    lxx, (dt * 1e-3)[..., None, None].expand(
                        u.shape + (1,)).clone(), None)

        def terminal(self, x, ctx):
            return 5.0 * (x[..., 0] - 1.0) ** 2

        def terminal_partials(self, x, ctx):
            phixx = x.new_zeros(x.shape + (2,))
            phixx[..., 0, 0] = 10.0
            return e0(x, 10.0 * (x[..., 0] - 1.0)), phixx

    spec = model_api.ModelSpec(
        dynamics=dyn, dynamics_jacobians=dyn_jac,
        reset_map=lambda x, c, cn: x,
        reset_map_jacobian=lambda x, c, cn: torch.eye(
            2, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (2, 2)),
        cost_terms=[Height()], xs=2, us=1)
    z = lambda *s: np.zeros((nb,) + s)
    term_mask, start_mask = z(T + 1), z(T + 1)
    term_mask[:, T] = start_mask[:, 0] = 1.0
    x0 = z(2)
    x0[:, 0] = heights
    prob = S.from_numpy(dict(
        kind=np.full((nb, T), S.DYN, np.int32), contact=z(T, 4),
        contact_next=z(T, 4), dt=np.full(nb, 0.02), xr=z(T + 1, 2),
        ur=z(T + 1, 1), foot_r=z(T + 1, 12), term_mask=term_mask,
        term_contact=z(T + 1, 4), td_mask=z(T + 1, 4),
        ss_mask=np.ones((nb, T + 1)), start_mask=start_mask, x0=x0),
        device, dtype)
    empty = lambda n: torch.zeros((nb, n, 0), dtype=dtype, device=device)
    state = S.SolverState.init(prob, S.ConstraintState(
        reb_delta=empty(T), reb_delta_min=empty(T), reb_eps=empty(T),
        al_lambda=empty(T + 1), al_sigma=empty(T + 1),
        al_sigma_max=empty(T + 1)))
    return spec, prob, state


def test_narrow_model_takes_the_scan_route_on_card(cuda):
    """A model that is not 24 wide solves on the card where the caller asks
    for the scan sweep (`scan_backward=True`, plain tensor code): K2 is not
    launched. Without it the dense route refuses, naming that way out: it
    never gives way to the scan sweep by itself on the card. f32 on the card
    against f64 on the CPU: final costs within 1e-4 relative."""
    opt = HSDDPOption(max_DDP_iter=8, max_AL_iter=1, AL_active=False,
                      ReB_active=False)
    res = {}
    before = riccati_dense.LAUNCHES
    spec, prob, state = _falling_mass(cuda, torch.float32, [2.0, 1.5, 0.7])
    with pytest.raises(NotImplementedError, match="scan_backward=True"):
        ddp.solve_batch(prob, state, opt, kernel_jac=False, model=spec)
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        spec, prob, state = _falling_mass(dev, dtype, [2.0, 1.5, 0.7])
        res[dtype] = ddp.solve_batch(prob, state, opt, kernel_jac=False,
                                     model=spec, scan_backward=True)
    assert riccati_dense.LAUNCHES == before
    got, want = res[torch.float32], res[torch.float64]
    assert got.cost.device.type == "cuda"
    assert not bool(got.solve_failed.any()) and int(want.n_iters.min()) >= 1
    rel = (got.cost.cpu().double() - want.cost).abs() / want.cost.abs()
    assert float(rel.max()) < 1e-4, rel


def test_nccl_solve_sharded_at_world_one_equals_solve_batch(cuda):
    """An NCCL group of one process on the card (TCP store on 127.0.0.1,
    bound to cuda:0): `solve_sharded` on 32 perturbed trot scenarios equals
    `solve_batch` on them (the same kernels on the same rows), launches K1,
    and its aggregates are the host reductions of the result. The group is
    destroyed at the end."""
    import socket

    import torch.distributed as dist

    from hkdmpc_tpu_torch.parallel import batch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = batch.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda:0")
    try:
        assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
        nb = 32
        _, prob, state, opt = trot_problem(dtype=torch.float32, device="cuda")
        prob_b, state_b = replicate_problem(prob, state, nb)
        prob_b = perturb_scenarios(prob_b, noise=np.random.default_rng(
            1).standard_normal((nb, 24)))
        before = riccati_hkd.LAUNCHES
        res, agg = batch.solve_sharded(prob_b, state_b, opt.runtime(), mesh,
                                       kernel_jac=True)
        assert riccati_hkd.LAUNCHES - before >= 2
        ref = ddp.solve_batch(prob_b, state_b, opt.runtime(), kernel_jac=True)
        torch.testing.assert_close(res.cost, ref.cost, rtol=1e-6, atol=0)
        assert abs(agg["mean_cost"] - float(res.cost.double().mean())) <= (
            1e-9 * abs(agg["mean_cost"]))
        assert agg["max_feas"] == float(res.dyn_feas.max())
        assert agg["max_tconstr"] == float(res.max_tconstr.max())
        assert agg["n_failed"] == int(res.solve_failed.sum()) == 0
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_profile_solve_on_card_matches_cpu(cuda):
    """`utils.timing.profile_solve` (runtime caps, 2 iterations) on 16
    perturbed trot scenarios: f32 on the card, whose backward stage is K2,
    against f64 on the CPU: final Ubar within 1e-3 of its magnitude and
    finite; K2 launched in each backward stage; every stage bucket
    filled."""
    from hkdmpc_tpu_torch.utils.timing import StageTimer, profile_solve

    nb = 16
    noise = np.random.default_rng(2).standard_normal((nb, 24))
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        _, prob, state, opt = trot_problem(dtype=dtype, device=dev)
        prob_b, state_b = replicate_problem(prob, state, nb)
        prob_b = perturb_scenarios(prob_b, noise=noise)
        timer = StageTimer()
        before = riccati_dense.LAUNCHES
        st = profile_solve(prob_b, state_b, opt.runtime(), timer)
        if dev == "cuda":
            assert timer.device.type == "cuda"
            assert riccati_dense.LAUNCHES - before >= 2
            assert all(v > 0 for k, v in timer.summary().items()
                       if k.endswith("_ms"))
        out[dev] = st.Ubar.cpu().double()
    assert bool(torch.isfinite(out["cuda"]).all())
    scale = max(1.0, float(out["cpu"].abs().max()))
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-3 * scale


# ---------------------------------------------------------------------------
# CUDA graphs (solver/graphs.py): the compiled entry points
# ---------------------------------------------------------------------------

def _trot_batch(nb, dtype, device, model=None, seed=6):
    _, prob, state, opt = trot_problem(dtype=dtype, device=device,
                                       model=model)
    prob_b, state_b = replicate_problem(prob, state, nb)
    prob_b = perturb_scenarios(prob_b, noise=np.random.default_rng(
        seed).standard_normal((nb, 24)))
    return prob_b, state_b, opt.runtime()


def _assert_same(a, b):
    from hkdmpc_tpu_torch.solver.graphs import leaves
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


@pytest.mark.parametrize("kernel_jac", [True, False], ids=["K1", "K2"])
def test_graph_replay_equals_eager_body(cuda, kernel_jac):
    """solve_batch on the card replays its graph: the result equals the
    eager body's (`ddp._solve_batch`) bit for bit, on both paths, at every
    replay; the graph is captured once and the caller owns the result."""
    from hkdmpc_tpu_torch.solver import graphs
    prob, state, optr = _trot_batch(24, torch.float32, cuda)
    eager = ddp._solve_batch(prob, state, optr, kernel_jac=kernel_jac)
    before = graphs.REPLAYS
    first = ddp.solve_batch(prob, state, optr, kernel_jac=kernel_jac)
    second = ddp.solve_batch(prob, state, optr, kernel_jac=kernel_jac)
    torch.cuda.synchronize()
    assert graphs.REPLAYS == before + 2
    _assert_same(first, eager)
    _assert_same(second, eager)
    assert first.cost.data_ptr() != second.cost.data_ptr()


def test_graph_launch_counters_count_per_replay(cuda):
    """A replay adds the launches recorded at capture: 2 first sweeps and
    2 x 17 masked retries of K1 per solve (runtime caps, the retry bound
    at a growth of 2), whatever the capture itself did."""
    from hkdmpc_tpu_torch.solver import backward
    prob, state, optr = _trot_batch(20, torch.float32, cuda)
    ddp.solve_batch(prob, state, optr, kernel_jac=True)
    for _ in range(3):
        l0, r0 = riccati_hkd.LAUNCHES, riccati_hkd.RETRY_LAUNCHES
        ddp.solve_batch(prob, state, optr, kernel_jac=True)
        assert riccati_hkd.LAUNCHES - l0 == 2
        assert riccati_hkd.RETRY_LAUNCHES - r0 == 2 * (
            backward.retry_sweeps(optr.update_regularization) - 1)


def test_graph_fleet_steps_equal_eager_steps(cuda, tmp_path, monkeypatch):
    """Two fleet steps (8 robots, trot, f32) replaying the fleet's graphs
    equal the same steps of the eager body bit for bit; the state stays in
    the fleet's buffers (donated)."""
    from hkdmpc_tpu_torch.mpc import fused
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    ref = gait_file("trot", str(tmp_path))

    def run():
        stream = meas_stream(8, 3)    # one draw a call: a stream per run
        f = FleetMPC(ref, 8, config=FleetConfig(), dtype=torch.float32,
                     device="cuda")
        f.initialize()
        ptr = f._state_dev.K.data_ptr()
        outs = []
        for s in range(2):
            m = stream(s)
            outs.append(f.step(m["rpy"], m["p"], m["v"], m["omega"],
                               m["qJ"], mpc_time=0.01 * s))
        return outs, ptr, f._state_dev.K.data_ptr()

    graph, ptr0, ptr1 = run()
    assert ptr0 == ptr1

    def eager(tables, state, ints, floats, meas, opt, parallel_rollout,
              n_cmd, kernel_jac, assoc_linear=False, assoc_backward=False):
        on = lambda a, dt: torch.as_tensor(a, dtype=dt, device="cuda")
        return fused._fused_core(tables, state, on(ints, torch.int32),
                                 on(floats, torch.float32),
                                 on(meas, torch.float32), opt,
                                 parallel_rollout, n_cmd, kernel_jac,
                                 assoc_linear, assoc_backward)

    monkeypatch.setattr(fused, "fleet_step", eager)
    want, _, _ = run()
    for g, w in zip(graph, want):
        for name in ("scalars", "controls", "body", "gains", "pf"):
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_graph_capture_refuses_a_host_read(cuda, monkeypatch):
    """A body that reads the host (a forced `.item()`) runs in the eager
    warm-up but raises at capture, naming the capture; nothing is cached
    and nothing falls back to eager. The next solve captures and runs."""
    from hkdmpc_tpu_torch.solver import graphs
    real = ro.dynamics_feasibility

    def reading(defect, norm_id=2):
        defect.abs().max().item()
        return real(defect, norm_id)

    prob, state, optr = _trot_batch(11, torch.float32, cuda)
    monkeypatch.setattr(ro, "dynamics_feasibility", reading)
    held, replays = len(graphs.stats()), graphs.REPLAYS
    with pytest.raises(RuntimeError, match="CUDA graph capture of "
                       "solve_batch"):
        ddp.solve_batch(prob, state, optr, kernel_jac=True)
    assert len(graphs.stats()) == held and graphs.REPLAYS == replays
    monkeypatch.setattr(ro, "dynamics_feasibility", real)
    res = ddp.solve_batch(prob, state, optr, kernel_jac=True)
    assert bool(torch.isfinite(res.cost).all())
    assert graphs.REPLAYS == replays + 1


def test_kernels_with_no_active_scenario_write_nothing(mixed):
    """K1 and K2 with an all-false `active` mask: no output is touched;
    with every other scenario active, those rows get the full sweep's
    values bit for bit and the others are untouched."""
    prob, state = mixed
    cases = ((riccati_hkd.backward_sweep_hkd,
              _args(prob, state, torch.float32)),
             (riccati_dense.backward_sweep_dense,
              _dense_args(prob, state, torch.float32)))
    nb = prob.kind.shape[0]
    for fn, args in cases:
        full = fn(*args)
        out = tuple(torch.full_like(f, float("nan")) if f.is_floating_point()
                    else torch.zeros_like(f) for f in full)
        blank = tuple(o.clone() for o in out)
        fn(*args, active=torch.zeros(nb, dtype=torch.bool, device="cuda"),
           out=out)
        torch.cuda.synchronize()
        for o, b in zip(out, blank):
            assert torch.equal(o.nan_to_num(7.0), b.nan_to_num(7.0))
        half = torch.arange(nb, device="cuda") % 2 == 0
        got = fn(*args, active=half, out=out)
        torch.cuda.synchronize()
        for g, o, f, b in zip(got, out, full, blank):
            assert g is o
            assert torch.equal(o[half], f[half])
            assert torch.equal(o[~half].nan_to_num(7.0),
                               b[~half].nan_to_num(7.0))


def test_graph_with_retries_equals_eager_body(cuda):
    """Scenarios that need regularization retries (a negative ReB weight on
    odd lanes) through the graph and through the eager body, bit for bit:
    on K1's path (masked kernel retries) and on the dense path with the
    parallel-in-time sweep (tensor-code retries: every scenario swept, the
    active rows kept)."""
    prob, state, optr = _trot_batch(6, torch.float32, cuda, seed=8)
    state = tree_map(lambda x: x.clone(), state)
    state.constr.reb_eps[1::2] = -2.0
    for flags in (dict(kernel_jac=True),
                  dict(kernel_jac=False, assoc_linear=True,
                       assoc_backward=True)):
        eager = ddp._solve_batch(prob, state, optr, **flags)
        graph = ddp.solve_batch(prob, state, optr, **flags)
        again = ddp.solve_batch(prob, state, optr, **flags)
        torch.cuda.synchronize()
        _assert_same(graph, eager)
        _assert_same(again, eager)


@pytest.mark.parametrize("kernel_jac", [True, False], ids=["K1", "K2"])
def test_while_graph_equals_eager_body(cuda, kernel_jac):
    """solve_batch(unroll_caps=False) on the card replays one graph with
    two nested conditional while nodes (csrc/graph_while.cu): the result
    equals the eager body's (`ddp._solve_batch(unroll_caps=False)`) bit for
    bit at every replay, cold caps, on both paths."""
    from hkdmpc_tpu_torch.solver import graphs
    prob, state, optr = _trot_batch(24, torch.float32, cuda)
    opt = HSDDPOption()
    eager = ddp._solve_batch(prob, state, opt, kernel_jac=kernel_jac,
                             unroll_caps=False)
    before = graphs.REPLAYS
    first = ddp.solve_batch(prob, state, opt, kernel_jac=kernel_jac,
                            unroll_caps=False)
    second = ddp.solve_batch(prob, state, opt, kernel_jac=kernel_jac,
                             unroll_caps=False)
    torch.cuda.synchronize()
    assert graphs.REPLAYS == before + 2
    _assert_same(first, eager)
    _assert_same(second, eager)
    assert first.cost.data_ptr() != second.cost.data_ptr()
    st = [s for s in graphs.stats()
          if s["label"].startswith("solve_while(B=24,")
          and f"kernel_jac={kernel_jac}," in s["label"]]
    assert len(st) == 1 and st[0]["replays"] == 2
    assert st[0]["iterations"][1] <= opt.max_AL_iter * opt.max_DDP_iter


def test_while_graph_counters_count_iterations(cuda):
    """A while graph's replay adds each piece's launches times the runs the
    loop counters report: on K1's path one first sweep and 17 masked
    retries per inner iteration, none in the other pieces."""
    from hkdmpc_tpu_torch.solver import backward, graphs
    prob, state, _ = _trot_batch(20, torch.float32, cuda)
    opt = HSDDPOption()
    ddp.solve_batch(prob, state, opt, kernel_jac=True, unroll_caps=False)
    for _ in range(2):
        l0, r0 = riccati_hkd.LAUNCHES, riccati_hkd.RETRY_LAUNCHES
        res = ddp.solve_batch(prob, state, opt, kernel_jac=True,
                              unroll_caps=False)
        st = [s for s in graphs.stats()
              if s["label"].startswith("solve_while(B=20,")][0]
        n_outer, n_inner = st["iterations"]
        assert n_inner == int(res.n_iters.max()) >= 1
        assert 1 <= n_outer <= opt.max_AL_iter
        assert riccati_hkd.LAUNCHES - l0 == n_inner
        assert riccati_hkd.RETRY_LAUNCHES - r0 == n_inner * (
            backward.retry_sweeps(opt.update_regularization) - 1)
        pieces = st["pieces"]
        assert pieces["inner"]["launches"]["riccati_hkd.LAUNCHES"] == 1
        assert all(pieces[p]["launches"]["riccati_hkd.LAUNCHES"] == 0
                   for p in ("carry0", "head", "tail"))


def test_while_graph_build_error_raises(cuda, monkeypatch):
    """A failed assembly of the while graph raises RuntimeError naming the
    step; nothing is cached, nothing falls back to the eager body."""
    from hkdmpc_tpu_torch.solver import graphs

    class Refusing:
        def graph_while_build(self, *args):
            args[-2].value = b"cudaGraphInstantiate (parent): refused"
            return 1

    prob, state, _ = _trot_batch(7, torch.float32, cuda)
    opt = HSDDPOption()
    monkeypatch.setattr(graphs, "_while_lib", lambda: Refusing())
    held, replays = len(graphs.stats()), graphs.REPLAYS
    with pytest.raises(RuntimeError, match="building the while graph "
                       "failed at cudaGraphInstantiate"):
        ddp.solve_batch(prob, state, opt, kernel_jac=True, unroll_caps=False)
    assert len(graphs.stats()) == held and graphs.REPLAYS == replays
    monkeypatch.undo()
    res = ddp.solve_batch(prob, state, opt, kernel_jac=True,
                          unroll_caps=False)
    assert bool(torch.isfinite(res.cost).all())
    assert graphs.REPLAYS == replays + 1


def test_resets_add_no_graph(cuda, tmp_path):
    """The single robot (fused step, K2 at B = 1) and the fleet (8 robots):
    after the first reset, k more resets (initialize, resume, load_fleet)
    add no graph, the resident tables and state keep their addresses, and
    the update after each reset replays without a capture (each rollout
    kind that update takes was captured before the resets)."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.utils.checkpoint import (load_fleet, save_fleet,
                                                   save_problem)
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    ref = gait_file("trot", str(tmp_path))
    ptrs = lambda *trees: [t.data_ptr() for t in graphs.leaves(trees)]
    s = HKDMPCSolver(ref, config=MPCConfig(fused_step=True,
                                           assoc_linear=False,
                                           assoc_backward=False),
                     dtype=torch.float32, device="cuda")
    m = {k: v[0] for k, v in meas_stream(1, 5)(0).items()}
    update = lambda: s.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    s.initialize()
    update()
    ckpt = str(tmp_path / "robot.npz")
    save_problem(ckpt, s.problem)
    update()     # the update after the resume: its rollout kind captured
    labels = lambda: [st["label"] for st in graphs.stats()]
    held, addr = labels(), ptrs(s._tables, s._state_dev)
    for reset in (s.initialize, s.initialize, lambda: s.resume(ckpt)):
        reset()
        assert ptrs(s._tables, s._state_dev) == addr
        update()
        assert labels() == held
    s.close()

    f = FleetMPC(ref, 8, config=FleetConfig(), dtype=torch.float32,
                 device="cuda")
    stream = meas_stream(8, 3)
    def step(k):
        d = stream(k)
        f.step(d["rpy"], d["p"], d["v"], d["omega"], d["qJ"])
    f.initialize()
    step(0)
    path = str(tmp_path / "fleet.npz")
    save_fleet(path, f)
    step(1)
    held, addr = labels(), ptrs(f._tables, f._state_dev)
    for k, reset in enumerate((f.initialize, f.initialize,
                               lambda: load_fleet(path, f))):
        reset()
        assert ptrs(f._tables, f._state_dev) == addr
        step(k + 2)
        assert labels() == held
