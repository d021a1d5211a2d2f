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
test_fast_paths.py::test_f32_batch_final_cost_matches_f64_oracle)."""
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch.solver import backward, ddp, lq, rollout as ro
from hkdmpc_tpu_torch.solver.problem import HKDProblem
from hkdmpc_tpu_torch.solver.structs import tree_map
from hkdmpc_tpu_torch.workload import initial_state, trot_problem

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
    prob, state = pb.build(initial_state(pb.phases[0].contact))
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
    for name, g, p, o in zip(("dU", "K", "dv1", "dv2"), got, plain, oracle):
        assert bool(torch.isfinite(g).all()), name
        err = float((g.double() - o).abs().max())
        roundoff = float((p.double() - o).abs().max())
        assert err <= max(10.0 * roundoff, 1e-5), (name, err, roundoff)
    # the PSD gate can flip at the ulp level between elimination orders
    assert float((got[4] == oracle[4]).double().mean()) >= 0.999
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
    for name, g, p, o in zip(("dU", "K", "dv1", "dv2"), got, plain, oracle):
        assert bool(torch.isfinite(g).all()), name
        err = float((g.double() - o).abs().max())
        roundoff = float((p.double() - o).abs().max())
        assert err <= max(10.0 * roundoff, 1e-5), (name, err, roundoff)
    assert float((got[4] == oracle[4]).double().mean()) >= 0.999
    assert not torch.equal(prob.kind[0], prob.kind[1])


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
