"""Port parity of the dense Riccati backward sweep (`ops/riccati_dense.py`,
the module that holds the CUDA kernel K2, and `solver/backward.py`'s dense
branch) against the JAX package, and the kernel build key (`ops/_build.py`).

On the CPU the port runs the kernel's plain version. Its inputs are the LQ
data of the swing-constraint trot along a perturbed rollout (nonzero GRFs,
off-reference states, AL weights on), four scenarios with per-lane
regularization 0, 1e-3, 0.05 and 2.0. It is held in float64 to JAX
`riccati_backward` under vmap (the JAX package's batched rule runs its scan
in f64) at 1e-10 relative to each output's magnitude. The slow test holds
it in float32, together with the JAX Pallas kernel `backward_sweep_pallas`
in interpret mode, to the f64 sweep with the bound of
test_fast_paths.py::test_pallas_backward_matches_scan_per_lane_reg. The CUDA
kernel itself is held to the plain version on the card by
test_torch_kernel_gpu.py and chip_smoke.py."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.solver import backward as jbackward
from hkdmpc_tpu_torch.ops import _build, riccati_dense
from hkdmpc_tpu_torch.solver import backward, lq, rollout as ro
from hkdmpc_tpu_torch.solver.structs import ProblemData, SolverState
from tests._torch_twin import assert_close, batched_trot, both, specs

torch.set_num_threads(2)

REGS = (0.0, 1e-3, 0.05, 2.0)
B = len(REGS)
TOL = 1e-10
NAMES = ("dU", "K", "dv1", "dv2", "ok")


def _dense_inputs(model="swing", plan_duration=0.6):
    """(prob, sweep args without reg/last, last, X, U, constr) in f64."""
    jspec, spec = specs(model)
    prob_n, state_n, _ = batched_trot(B, seed=13, plan_duration=plan_duration,
                                      model=jspec)
    rng = np.random.default_rng(14)
    T = prob_n["kind"].shape[1]
    state_n["Xbar"] = prob_n["xr"] + 0.01 * rng.normal(size=prob_n["xr"].shape)
    state_n["Ubar"] = prob_n["ur"][:, :T] + 3.0 * rng.normal(size=(B, T, 24))
    c = state_n["constr"]
    c["al_sigma"] = c["al_sigma"] + rng.uniform(0.0, 3.0, c["al_sigma"].shape)
    c["al_lambda"] = rng.normal(size=c["al_lambda"].shape)
    _, prob = both(prob_n, ProblemData)
    _, state = both(state_n, SolverState)
    r = ro.hybrid_rollout_parallel(prob, state, 0.0, spec)
    l = lq.lq_approximation(prob, r.X, r.U, state.constr, True, True, spec)
    args = (prob.kind, l.A, l.B, l.lxx, l.luu, l.lx, l.lu, r.defect, l.phix,
            l.phixx)
    return prob, args, ro.last_active_node(prob), r, state.constr


@pytest.fixture(scope="module")
def sweep():
    prob, args, last, _, _ = _dense_inputs()
    reg = torch.tensor(REGS, dtype=torch.float64)
    got = backward.riccati_backward(*args, reg, last)
    want = jax.jit(jax.vmap(jbackward.riccati_backward))(
        *[a.numpy() for a in args], reg.numpy(), last.numpy())
    return got, want


@pytest.mark.parametrize("out", NAMES)
def test_plain_sweep_matches_jax(sweep, out):
    """Port riccati_backward (the plain version on the CPU) against JAX
    riccati_backward under vmap, per-lane reg."""
    got, want = sweep
    i = NAMES.index(out)
    g, w = got[i], np.asarray(want[i])
    assert tuple(g.shape) == w.shape
    if out == "ok":
        np.testing.assert_array_equal(g.numpy(), w)
    else:
        assert_close(g, w, TOL, out)


def test_sweep_outputs_are_nontrivial(sweep):
    dU, K, dv1, dv2, ok = sweep[0]
    assert bool(ok.all())
    assert float(K.abs().max()) > 1.0 and float(dU.abs().max()) > 1.0
    assert bool((dv2 > 0).all())
    # the regularization really differs per lane
    assert not torch.allclose(K[0], K[3])


def test_dense_sweep_matches_hkd_sweep_on_default_model():
    """On the default HKD model the dense sweep over the materialized LQ
    data equals the sweep that rebuilds it from (X, U)
    (`riccati_backward_hkd`), f64."""
    prob, args, last, r, con = _dense_inputs("default")
    reg = torch.tensor(REGS, dtype=torch.float64)
    dense = backward.riccati_backward(*args, reg, last)
    hkd = backward.riccati_backward_hkd(
        prob.kind, r.X, r.U, prob.contact, prob.contact_next, prob.xr,
        prob.ur, prob.foot_r, con.reb_delta, con.reb_eps, prob.term_contact,
        prob.td_mask, con.al_sigma, con.al_lambda, prob.term_mask, r.defect,
        reg, last, prob.dt)
    for name, a, b in zip(NAMES, dense, hkd):
        if name == "ok":
            assert torch.equal(a, b)
        else:
            assert_close(a, b.numpy(), 1e-11, name)


def test_regularized_dense_sweep_retries_per_scenario():
    """The retry loop around the dense sweep: scenario 1 with a negative
    barrier weight retries with growing reg; scenario 0 finishes at once."""
    jspec, spec = specs("swing")
    prob, args, last, r, con = _dense_inputs()
    con.reb_eps[1] = -30.0
    l = lq.lq_approximation(prob, r.X, r.U, con, True, True, spec)
    out = backward.backward_sweep_regularized(prob, r.defect, 0.0, 2.0, last,
                                              lq=l)
    reg_out, ok, failed = out[4:]
    assert bool(ok[0]) and float(reg_out[0]) == 0.0
    assert float(reg_out[1]) > float(reg_out[0])
    assert not bool(failed.any())
    with pytest.raises(ValueError):
        backward.backward_sweep_regularized(prob, r.defect, 0.0, 2.0, last)


def test_dispatch_is_by_device():
    """A CPU tensor takes the plain version (no kernel launch); the kernel
    wrapper refuses tensors that are not on a CUDA device."""
    _, args, last, _, _ = _dense_inputs()
    reg = torch.zeros(B, dtype=torch.float64)
    before = riccati_dense.LAUNCHES
    out = riccati_dense.backward_sweep_dense(*args, reg, last)
    ref = riccati_dense.backward_sweep_dense_plain(*args, reg, last)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        riccati_dense.backward_sweep_dense_cuda(*f32, reg.float(), last)
    assert riccati_dense.LAUNCHES == before


def test_build_key_covers_included_headers(tmp_path):
    """A library's key changes with every header its source includes, and
    only with those; the generated constants header is hashed only where it
    is included."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    dense, hkd = csrc / "riccati_dense.cu", csrc / "riccati_hkd.cu"
    linear = csrc / "linear_rollout_hkd.cu"
    assert [p.name for p in _build.included_files(dense)] == \
        ["riccati_step.cuh"]
    for src in (hkd, linear):
        assert [p.name for p in _build.included_files(src)] == \
            ["hkd_entries.cuh", "riccati_step.cuh"]
        assert _build.uses_generated_header(src)
    assert not _build.uses_generated_header(dense)
    keys = {p: _build.build_key(p) for p in (dense, hkd, linear)}
    (csrc / "unrelated.cuh").write_text("// not included\n")
    assert {p: _build.build_key(p) for p in keys} == keys
    entries = csrc / "hkd_entries.cuh"
    entries.write_text(entries.read_text() + "\n// edited\n")
    assert {p: _build.build_key(p) != k for p, k in keys.items()} == \
        {dense: False, hkd: True, linear: True}
    keys = {p: _build.build_key(p) for p in keys}
    step = csrc / "riccati_step.cuh"
    step.write_text(step.read_text() + "\n// edited\n")
    for p, k in keys.items():
        assert _build.build_key(p) != k, p.name
    dense.write_text(dense.read_text().replace(
        '#include "riccati_step.cuh"', '#include "missing.cuh"'))
    with pytest.raises(FileNotFoundError, match="missing.cuh"):
        _build.build_key(dense)


@pytest.mark.slow
def test_plain_f32_and_jax_kernel_interpret_hold_to_oracle():
    """The plain version in f32 and the JAX Pallas kernel (interpret mode)
    on the same f32 inputs, each held to the f64 sweep: either one's error
    stays within 4 x the other's roundoff + 1e-6, and the PSD gates agree
    (plan 0.3 s)."""
    from hkdmpc_tpu.ops.pallas_backward import backward_sweep_pallas

    _, args, last, _, _ = _dense_inputs(plan_duration=0.3)
    reg = torch.tensor(REGS, dtype=torch.float64)
    oracle = riccati_dense.backward_sweep_dense_plain(*args, reg, last)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    plain = riccati_dense.backward_sweep_dense_plain(*f32, reg.float(), last)
    kern = backward_sweep_pallas(
        *[jnp.asarray(a.numpy()) for a in f32], jnp.asarray(reg.float().numpy()),
        jnp.asarray(last.numpy()), interpret=True)
    for name, p, k, o in zip(NAMES[:4], plain, kern, oracle):
        o = o.numpy()
        err_p = float(np.max(np.abs(p.double().numpy() - o)))
        err_k = float(np.max(np.abs(np.asarray(k, np.float64) - o)))
        assert err_k <= 4.0 * err_p + 1e-6, (name, err_k, err_p)
        assert err_p <= 4.0 * err_k + 1e-6, (name, err_p, err_k)
    np.testing.assert_array_equal(plain[4].numpy(), np.asarray(kern[4]))
