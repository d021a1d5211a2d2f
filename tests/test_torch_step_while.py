"""The MPC step's `unroll_caps` and `model` keywords (`mpc/fused.py`), float64
on the CPU, against the JAX package's `fused.fleet_step` / `fused_step`
with the same keywords:

- `fleet_step` of N = 3 robots on the trot at plan 0.3 s after 8
  receding-horizon updates (the step that appends a phase: the sequential
  rollout), from perturbed carried-over states, dense path, with
  `unroll_caps` True and False;
- one robot's `fused_step(model=hkd_model_spec(swing_constraint=True))` at
  plan 0.1 s after 3 updates, the loops that stop;
- the step's device program (`fused.StepProgram`: `pre`, the solve's
  pieces, `post`) driven on the host in its order, every piece under
  `_torch_twin.no_host_reads`, equals `fused._fused_core` bit for bit.

Bundles to 1e-9 and states to 1e-8 of magnitude, as
`tests/test_torch_fused.py`. `FleetMPC(FleetConfig(unroll_caps=False))` is
held to the JAX fleet in `test_torch_fleet_kj.py`."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.mpc import fused as jfused
from hkdmpc_tpu.solver.problem import HKDProblem as JProblem
from hkdmpc_tpu.reference.quad_reference import QuadReference as JRef
from hkdmpc_tpu_torch.mpc import fused as tfused
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.solver import structs as tstructs
from hkdmpc_tpu_torch.solver.problem import HKDProblem
from hkdmpc_tpu_torch.solver.structs import tree_map
from hkdmpc_tpu_torch.workload import gait_file
from tests._torch_twin import (F64, assert_close, both, fleet_meas,
                               port_option, program_step, specs, tile_tree,
                               to_numpy_tree)

torch.set_num_threads(2)

N_CMD = 8


def _step_inputs(tmp_path, plan, n, updates, seed, model=None):
    """(JAX HKDProblem, port HKDProblem, numpy state tree (n robots), ints,
    floats, (n, 28) measurements) of the trot at plan `plan` after
    `updates` updates, for `model` (a (JAX, port) spec pair or None)."""
    path = gait_file("trot", str(tmp_path))
    jm, tm = model if model is not None else (None, None)
    jpb = JProblem(JRef.from_file(path), plan_duration=plan,
                   dtype=jnp.float64, model=jm)
    tpb = HKDProblem(QuadReference.from_file(path), dtype=F64, device="cpu",
                     plan_duration=plan, model=tm)
    jpb.initialization()
    tpb.initialization()
    for _ in range(updates):
        jpb.update(1)
        tpb.update(1)
    _, state = jpb.build(default_stand_state(jpb.phases[0].contact))
    state_n = tile_tree(to_numpy_tree(state), n)
    rng = np.random.default_rng(seed)
    T = jpb.T
    state_n["Ubar"] = state_n["Ubar"] + rng.standard_normal((n, T, 24))
    state_n["K"] = 0.02 * rng.standard_normal((n, T, 24, 24))
    state_n["dX"] = 0.01 * rng.standard_normal((n, T + 1, 24))
    state_n["defect_bar"] = 0.01 * rng.standard_normal((n, T + 1, 24))
    ints, floats, _, _ = tfused.host_step(tpb, tpb.flat_offsets(), 1, N_CMD,
                                          0.0, 0.01, np.float64)
    jfused.host_step(jpb, jpb.flat_offsets(), 1, N_CMD, 0.0, 0.01,
                     np.float64)
    m = fleet_meas(n, 1)[0]
    meas = np.stack([tfused.pack_meas(
        np.float64, eul=m["rpy"][i, ::-1], p=m["p"][i], omega=m["omega"][i],
        v=m["v"][i], qJ=m["qJ"][i], front_contact=tpb.phases[0].contact)
        for i in range(n)])
    return jpb, tpb, state_n, ints, floats, meas


def _assert_step_matches(tnew, tbundle, jnew, jbundle):
    tb, jb = tbundle.numpy(), np.asarray(jbundle)
    assert tb.shape == jb.shape
    np.testing.assert_array_equal(np.isnan(tb), np.isnan(jb))
    assert_close(np.nan_to_num(tb), np.nan_to_num(jb), 1e-9, "bundle")
    jnew = to_numpy_tree(jnew)
    for name in ("Xbar", "Ubar", "dU", "K", "dX", "defect_bar"):
        assert_close(getattr(tnew, name), jnew[name], 1e-8, name)
    for name, want in jnew["constr"].items():
        assert_close(getattr(tnew.constr, name), want, 1e-8, name)


def _assert_same(a, b):
    from hkdmpc_tpu_torch.solver.graphs import leaves
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


@pytest.mark.parametrize("unroll_caps", [True, False],
                         ids=["unrolled", "while"])
def test_fleet_step_matches_jax_both_forms(tmp_path, unroll_caps):
    n = 3
    jpb, tpb, state_n, ints, floats, meas = _step_inputs(tmp_path, 0.3, n,
                                                         8, 5)
    assert not tpb.all_shooting()
    jstate, tstate = both(state_n, tstructs.SolverState)
    optr = HSDDPOption().runtime()
    jnew, jbundle = jfused.fleet_step(
        jfused.make_tables(jpb, jnp.float64), jstate, ints, floats,
        jnp.asarray(meas), optr, False, N_CMD, unroll_caps=unroll_caps)
    tables = tfused.make_tables(tpb, F64, "cpu")
    tnew, tbundle = tfused.fleet_step(tables, tstate, ints, floats, meas,
                                      port_option(optr), False, N_CMD, False,
                                      unroll_caps=unroll_caps)
    _assert_step_matches(tnew, tbundle, jnew, jbundle)

    # the step's device program, driven on the host, is the eager step
    on = lambda a, dt: torch.as_tensor(a, dtype=dt)
    args = (on(ints, torch.int32), on(floats, F64), on(meas, F64))
    pnew, pbundle = program_step(tables, tstate, *args, port_option(optr),
                                 False, N_CMD, unroll_caps)
    _assert_same(pnew, tnew)
    assert torch.equal(pbundle.nan_to_num(), tbundle.nan_to_num())


def test_fused_step_with_a_model_matches_jax(tmp_path):
    """One robot on the swing-constraint model (its own ReB rows), the
    dense path, the loops that stop (the single robot's form): the port's
    `fused_step(model=)` and its device program against JAX's
    `fused_step(model=)`."""
    unroll_caps = False
    jspec, tspec = specs("swing")
    jpb, tpb, state_n, ints, floats, meas = _step_inputs(
        tmp_path, 0.1, 1, 3, 7, model=(jspec, tspec))
    one = {k: (v if isinstance(v, dict) else v[0]) for k, v in
           state_n.items()}
    one["constr"] = {k: v[0] for k, v in state_n["constr"].items()}
    jstate, tstate = both(one, tstructs.SolverState)
    optr = HSDDPOption().runtime()
    jnew, jbundle = jfused.fused_step(
        jfused.make_tables(jpb, jnp.float64), jstate, ints, floats,
        jnp.asarray(meas[0]), optr, tpb.all_shooting(), N_CMD, model=jspec,
        unroll_caps=unroll_caps)
    tables = tfused.make_tables(tpb, F64, "cpu")
    tnew, tbundle = tfused.fused_step(
        tables, tstate, ints, floats, meas[0], port_option(optr),
        tpb.all_shooting(), N_CMD, kernel_jac=False, assoc_linear=False,
        assoc_backward=False, model=tspec, unroll_caps=unroll_caps)
    _assert_step_matches(tree_map(lambda a: a[None], tnew), tbundle[None],
                         tree_map(lambda a: a[None], jnew), jbundle[None])

    on = lambda a, dt: torch.as_tensor(a, dtype=dt)
    pnew, pbundle = program_step(
        tables, tree_map(lambda a: a[None], tstate), on(ints, torch.int32),
        on(floats, F64), on(meas, F64), port_option(optr),
        tpb.all_shooting(), N_CMD, unroll_caps, model=tspec)
    _assert_same(tree_map(lambda a: a[0], pnew), tnew)
    assert torch.equal(pbundle[0].nan_to_num(), tbundle.nan_to_num())
    with pytest.raises(ValueError, match="kernel_jac=True"):
        tfused.fused_step(tables, tstate, ints, floats, meas[0],
                          port_option(optr), True, N_CMD, kernel_jac=True,
                          assoc_linear=False, assoc_backward=False,
                          model=tspec)
