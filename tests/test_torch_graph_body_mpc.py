"""The pieces that the device programs of `fleet_step` and `fused_step`
capture (`graphs.StepProgram`: `pre`, the solve's pieces with the AL and
DDP loops unrolled and the retry loop a while loop, `post` writing the new
state over the resident one) on the CPU in float64, driven in the
program's order (`_torch_twin.drive`): after one warm-up run, every piece
runs with no host read and no tensor made from host data
(`_torch_twin.no_host_reads`) and the step equals the JAX
package's jitted `fleet_step` / `fused_step` on the same inputs, from
perturbed carried-over states, runtime caps: the fleet step of N = 3 robots
on the trot at plan 0.3 s (T = 45) after 8 receding-horizon updates, the
step that appends a phase (not all-shooting: the sequential rollout), on
the dense path (the kernel_jac path's solve pieces are held to JAX in
`test_torch_graph_body.py`; the step's own gathers are the same on both);
and one robot's step at plan 0.1 s (T = 25) after 3 updates on the dense
path with the parallel-in-time recursions on (the single-robot defaults on
the card) and off (K2's path). Bundles to 1e-9 and states to 1e-8 of
magnitude, as `tests/test_torch_fused.py`."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.mpc import fused as jfused
from hkdmpc_tpu_torch.mpc import fused as tfused
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.solver import structs as tstructs
from hkdmpc_tpu_torch.solver.structs import tree_map
from tests._torch_twin import (F64, assert_close, both, fleet_meas,
                               port_option, problem_pair, program_step,
                               tile_tree, to_numpy_tree)

torch.set_num_threads(2)

N_CMD = 8


def _step_inputs(tmp_path, plan, n, updates, seed):
    """(JAX HKDProblem, port HKDProblem, numpy state tree (n robots), ints,
    floats, (n, 28) measurements) of the trot at plan `plan` after
    `updates` updates."""
    jpb, tpb = problem_pair("trot", plan, tmp_path)
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


def test_capturable_fleet_step_reads_nothing_and_matches_jax(tmp_path):
    n = 3
    jpb, tpb, state_n, ints, floats, meas = _step_inputs(tmp_path, 0.3, n,
                                                         8, 5)
    assert not tpb.all_shooting()
    jstate, tstate = both(state_n, tstructs.SolverState)
    optr = HSDDPOption().runtime()
    jnew, jbundle = jfused.fleet_step(
        jfused.make_tables(jpb, jnp.float64), jstate, ints, floats,
        jnp.asarray(meas), optr, False, N_CMD, unroll_caps=True)
    tables = tfused.make_tables(tpb, F64, "cpu")
    on = lambda a, dt: torch.as_tensor(a, dtype=dt)
    args = (on(ints, torch.int32), on(floats, F64), on(meas, F64))
    tnew, tbundle = program_step(tables, tstate, *args, port_option(optr),
                                 False, N_CMD, True)
    _assert_step_matches(tnew, tbundle, jnew, jbundle)
    assert not np.any(tbundle.numpy()[:, 5])


@pytest.mark.parametrize("assoc", [True, False])
def test_capturable_single_robot_step_matches_jax(tmp_path, assoc):
    """One robot's step (the core at N = 1, as `fused_step` runs it) on the
    dense path, the parallel-in-time recursions on or off."""
    jpb, tpb, state_n, ints, floats, meas = _step_inputs(tmp_path, 0.1, 1,
                                                         3, 7)
    assert tpb.all_shooting()
    one = {k: (v if isinstance(v, dict) else v[0]) for k, v in
           state_n.items()}
    one["constr"] = {k: v[0] for k, v in state_n["constr"].items()}
    jstate, tstate = both(one, tstructs.SolverState)
    optr = HSDDPOption().runtime()
    jnew, jbundle = jfused.fused_step(
        jfused.make_tables(jpb, jnp.float64), jstate, ints, floats,
        jnp.asarray(meas[0]), optr, True, N_CMD, assoc_linear=assoc,
        assoc_backward=assoc, kernel_jac=False, unroll_caps=True)
    tables = tfused.make_tables(tpb, F64, "cpu")
    on = lambda a, dt: torch.as_tensor(a, dtype=dt)
    args = (on(ints, torch.int32), on(floats, F64), on(meas, F64))
    tnew, tbundle = program_step(
        tables, tree_map(lambda a: a[None], tstate), *args,
        port_option(optr), True, N_CMD, True, assoc_linear=assoc,
        assoc_backward=assoc)
    _assert_step_matches(tree_map(lambda a: a[0], tnew), tbundle[0], jnew,
                         jbundle)
