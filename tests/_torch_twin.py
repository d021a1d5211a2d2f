"""Shared fixtures of the PyTorch-port parity tests (`test_torch_*.py`): the
in-repo trot workload built by the JAX package, scenario batches made from
numpy noise, and the carry of structs between the two packages as numpy
arrays. Both packages run on the CPU in float64 (tests/conftest.py pins JAX
to CPU f64)."""

import contextlib
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.models import hkd
from hkdmpc_tpu.reference.quad_reference import QuadReference
from hkdmpc_tpu.reference.refgen import GaitSynthesizer
from hkdmpc_tpu.solver import model_api as jmodel_api
from hkdmpc_tpu.solver import structs as jstructs
from hkdmpc_tpu.solver.problem import HKDProblem
from hkdmpc_tpu_torch import config as tconfig
from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.mpc import solver as tsolver
from hkdmpc_tpu_torch.parallel.batch import default_x0_scale
from hkdmpc_tpu_torch.reference.quad_reference import (
    QuadReference as TQuadReference)
from hkdmpc_tpu_torch.solver import model_api, structs as tstructs

F64 = torch.float64

# the in-repo model specs, by name: swing_constraint of hkd_model_spec
SPECS = {"default": False, "swing": True}


def specs(name):
    """(JAX ModelSpec, port ModelSpec) of the named in-repo spec."""
    swing = SPECS[name]
    return (jmodel_api.hkd_model_spec(swing_constraint=swing),
            model_api.hkd_model_spec(swing_constraint=swing))


def port_option(jopt):
    """The port's HSDDPOption with the field values of the JAX package's
    `jopt`: each package is handed its own option object."""
    return tconfig.HSDDPOption(**dataclasses.asdict(jopt))


def jax_trot_problem(plan_duration=0.6, model=None):
    """(HKDProblem, ProblemData, SolverState, HSDDPOption) of the same trot
    the port's `workload.trot_problem` builds, from the JAX package, f64,
    for the JAX ModelSpec `model` (None: the default HKD model)."""
    with tempfile.TemporaryDirectory() as d:
        path = GaitSynthesizer().write(os.path.join(d, "trot.csv"),
                                       workload.TROT_SEGMENTS)
        ref = QuadReference.from_file(path)
    pb = HKDProblem(ref, plan_duration=plan_duration, dtype=jnp.float64,
                    model=model)
    pb.initialization()
    body = np.zeros(12)
    body[5] = tsolver.STAND_BODY_HEIGHT
    qd = hkd.compute_hkd_state(
        jnp.array(body[:3]), jnp.array(body[3:6]),
        jnp.array(np.tile(tsolver.STAND_QLEG, 4)),
        jnp.array(pb.phases[0].contact, dtype=jnp.float64))
    x0 = np.concatenate([body, np.asarray(qd)])
    prob, state = pb.build(x0)
    return pb, prob, state, HSDDPOption()


def to_numpy_tree(obj):
    """dataclasses.asdict of a JAX struct with numpy leaves."""
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, obj))


def jax_struct(cls, tree):
    """A JAX ProblemData / SolverState from a numpy field tree."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = tree[f.name]
        kw[f.name] = (jax_struct(jstructs.ConstraintState, v)
                      if f.name == "constr" else jnp.asarray(v))
    return cls(**kw)


def tile_tree(tree, batch):
    return {k: (tile_tree(v, batch) if isinstance(v, dict)
                else np.repeat(np.asarray(v)[None], batch, axis=0))
            for k, v in tree.items()}


def x0_noise(batch, seed):
    """Standard-normal x0 noise (batch, 24) and its scaled perturbation."""
    noise = np.random.default_rng(seed).standard_normal((batch, 24))
    return noise, noise * default_x0_scale(F64, "cpu").numpy()


def batched_trot(batch, seed, plan_duration=0.6, model=None):
    """Numpy field trees (prob, state) of `batch` perturbed trot scenarios —
    the same arrays for both packages — and the JAX package's option set
    (`port_option` makes the port's). model: a JAX ModelSpec (it sizes the
    constraint rows)."""
    _, prob, state, opt = jax_trot_problem(plan_duration, model)
    prob_n = tile_tree(to_numpy_tree(prob), batch)
    state_n = tile_tree(to_numpy_tree(state), batch)
    prob_n["x0"] = prob_n["x0"] + x0_noise(batch, seed)[1]
    return prob_n, state_n, opt


def both(tree, cls):
    """(JAX struct, port struct) of one numpy field tree; cls is the port's
    ProblemData or SolverState."""
    return (jax_struct(getattr(jstructs, cls.__name__), tree),
            tstructs.from_numpy(tree, "cpu", F64))


def assert_close(got, want, rtol, what=""):
    """|got - want| <= rtol * max(1, max|want|) elementwise: a tolerance
    relative to the array's magnitude."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0.0,
                               atol=rtol * scale, err_msg=what)


def solve_both(batch, seed, plan_duration, model=None):
    """The batched solve (runtime caps) of the same perturbed trot scenarios
    in both packages: (port SolveResult, JAX SolveResult).

    model None: the throughput path — the port's kernel_jac=True against
    the JAX package's parallel_rollout + kernel_jac + unroll_caps. model a
    name in SPECS: the dense path with that spec — the port's
    kernel_jac=False against parallel_rollout + pallas_backward +
    unroll_caps (in f64 the JAX batched rule runs its scan)."""
    from hkdmpc_tpu.solver import ddp as jddp
    from hkdmpc_tpu_torch.solver import ddp

    jspec, spec = specs(model) if model is not None else (None, None)
    prob_n, state_n, opt = batched_trot(batch, seed, plan_duration, jspec)
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    jflags = dict(parallel_rollout=True, unroll_caps=True)
    topt = port_option(opt)
    if model is None:
        got = ddp.solve_batch(prob, state, topt.runtime(), kernel_jac=True)
        want = jddp.solve_batch(jprob, jstate, opt.runtime(), kernel_jac=True,
                                **jflags)
    else:
        got = ddp.solve_batch(prob, state, topt.runtime(), kernel_jac=False,
                              model=spec)
        want = jddp.solve_batch(jprob, jstate, opt.runtime(), model=jspec,
                                pallas_backward=True, **jflags)
    return got, jax.tree_util.tree_map(np.asarray, want)


def assert_solves_match(got, want):
    """Decisions equal; values to 1e-9 (scalars) and 1e-8 (Ubar, K)
    relative to magnitude."""
    np.testing.assert_array_equal(got.n_iters.numpy(), want.n_iters)
    np.testing.assert_array_equal(got.solve_failed.numpy(), want.solve_failed)
    for name in ("cost_trace", "feas_trace", "eqn_trace", "ineq_trace"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        assert_close(np.nan_to_num(g), np.nan_to_num(w), 1e-9, name)
    for name in ("cost", "dyn_feas", "max_tconstr", "max_pconstr"):
        assert_close(getattr(got, name), getattr(want, name), 1e-9, name)
    for name in ("Ubar", "K", "Xbar", "dU", "dX"):
        assert_close(getattr(got.state, name), getattr(want.state, name),
                     1e-8, name)


# ---------------------------------------------------------------------------
# receding-horizon problems and fleets
# ---------------------------------------------------------------------------

def problem_pair(gait, plan_duration, directory):
    """(JAX HKDProblem, port HKDProblem) of the in-repo gait file, both
    initialized, f64 on the CPU."""
    from hkdmpc_tpu_torch.solver.problem import HKDProblem as TProblem
    path = workload.gait_file(gait, str(directory))
    jpb = HKDProblem(QuadReference.from_file(path),
                     plan_duration=plan_duration, dtype=jnp.float64)
    tpb = TProblem(TQuadReference.from_file(path), dtype=F64, device="cpu",
                   plan_duration=plan_duration)
    jpb.initialization()
    tpb.initialization()
    return jpb, tpb


def solved_pair(gait, plan_duration, directory):
    """problem_pair's two problems holding one solution: the port's cold
    solve (kernel_jac path, HSDDPOption(), f64 on the CPU) from the stand
    pose, written into both packages' per-phase arrays. Returns (JAX
    HKDProblem, port HKDProblem, x0, the port's SolveResult)."""
    from hkdmpc_tpu_torch.solver import ddp
    jpb, tpb = problem_pair(gait, plan_duration, directory)
    x0 = tsolver.default_stand_state(tpb.phases[0].contact)
    prob, state = tpb.build(x0)
    res = ddp.solve(prob, state, port_option(HSDDPOption()), kernel_jac=True,
                    parallel_rollout=tpb.all_shooting())
    tpb.unflatten(res.state)
    for jph, tph in zip(jpb.phases, tpb.phases):
        for name in PHASE_ARRAYS:
            setattr(jph, name, np.array(getattr(tph, name)))
    return jpb, tpb, x0, res


def fleet_meas(n_robots, n_steps):
    """Per step, a dict of (n_robots, ...) measurement arrays: robot i draws
    from the stream of tests/test_fleet.py:20-30 seeded 100 + i."""
    rngs = [np.random.default_rng(100 + i) for i in range(n_robots)]
    steps = []
    for _ in range(n_steps):
        ms = [dict(rpy=r.normal(scale=0.01, size=3),
                   p=np.array([0.0, 0.0, 0.25]) + r.normal(scale=0.005,
                                                           size=3),
                   v=r.normal(scale=0.02, size=3),
                   omega=r.normal(scale=0.02, size=3),
                   qJ=np.tile([0.0, -0.8, 1.6], 4)
                   + r.normal(scale=0.01, size=12)) for r in rngs]
        steps.append({k: np.stack([m[k] for m in ms]) for k in ms[0]})
    return steps


def step_fleet(fleet, meas, first, count):
    """Step a FleetMPC (either package's) through meas[first:first+count]
    with mpc_time = 0.01 k; per step, a record of the step's output, every
    robot's command, the schedule events and all_shooting()."""
    recs = []
    for k in range(first, first + count):
        m = meas[k]
        before = [ph.uid for ph in fleet.problem.phases]
        out = fleet.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time=0.01 * k)
        after = [ph.uid for ph in fleet.problem.phases]
        recs.append(dict(
            out={k_: np.array(v) for k_, v in out.items()
                 if k_ != "solve_time"},
            cmds=[fleet.command(i) for i in range(fleet.n)],
            all_shooting=fleet.problem.all_shooting(),
            appended=after[-1] not in before, popped=after[0] != before[0]))
    return recs


def fleet_state(fleet):
    """The fleet's warm-start state as numpy: Xbar, Ubar, K, al_lambda."""
    st = fleet._state_dev
    f = lambda a: (a.numpy() if isinstance(a, torch.Tensor)
                   else np.asarray(a))
    return dict(Xbar=f(st.Xbar), Ubar=f(st.Ubar), K=f(st.K),
                al_lambda=f(st.constr.al_lambda))


def assert_steps_match(got, want, what=""):
    """Fleet step records (step_fleet) of the port against the JAX
    package's, at the tolerances of tests/test_fleet.py:66-97: controls,
    body and foot placements rtol 1e-9 / atol 1e-10, gains rtol 1e-8 /
    atol 1e-8, cost traces rtol 1e-9; n_iters, solve_failed and the
    schedule exactly."""
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        at = f"{what} step {k}"
        for key in ("all_shooting", "appended", "popped"):
            assert g[key] == w[key], (at, key)
        for key in ("times", "contacts", "status"):
            np.testing.assert_array_equal(g["out"][key], w["out"][key],
                                          err_msg=f"{at} {key}")
        np.testing.assert_array_equal(g["out"]["scalars"][:, 4:],
                                      w["out"]["scalars"][:, 4:],
                                      err_msg=f"{at} n_iters/failed")
        for i, (gc, wc) in enumerate(zip(g["cmds"], w["cmds"])):
            at_i = f"{at} robot {i}"
            assert gc.N_mpcsteps == wc.N_mpcsteps
            for name, rtol, atol in (("hkd_controls", 1e-9, 1e-10),
                                     ("des_body_state", 1e-9, 1e-10),
                                     ("feedback", 1e-8, 1e-8),
                                     ("foot_placement", 1e-9, 1e-10)):
                np.testing.assert_allclose(
                    getattr(gc, name), getattr(wc, name), rtol=rtol,
                    atol=atol, err_msg=f"{at_i} {name}")
            ct_g, ct_w = g["out"]["cost_trace"][i], w["out"]["cost_trace"][i]
            np.testing.assert_array_equal(np.isnan(ct_g), np.isnan(ct_w))
            np.testing.assert_allclose(ct_g[~np.isnan(ct_g)],
                                       ct_w[~np.isnan(ct_w)], rtol=1e-9,
                                       err_msg=f"{at_i} cost trace")


def assert_fleet_states_match(got, want):
    """Warm-start states (fleet_state) at tests/test_fleet.py:86-97's
    tolerances."""
    for name, atol in (("Xbar", 1e-10), ("Ubar", 1e-10),
                       ("al_lambda", 1e-12)):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9,
                                   atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the single-robot MPC
# ---------------------------------------------------------------------------

def solver_pair(ref_file, jopt=None, **cfg):
    """(JAX HKDMPCSolver, port HKDMPCSolver) from one gait file, one
    MPCConfig field set `cfg` and one option set (`jopt`, default
    HSDDPOption()), f64 on the CPU; each package gets its own config and
    option objects."""
    from hkdmpc_tpu.mpc import solver as jsolver
    jopt = jopt or HSDDPOption()
    js = jsolver.HKDMPCSolver(ref_file, config=jsolver.MPCConfig(**cfg),
                              dtype=jnp.float64)
    ts = tsolver.HKDMPCSolver(ref_file, config=tsolver.MPCConfig(**cfg),
                              dtype=F64, device="cpu")
    js.opt, ts.opt = jopt, port_option(jopt)
    return js, ts


def robot_meas(meas, i=0):
    """Robot i's measurements of each step of `fleet_meas`."""
    return [{k: v[i] for k, v in m.items()} for m in meas]


def result_record(res):
    """A solver's `last_result` (either package's, either step path) as
    host values: the four scalars, n_iters, solve_failed, the four traces."""
    f = lambda a: np.asarray(a.detach().cpu().numpy()
                             if isinstance(a, torch.Tensor) else a,
                             np.float64)
    rec = {k: float(f(getattr(res, k))) for k in
           ("cost", "dyn_feas", "max_tconstr", "max_pconstr")}
    rec["n_iters"] = int(f(res.n_iters))
    rec["solve_failed"] = bool(f(res.solve_failed))
    for k in ("cost_trace", "feas_trace", "eqn_trace", "ineq_trace"):
        rec[k] = f(getattr(res, k))
    return rec


def step_solver(solver, meas, first, count):
    """Update an HKDMPCSolver (either package's) through
    meas[first:first+count] with mpc_time = 0.01 k; per update, the
    MPCCommand, the result record and all_shooting()."""
    recs = []
    for k in range(first, first + count):
        m = meas[k]
        cmd = solver.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                            mpc_time=0.01 * k)
        recs.append(dict(cmd=cmd, res=result_record(solver.last_result),
                         all_shooting=solver.problem.all_shooting()))
    return recs


CMD_TOLS = (("hkd_controls", 1e-9, 1e-10), ("des_body_state", 1e-9, 1e-10),
            ("feedback", 1e-8, 1e-8), ("foot_placement", 1e-9, 1e-10))


def assert_commands_match(got, want, what="", tols=CMD_TOLS):
    """Every field of an MPCCommand but solve_time: the schedule fields
    exactly, the rest at `tols` (name, rtol, atol), by default those of
    tests/test_fleet.py:66-97."""
    assert got.N_mpcsteps == want.N_mpcsteps, what
    for name in ("mpc_times", "contacts", "status_times"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=f"{what} {name}")
    for name, rtol, atol in tols:
        g, w = getattr(got, name), getattr(want, name)
        assert np.shape(g) == np.shape(w), (what, name)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def assert_results_match(got, want, what="", rtol=1e-9):
    """Result records: n_iters, solve_failed and the traces' lengths
    exactly, scalars and trace entries at rtol (atol 1e-12)."""
    assert got["n_iters"] == want["n_iters"], what
    assert got["solve_failed"] == want["solve_failed"], what
    for k, w in want.items():
        g = got[k]
        if k.endswith("_trace"):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                          err_msg=f"{what} {k} length")
            g, w = np.nan_to_num(g), np.nan_to_num(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-12,
                                   err_msg=f"{what} {k}")


def assert_solver_steps_match(got, want, what="", tols=CMD_TOLS, rtol=1e-9):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g["all_shooting"] == w["all_shooting"], (what, k)
        assert_commands_match(g["cmd"], w["cmd"], f"{what} update {k}", tols)
        assert_results_match(g["res"], w["res"], f"{what} update {k}", rtol)


PHASE_ARRAYS = ("Xbar", "Ubar", "dU", "K", "dX", "defect_bar", "reb_delta",
                "reb_eps", "al_lambda", "al_sigma")


def phase_arrays(problem):
    """The per-phase warm-start arrays of an HKDProblem (either package's),
    one dict per phase."""
    return [dict(uid=ph.uid, horizon=ph.horizon,
                 **{n: np.array(getattr(ph, n), np.float64)
                    for n in PHASE_ARRAYS}) for ph in problem.phases]


def assert_phase_arrays_match(got, want, rtol=1e-9, atol=1e-10):
    assert [p["horizon"] for p in got] == [p["horizon"] for p in want]
    for i, (g, w) in enumerate(zip(got, want)):
        for n in PHASE_ARRAYS:
            np.testing.assert_allclose(
                g[n], w[n], rtol=rtol, atol=atol if n != "K" else 1e-8,
                err_msg=f"phase {i} {n}")


# ---------------------------------------------------------------------------
# the host-read guard of the capturable bodies' tests
# ---------------------------------------------------------------------------
#
# Inside `no_host_reads()`, every way a tensor's value reaches the host
# (`Tensor.__bool__`, `__int__`, `__float__`, `.item`, `.tolist`, `.cpu`,
# `.numpy`) and every tensor made from host data (`torch.tensor`, and
# `torch.as_tensor` of anything but a tensor) raises `HostRead`. On the card
# each of them is a stream synchronization or a pageable copy, which a CUDA
# graph capture refuses; on the CPU the guard finds them first.


class HostRead(RuntimeError):
    pass


def _refuse(what):
    def call(*args, **kwargs):
        raise HostRead(f"{what} inside a body that a CUDA graph captures")
    return call


@contextlib.contextmanager
def no_host_reads():
    saved_methods = {name: getattr(torch.Tensor, name)
                     for name in ("__bool__", "__int__", "__float__", "item",
                                  "tolist", "cpu", "numpy")}
    saved_tensor, saved_as_tensor = torch.tensor, torch.as_tensor

    def as_tensor(data, *args, **kwargs):
        if isinstance(data, torch.Tensor):
            return saved_as_tensor(data, *args, **kwargs)
        raise HostRead("torch.as_tensor of host data inside a body that a "
                       "CUDA graph captures")

    try:
        for name in saved_methods:
            setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
        torch.tensor = _refuse("torch.tensor")
        torch.as_tensor = as_tensor
        yield
    finally:
        for name, fn in saved_methods.items():
            setattr(torch.Tensor, name, fn)
        torch.tensor, torch.as_tensor = saved_tensor, saved_as_tensor


def drive(prog):
    """A device program's pieces (`graphs.Program`) as its graph runs them:
    one warm-up run of each piece outside the guard (as a capture has),
    then the program's order with every piece under `no_host_reads` and
    each loop's flag read on the host between pieces."""
    prog.warm_up()
    prog.run_on_host(guard=no_host_reads)
    return prog


def program_solve(prob, state, opt, unroll_caps, **flags):
    """`ddp.solve_batch`'s device program driven on the host (`drive`) on
    copies of prob and state. Returns (a copy of its SolveResult, the
    program)."""
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.solver.structs import tree_map
    full = dict(kernel_jac=True, model=None, parallel_rollout=True,
                assoc_linear=False, assoc_backward=False,
                scan_backward=False, aug_sweep=True, jvp_linear=False)
    full.update(flags)
    prog = graphs.SolveProgram(tree_map(torch.clone, prob),
                               tree_map(torch.clone, state), opt, full,
                               unroll_caps)
    drive(prog)
    return tree_map(torch.clone, prog.result()), prog


def program_step(tables, state, ints, floats, meas, opt, parallel_rollout,
                 n_cmd, unroll_caps, **flags):
    """`fused.fleet_step`'s device program (`graphs.StepProgram`) driven on
    the host (`drive`) on a copy of `state` as the resident state it writes
    over; ints, floats, meas are tensors. Returns (the new state, the
    bundle)."""
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.solver.structs import tree_map
    full = dict(kernel_jac=False, model=None,
                parallel_rollout=parallel_rollout and bool(opt.MS),
                assoc_linear=False, assoc_backward=False)
    full.update(flags)
    resident = tree_map(torch.clone, state)
    prog = graphs.StepProgram(tables, resident, (ints, floats, meas), opt,
                              n_cmd, full, unroll_caps)
    drive(prog)
    return resident, prog.bundle.clone()
