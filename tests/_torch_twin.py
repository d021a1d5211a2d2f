"""Shared fixtures of the PyTorch-port parity tests (`test_torch_*.py`): the
in-repo trot workload built by the JAX package, scenario batches made from
numpy noise, and the carry of structs between the two packages as numpy
arrays. Both packages run on the CPU in float64 (tests/conftest.py pins JAX
to CPU f64)."""

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
from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.parallel.batch import default_x0_scale
from hkdmpc_tpu_torch.solver import model_api, structs as tstructs

F64 = torch.float64

# the in-repo model specs, by name: swing_constraint of hkd_model_spec
SPECS = {"default": False, "swing": True}


def specs(name):
    """(JAX ModelSpec, port ModelSpec) of the named in-repo spec."""
    swing = SPECS[name]
    return (jmodel_api.hkd_model_spec(swing_constraint=swing),
            model_api.hkd_model_spec(swing_constraint=swing))


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
    body[5] = workload.BODY_HEIGHT0
    qd = hkd.compute_hkd_state(
        jnp.array(body[:3]), jnp.array(body[3:6]),
        jnp.array(np.tile(workload.QLEG0, 4)),
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
    the same arrays for both packages — and the option set. model: a JAX
    ModelSpec (it sizes the constraint rows)."""
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
    if model is None:
        got = ddp.solve_batch(prob, state, opt.runtime(), kernel_jac=True)
        want = jddp.solve_batch(jprob, jstate, opt.runtime(), kernel_jac=True,
                                **jflags)
    else:
        got = ddp.solve_batch(prob, state, opt.runtime(), kernel_jac=False,
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
