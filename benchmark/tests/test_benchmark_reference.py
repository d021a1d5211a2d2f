"""The frozen plain reference (`hkdref`) against the port at a tiny size on
the CPU, and the guard on what the benchmark imports."""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from hkdbench import reference, traffic
from hkdbench.harness import FORBIDDEN

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.fixture(scope="module")
def gait_dir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def _port_problem(path, plan_s, dtype):
    from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
    from hkdmpc_tpu_torch.solver.problem import HKDProblem
    pb = HKDProblem(QuadReference.from_file(path), plan_duration=plan_s,
                    dtype=dtype, device="cpu")
    pb.initialization()
    return pb


@pytest.mark.parametrize("gait", ["trot", "flytrot"])
def test_solve_matches_port(gait_dir, gait):
    """Three perturbed scenarios of the 0.6 s plan, runtime caps, float64:
    the reference's solve equals the port's eager solve."""
    from hkdmpc_tpu_torch.config import HSDDPOption
    from hkdmpc_tpu_torch.parallel.batch import replicate_problem
    from hkdmpc_tpu_torch.solver import ddp

    path = traffic.gait_file(gait_dir, gait, 2.0, 0.5)
    ref_pb = reference.problem(path, 0.6, 0.01)
    stand = reference.stand_state(ref_pb)
    pool = traffic.x0_pool(np.tile(stand, (3, 1)), 1, 2**31 + 7, "cpu",
                           torch.float64)[0].numpy()
    ref = reference.solve_rows(ref_pb, pool)

    pb = _port_problem(path, 0.6, torch.float64)
    prob, state = pb.build(stand)
    prob_b, state_b = replicate_problem(prob, state, 3)
    prob_b = dataclasses.replace(prob_b, x0=torch.as_tensor(pool))
    got = ddp.solve_batch(prob_b, state_b, HSDDPOption().runtime(),
                          kernel_jac=True)
    for a, b in ((got.state.Xbar, ref.state.Xbar),
                 (got.state.Ubar, ref.state.Ubar), (got.cost, ref.cost)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)
    assert not ref.solve_failed.any()


def test_fleet_tick_matches_port(gait_dir):
    """Four ticks of a two-robot fleet in float64: the reference's schedule
    and step, from the port's state before each tick, give the port's
    commands and state."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.solver.structs import tree_map

    path = traffic.gait_file(gait_dir, "trot", 2.0, 0.5)
    fleet = FleetMPC(path, 2, config=FleetConfig(kernel_jac=True),
                     dtype=torch.float64, device="cpu")
    fleet.initialize()
    sched = reference.FleetSchedule(path, 0.6, 0.01, 8)
    plan = traffic.plan_body(path)
    for k in range(4):
        before = tree_map(lambda a: a.clone(), fleet._state_dev)
        m = traffic.measurements(2, 5, k, plan)
        out = fleet.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time=k * 0.01)
        rec = sched.advance()
        assert rec["all_shooting"] == fleet.problem.all_shooting()
        new, ref = sched.step(rec, before, sched.meas_pack(
            m, np.arange(2), rec["front_contact"]))
        for key in ("controls", "body", "gains"):
            np.testing.assert_allclose(out[key], ref[key], rtol=1e-12,
                                       atol=1e-12)
        np.testing.assert_allclose(fleet._state_dev.Xbar.numpy(),
                                   new.Xbar.numpy(), rtol=1e-12, atol=1e-12)


def _loaded(code: str) -> set:
    """Top-level names of the modules loaded after running `code` in a
    fresh interpreter with the checkout and benchmark/ on the path."""
    prog = (f"import sys; sys.path[:0] = [{ROOT!r}, {BENCH!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(out.stdout.split())


def test_benchmark_imports_no_jax():
    """Every module a run loads (the harness, both drivers, every metric
    reader, the program's modules they reach) leaves JAX, Flax and the JAX
    package out, compared by whole top-level names."""
    code = ("from hkdbench import harness, layout\n"
            "import glob, os\n"
            f"cell = layout.load_cell('trot_t75.fleet_n1024')\n"
            f"for d in glob.glob(os.path.join({BENCH!r}, 'drivers', '*.py')):\n"
            "    cell.traffic['driver'] = os.path.basename(d)[:-3]\n"
            "    layout.driver(cell)\n"
            f"for m in glob.glob(os.path.join({BENCH!r}, 'metrics', '*.py')):\n"
            "    layout.reader(cell, os.path.basename(m)[:-3])\n")
    names = _loaded(code)
    assert "hkdmpc_tpu_torch" in names        # the program is loaded ...
    assert not names & set(FORBIDDEN)        # ... and nothing of JAX


def test_reference_imports_nothing_of_the_program():
    """The reference side (hkdref, hkdbench.reference, the traffic
    generators, the roofline count) loads neither the port nor JAX."""
    code = ("import hkdbench.reference, hkdbench.traffic, "
            "hkdbench.roofline, hkdbench.checks\n"
            "import hkdref.solver.ddp, hkdref.mpc.fused\n")
    names = _loaded(code)
    assert not names & (set(FORBIDDEN) | {"hkdmpc_tpu_torch"})


def test_reference_sources_name_no_program_module():
    """No source of hkdref imports the port, the JAX package or JAX."""
    bad = []
    for dirpath, _, files in os.walk(os.path.join(BENCH, "hkdref")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for name in FORBIDDEN + ("hkdmpc_tpu_torch",):
                    if (f"import {name}" in text
                            or f"from {name}" in text):
                        bad.append((f, name))
    assert not bad
