"""The device programs on a CUDA device (`solver/graphs.py`: the solve's and
the steps' pieces assembled by `csrc/graph_while.cu`, the retry loop of
every backward sweep a conditional while node): each equals its eager body
bit for bit, on inputs that need no retry and on inputs whose first sweep
fails for some rows (a negative ReB weight: one row is retried, two fail
past REG_MAX), with the retries the program ran equal to the eager body's;
and a step replay reads nothing on the host. Skipped without a card. This
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_retry_gpu.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import backward, ddp
from hkdmpc_tpu_torch.solver.structs import tree_map
from hkdmpc_tpu_torch.workload import trot_problem

pytestmark = pytest.mark.gpu

# per-lane scale of the ReB weight: no retry, retries, a failure past
# REG_MAX (the pattern repeats over the batch)
REB_SCALE = (1.0, -1e-3, -0.1, -100.0)
ROUTES = {"K1": dict(kernel_jac=True),
          "K2": dict(kernel_jac=False),
          "assoc": dict(kernel_jac=False, assoc_linear=True,
                        assoc_backward=True),
          "scan": dict(kernel_jac=False, scan_backward=True)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device programs have no CPU "
                    "mode")
    return torch.device("cuda")


def _batch(nb, device, forced=False, seed=6):
    _, prob, state, opt = trot_problem(dtype=torch.float32, device=device)
    prob, state = replicate_problem(prob, state, nb)
    prob = perturb_scenarios(prob, noise=np.random.default_rng(
        seed).standard_normal((nb, 24)))
    if forced:
        scale = torch.tensor(REB_SCALE * (nb // len(REB_SCALE)),
                             device=device)[:, None, None]
        state = dataclasses.replace(state, constr=dataclasses.replace(
            state.constr, reb_eps=state.constr.reb_eps * scale))
    return prob, state, opt


def _assert_same(a, b):
    from hkdmpc_tpu_torch.solver.graphs import leaves
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


def _eager_and_graph(prob, state, opt, unroll_caps, flags):
    """(eager result, its retry sweeps, graph result, the graph's retries in
    its last replay), the graph replayed twice."""
    from hkdmpc_tpu_torch.solver import graphs
    r0 = backward.RETRY_SWEEPS
    eager = ddp._solve_batch(prob, state, opt, unroll_caps=unroll_caps,
                             **flags)
    retries = backward.RETRY_SWEEPS - r0
    ddp.solve_batch(prob, state, opt, unroll_caps=unroll_caps, **flags)
    graph = ddp.solve_batch(prob, state, opt, unroll_caps=unroll_caps,
                            **flags)
    head = "solve_batch(B=" if unroll_caps else "solve_while(B="
    st = [s for s in graphs.stats() if s["label"].startswith(head + str(
        prob.kind.shape[0]) + ",") and s["replays"]]
    return eager, retries, graph, st[-1]["retries"]


@pytest.mark.parametrize("unroll_caps", [True, False],
                         ids=["unrolled", "while"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_program_equals_eager_body(cuda, route, unroll_caps):
    """Each route's solve, unrolled caps and the loops that stop: the
    program's result equals the eager body's bit for bit, and it ran the
    eager body's retries."""
    prob, state, opt = _batch(12, cuda)
    opt = opt.runtime() if unroll_caps else opt
    eager, retries, graph, ran = _eager_and_graph(prob, state, opt,
                                                  unroll_caps, ROUTES[route])
    _assert_same(graph, eager)
    assert ran == retries


@pytest.mark.parametrize("unroll_caps", [True, False],
                         ids=["unrolled", "while"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_forced_retries_equal_eager_body(cuda, route, unroll_caps):
    """Rows whose first sweep is not PSD: retried rows, rows that fail past
    REG_MAX, and rows that need nothing, in one program, bit for bit the
    eager body's, with the same retries."""
    prob, state, opt = _batch(8, cuda, forced=True)
    opt = opt.runtime() if unroll_caps else opt
    eager, retries, graph, ran = _eager_and_graph(prob, state, opt,
                                                  unroll_caps, ROUTES[route])
    _assert_same(graph, eager)
    assert ran == retries > 0
    failed = eager.solve_failed.tolist()
    assert failed[3] and not failed[0]


@contextlib.contextmanager
def _no_device_reads():
    """Every way a CUDA tensor's value reaches the host, and every
    synchronize, raises inside."""
    class DeviceRead(RuntimeError):
        pass

    def refuse(name, fn):
        def call(self, *args, **kwargs):
            if self.is_cuda:
                raise DeviceRead(f"Tensor.{name} of a CUDA tensor")
            return fn(self, *args, **kwargs)
        return call

    names = ("__bool__", "__int__", "__float__", "item", "tolist", "cpu",
             "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    saved_sync = torch.cuda.synchronize

    def sync(*args, **kwargs):
        raise DeviceRead("torch.cuda.synchronize")

    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(n, saved[n]))
        torch.cuda.synchronize = sync
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        torch.cuda.synchronize = saved_sync


STEPS = 6   # the trot's steps 2-4 take the sequential rollout


@pytest.mark.parametrize("unroll_caps", [True, False],
                         ids=["unrolled", "while"])
def test_step_replay_reads_nothing(cuda, tmp_path, unroll_caps):
    """The single robot's fused step (K2 at B = 1) and the fleet's (K1,
    8 robots): once the steps of both rollout kinds have built their
    programs, and after a reset (which keeps the resident buffers, so the
    programs replay), a step reads no CUDA tensor on the host and
    synchronizes nothing from `fused_step`'s call to its return; the
    updates complete with finite commands."""
    from hkdmpc_tpu_torch.mpc import fused
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    ref = gait_file("trot", str(tmp_path))
    s = HKDMPCSolver(ref, config=MPCConfig(fused_step=True,
                                           assoc_linear=False,
                                           assoc_backward=False),
                     dtype=torch.float32, device="cuda")
    stream = meas_stream(1, 5)
    m = lambda k: {n: v[0] for n, v in stream(k).items()}
    real = fused.fused_step
    guard = [contextlib.nullcontext]

    def step(*args, **kwargs):
        kwargs["unroll_caps"] = unroll_caps
        with guard[0]():
            return real(*args, **kwargs)

    fused.fused_step = step
    try:
        for guarded in (False, True):
            s.initialize()
            held = len(graphs.stats())
            guard[0] = _no_device_reads if guarded else contextlib.nullcontext
            for k in range(STEPS):
                d = m(k)
                cmd = s.update(d["rpy"], d["p"], d["v"], d["omega"],
                               d["qJ"])
                assert np.isfinite(cmd.hkd_controls).all()
            assert not guarded or len(graphs.stats()) == held
    finally:
        fused.fused_step = real
    s.close()

    f = FleetMPC(ref, 8, config=FleetConfig(unroll_caps=unroll_caps),
                 dtype=torch.float32, device="cuda")
    fstream = meas_stream(8, 3)
    real_step = fused.fleet_step

    def guarded_step(*args, **kwargs):
        with _no_device_reads():
            return real_step(*args, **kwargs)

    for guarded in (False, True):
        f.initialize()
        for k in range(STEPS):
            d = fstream(k)
            if guarded:
                fused.fleet_step = guarded_step
            try:
                f.step_async(d["rpy"], d["p"], d["v"], d["omega"], d["qJ"])
            finally:
                fused.fleet_step = real_step
            out = f.complete()
            assert np.isfinite(out["controls"]).all()


def test_step_model_keyword_equals_eager_body(cuda, tmp_path):
    """`fleet_step(model=...)` with the swing-constraint model on the
    dense path, both forms: the program equals the eager step bit for
    bit, and kernel_jac=True with a model raises."""
    from hkdmpc_tpu_torch.mpc import fused
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    from hkdmpc_tpu_torch.solver.problem import HKDProblem
    from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
    from hkdmpc_tpu_torch.mpc.solver import default_stand_state
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    spec = hkd_model_spec(swing_constraint=True)
    pb = HKDProblem(QuadReference.from_file(gait_file("trot", str(tmp_path))),
                    dtype=torch.float32, device="cuda", model=spec)
    pb.initialization()
    _, state = pb.build(default_stand_state(pb.phases[0].contact))
    n, n_cmd = 4, 8
    state_b = tree_map(lambda a: a[None].repeat(
        (n,) + (1,) * a.dim()).contiguous(), state)
    tables = fused.make_tables(pb, torch.float32, "cuda")
    ints, floats, _, _ = fused.host_step(pb, pb.flat_offsets(), 1, n_cmd,
                                         0.0, 0.01, np.float32)
    d = meas_stream(n, 2)(0)
    meas = np.stack([fused.pack_meas(
        np.float32, eul=d["rpy"][i, ::-1], p=d["p"][i], omega=d["omega"][i],
        v=d["v"][i], qJ=d["qJ"][i], front_contact=pb.phases[0].contact)
        for i in range(n)])
    opt = HSDDPOption().runtime()
    for unroll_caps in (True, False):
        kw = dict(model=spec, unroll_caps=unroll_caps)
        args = (ints, floats, meas, opt, pb.all_shooting(), n_cmd, False)
        want = fused.fleet_step_eager(tables, tree_map(torch.clone, state_b),
                                      *args, **kw)
        for _ in range(2):
            got = fused.fleet_step(tables, tree_map(torch.clone, state_b),
                                   *args, **kw)
            _assert_same(got, want)
    with pytest.raises(ValueError, match="kernel_jac=True"):
        fused.fleet_step(tables, state_b, ints, floats, meas, opt, True,
                         n_cmd, True, model=spec)
