"""The PyTorch port never imports JAX, nor any module of the JAX package
`hkdmpc_tpu` (not even one that is itself free of JAX: the port keeps its
own copy): in a fresh interpreter (the test
process has JAX loaded already), import every module of hkdmpc_tpu_torch,
build the trot problem and run one small batched solve on each path (the
default model's kernel_jac path, the dense path with the swing constraint),
step a small fleet and carry it through a checkpoint (`mpc.fleet`,
`mpc.fused`, `utils.checkpoint`), initialize and update the single-robot
solver on both step paths with the parallel-in-time recursions
(`mpc.solver`, `ops.assoc`), serve three requests through the MPC service
(`comm`, `mpc.runtime`), run the utilities (`utils.logging`, `utils.timing`,
`utils.visualize`), the AD Jacobians, the examples' loops, the recorder's
conversion and a world-size-1 gloo group (`parallel.batch.solve_sharded`,
`FleetMPC(mesh=)`), then check that neither `jax` nor `hkdmpc_tpu` (nor any
`hkdmpc_tpu.*`) is in sys.modules. A source scan refuses `import jax`,
`import hkdmpc_tpu` and `from hkdmpc_tpu...` in every module of the port and
in `chip_smoke.py`."""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import hkdmpc_tpu_torch
for m in pkgutil.walk_packages(hkdmpc_tpu_torch.__path__, "hkdmpc_tpu_torch."):
    importlib.import_module(m.name)
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import ddp
from hkdmpc_tpu_torch.workload import trot_problem
torch.set_num_threads(2)
_, prob, state, opt = trot_problem(dtype=torch.float64, device="cpu")
prob_b, state_b = replicate_problem(prob, state, 2)
prob_b = perturb_scenarios(prob_b, noise=np.random.default_rng(0).standard_normal((2, 24)))
res = ddp.solve_batch(prob_b, state_b, opt.runtime(), kernel_jac=True)
assert bool(torch.isfinite(res.cost).all())
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
spec = hkd_model_spec(swing_constraint=True)
_, prob, state, opt = trot_problem(dtype=torch.float64, device="cpu", model=spec)
prob_b, state_b = replicate_problem(prob, state, 2)
res = ddp.solve_batch(prob_b, state_b, opt.runtime(), kernel_jac=False, model=spec)
assert bool(torch.isfinite(res.cost).all())
import os, tempfile
from hkdmpc_tpu_torch.mpc import fleet, fused
from hkdmpc_tpu_torch.utils import checkpoint
from hkdmpc_tpu_torch.workload import gait_file, meas_stream
with tempfile.TemporaryDirectory() as d:
    cfg = fleet.FleetConfig(plan_duration=0.3)
    f = fleet.FleetMPC(gait_file("trot", d), 2, config=cfg,
                       dtype=torch.float64, device="cpu")
    assert f.initialize()["n_failed"] == 0
    f.rollout_steps(1, meas_stream(2, 0))
    f.save(os.path.join(d, "fleet.npz"))
    g = fleet.FleetMPC(gait_file("trot", d), 2, config=cfg,
                       dtype=torch.float64, device="cpu")
    g.resume(os.path.join(d, "fleet.npz"))
    m = meas_stream(2, 1)(0)
    out = g.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    assert np.isfinite(out["controls"]).all() and g.mpc_iter == 2
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    m = {k: v[0] for k, v in m.items()}
    for fused_on in (False, True):
        s = HKDMPCSolver(gait_file("trot", d), dtype=torch.float64,
                         device="cpu", config=MPCConfig(
                             plan_duration=0.3, fused_step=fused_on,
                             assoc_backward=True))
        assert np.isfinite(s.initialize().hkd_controls).all()
        cmd = s.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
        assert np.isfinite(cmd.feedback).all()
        assert not s.last_result.solve_failed
    # the MPC service: comm/ and mpc/runtime.py, three requests (an update,
    # a single-shooting reset, an update) over an in-memory transport
    import time
    from hkdmpc_tpu_torch import comm
    from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
    from hkdmpc_tpu_torch.mpc.runtime import MPCService
    from hkdmpc_tpu_torch.workload import lcmtypes_dir, mpc_data_message
    types = load_reference_types(lcmtypes_dir(os.path.join(d, "lcmtypes")))
    class Transport:
        def __init__(self, todo):
            self.todo, self.out = todo, []
        def subscribe(self, channel):
            pass
        def publish(self, channel, data):
            self.out.append((channel, data))
        def receive(self, timeout_ms=100):
            if self.todo:
                return "mpc_data", self.todo.pop(0)
            time.sleep(timeout_ms / 1e3)
    tx = Transport([types["hkd_data_lcmt"].encode(mpc_data_message(
        m, 0.01 * k, reset_mpc=(k == 1), MS=False)) for k in range(3)])
    svc = MPCService(s, tx, os.path.join(d, "lcmtypes"))
    svc.run(max_messages=3)
    assert [c for c, _ in tx.out] == ["mpc_command", "solver_info"] * 3
    cmd = types["hkd_command_lcmt"].decode(tx.out[-2][1])
    assert np.isfinite(cmd["hkd_controls"]).all() and not s.opt.MS
    assert types["solver_info_lcmt"].decode(tx.out[-1][1])["n_iter"] >= 1
    s.close()
    # the utilities, the AD Jacobians, the converters, scale-out at world
    # size 1 (gloo), the examples' loops and the recorder's conversion
    from hkdmpc_tpu_torch.examples.closed_loop_demo import closed_loop
    from hkdmpc_tpu_torch.examples.fleet_demo import fleet_loop
    from hkdmpc_tpu_torch.models import hkd
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig
    from hkdmpc_tpu_torch.parallel import batch
    from hkdmpc_tpu_torch.reference import refgen
    from hkdmpc_tpu_torch.scripts.record_motion import towr_msg_to_traj
    from hkdmpc_tpu_torch.utils import logging as ulog, timing, visualize
    x = torch.zeros(2, 24, dtype=torch.float64)
    A, B = hkd.dynamics_jacobians(x, x, torch.ones(2, 4, dtype=torch.float64), 0.01)
    assert A.shape == (2, 24, 24)
    run = closed_loop(gait_file("trot", d), 1, os.path.join(d, "logs"),
                      device="cpu", config=MPCConfig(plan_duration=0.3,
                                                     assoc_backward=False),
                      log=lambda *_: None)
    assert ulog.load_log(os.path.join(d, "logs", "state_log.txt")).shape[1] == 24
    visualize.publish_replay(run["solver"].problem.phases, tx, os.path.join(d, "lcmtypes"))
    assert tx.out[-1][0] == "visualize_mc_motion"
    from hkdmpc_tpu_torch.solver.structs import tree_map
    one = lambda a: a[None]
    prob, state = run["solver"].problem.build(np.zeros(24))
    timing.profile_solve(tree_map(one, prob), tree_map(one, state),
                         opt.runtime(), timing.StageTimer(), max_iters=1)
    fleet_loop(gait_file("trot", d), 2, 2, os.path.join(d, "fleet"), device="cpu",
               config=FleetConfig(plan_duration=0.3), log=lambda *_: None)
    g = refgen.GaitSynthesizer().synthesize((("trot", 0.3, 0.5),))
    towr_msg_to_traj({"len": 2, "microtime": [0, 10000],
                      "base_pos": [[0, 0, 0.27]] * 2, "base_vel": [[0, 0, 0]] * 2,
                      "eul": np.zeros((2, 3)), "eulrate": np.zeros((2, 3)),
                      "ee_pos": g["foot_placements"][:2], "contact": np.ones((2, 4))})
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    mesh = batch.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        _, prob, state, opt = trot_problem(dtype=torch.float64, device="cpu")
        prob_b, state_b = replicate_problem(prob, state, 2)
        res, agg = batch.solve_sharded(prob_b, state_b, opt.runtime(), mesh,
                                       kernel_jac=True)
        assert agg["n_failed"] == 0 and batch.host_local_batch(2) == 2
        f = fleet.FleetMPC(gait_file("trot", d), 2, config=cfg,
                           dtype=torch.float64, device="cpu", mesh=mesh)
        f.initialize()
        assert len(f.rollout_steps(2, meas_stream(2, 0), keep_bundles=True)) == 2
    finally:
        torch.distributed.destroy_process_group()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
reference_pkg = sorted(m for m in sys.modules
                       if m == "hkdmpc_tpu" or m.startswith("hkdmpc_tpu."))
assert not reference_pkg, reference_pkg
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout


FORBIDDEN_ROOTS = ("jax", "hkdmpc_tpu")


def imported_forbidden_root(line: str):
    """The forbidden top-level package an `import ...` / `from ... import`
    line names, or None (`hkdmpc_tpu_torch` is another package)."""
    words = line.replace(",", " ").split()
    if len(words) < 2 or words[0] not in ("import", "from"):
        return None
    names = words[1:2] if words[0] == "from" else [
        w for w in words[1:] if w != "as"]
    for name in names:
        if name.split(".")[0] in FORBIDDEN_ROOTS:
            return name.split(".")[0]
    return None


def port_sources():
    return sorted((REPO / "hkdmpc_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_sources_do_not_import_jax():
    for path in port_sources():
        for line in path.read_text().splitlines():
            assert imported_forbidden_root(line) is None, (path, line)


def test_source_scan_sees_an_import_of_the_jax_package():
    hits = {"import hkdmpc_tpu": "hkdmpc_tpu",
            "from hkdmpc_tpu.config import HSDDPOption": "hkdmpc_tpu",
            "    from hkdmpc_tpu import config": "hkdmpc_tpu",
            "import os, hkdmpc_tpu.config as c": "hkdmpc_tpu",
            "import jax.numpy as jnp": "jax",
            "from hkdmpc_tpu_torch.config import HSDDPOption": None,
            "import hkdmpc_tpu_torch": None,
            "# from hkdmpc_tpu.config import x": None}
    for line, root in hits.items():
        assert imported_forbidden_root(line) == root, line
