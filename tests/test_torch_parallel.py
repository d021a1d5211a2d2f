"""Port parity: scale-out on `torch.distributed` (`parallel/batch.py`:
`init_multihost`, `make_mesh`, `host_local_batch`, `solve_sharded`; the
sharded `FleetMPC(mesh=)`; `rollout_steps(keep_bundles=)`), float64 on the
CPU with the gloo backend.

Two processes of this file (`python tests/test_torch_parallel.py <rank> 2
<port> <dir>`, started once for the module with a free port and a 300 s
limit) join one gloo group and:
- solve an 8-scenario perturbed trot (plan 0.2 s) with `solve_sharded` on
  the throughput path, 4 scenarios each: the union of their costs and Ubar
  equals JAX `solve_sharded` on a 2-device CPU mesh at 1e-10, and the
  aggregates are equal on both ranks and to JAX's at 1e-8 (the analog of
  tests/test_parallel.py:26 and :91);
- step a 4-robot `FleetMPC(mesh=)` (2 robots each) from its cold solve for
  4 steps: each rank's rows equal the port's unsharded fleet at 1e-10.
The rest runs in this process: `make_mesh` without a group raises, a world
size that does not divide n_robots raises, a shard's checkpoint refuses
another rank's rows, and `keep_bundles=True` returns the bundles of stepwise
`complete()`.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.parallel import batch
from hkdmpc_tpu_torch.solver import structs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
BATCH = 8
SEED = 7
PLAN = 0.2
FLEET_N = 4
FLEET_STEPS = 4
FLEET_CFG = dict(plan_duration=0.3, kernel_jac=True)
TIMEOUT_S = 300


def _fleet(ref, mesh=None, n=FLEET_N):
    return FleetMPC(ref, n, config=FleetConfig(**FLEET_CFG),
                    dtype=torch.float64, device="cpu", mesh=mesh)


def _step_fleet(fleet, n_steps):
    """Step from the cold solve through n_steps steps of
    workload.meas_stream(FLEET_N, 0); per step the unpacked bundle and the
    commands of the fleet's (local) robots."""
    init = fleet.initialize()
    stream = workload.meas_stream(FLEET_N, 0)
    steps = []
    for k in range(n_steps):
        m = stream(k)
        out = fleet.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time=0.01 * k)
        steps.append({name: np.asarray(out[name]) for name in
                      ("controls", "body", "gains", "scalars", "cost_trace",
                       "foot_placement")})
    return init, steps


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _worker(rank, world, port, directory):
    torch.set_num_threads(2)
    rank, world = int(rank), int(world)
    mesh = batch.init_multihost(f"127.0.0.1:{port}", world, rank,
                                device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "backend": "gloo",
           "local_batch": batch.host_local_batch(BATCH)}
    try:
        with np.load(os.path.join(directory, "batch.npz")) as data:
            trees = {"prob": {}, "state": {"constr": {}}}
            for key in data.files:
                *path, name = key.split("/")
                node = trees
                for p in path:
                    node = node[p]
                node[name] = data[key]
        prob = structs.from_numpy(trees["prob"], "cpu", torch.float64)
        state = structs.from_numpy(trees["state"], "cpu", torch.float64)
        res, agg = batch.solve_sharded(prob, state, HSDDPOption().runtime(),
                                       mesh, kernel_jac=True,
                                       parallel_rollout=True)
        out["agg"] = agg
        arrays = {"cost": res.cost.numpy(), "Ubar": res.state.Ubar.numpy(),
                  "dyn_feas": res.dyn_feas.numpy()}

        os.makedirs(os.path.join(directory, f"rank{rank}"))
        ref = workload.gait_file("trot", os.path.join(directory, f"rank{rank}"))
        init, steps = _step_fleet(_fleet(ref, mesh), FLEET_STEPS)
        out["fleet_init"] = init
        for k, st in enumerate(steps):
            for name, a in st.items():
                arrays[f"fleet{k}_{name}"] = a
        np.savez(os.path.join(directory, f"rank{rank}.npz"), **arrays)
    finally:
        torch.distributed.destroy_process_group()
    print("RANK_RESULT " + json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks():
    """Start the two ranks on the 8-scenario batch (the arrays the JAX side
    solves, written by this process) and return a function that waits for
    them and gives (per-rank results, per-rank arrays, the batch, option)."""
    from tests._torch_twin import batched_trot

    d = tempfile.mkdtemp(prefix="hkdmpc_ranks_")
    prob_n, state_n, jopt = batched_trot(BATCH, SEED, PLAN)
    flat = {}

    def put(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}/", v)
            else:
                flat[prefix + k] = np.asarray(v)
    put("prob/", prob_n)
    put("state/", state_n)
    np.savez(os.path.join(d, "batch.npz"), **flat)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(port), d], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    cache = {}

    def collect():
        if not cache:
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                pytest.fail(f"the ranks did not finish in {TIMEOUT_S} s")
            results, arrays = [], []
            for r, (p, text) in enumerate(zip(procs, outs)):
                assert p.returncode == 0, text[-3000:]
                line = [l for l in text.splitlines()
                        if l.startswith("RANK_RESULT ")]
                assert line, text[-3000:]
                results.append(json.loads(line[0][len("RANK_RESULT "):]))
                with np.load(os.path.join(d, f"rank{r}.npz")) as data:
                    arrays.append(dict(data))
            cache.update(results=results, arrays=arrays)
        return cache["results"], cache["arrays"]

    yield dict(collect=collect, prob=prob_n, state=state_n, jopt=jopt)
    for p in procs:
        if p.poll() is None:
            p.kill()


def test_two_gloo_ranks_match_jax_solve_sharded(two_ranks):
    import jax
    import jax.numpy as jnp
    from hkdmpc_tpu.parallel import make_mesh as jmake_mesh
    from hkdmpc_tpu.parallel import solve_sharded as jsolve_sharded
    from hkdmpc_tpu.solver import structs as jstructs
    from tests._torch_twin import jax_struct

    jprob = jax_struct(jstructs.ProblemData, two_ranks["prob"])
    jstate = jax_struct(jstructs.SolverState, two_ranks["state"])
    want, jagg = jsolve_sharded(
        jprob, jstate, two_ranks["jopt"].runtime(),
        jmake_mesh(jax.devices()[:WORLD]), parallel_rollout=True,
        kernel_jac=True, unroll_caps=True)
    want_cost = np.asarray(want.cost)

    results, arrays = two_ranks["collect"]()
    assert [r["rank"] for r in results] == list(range(WORLD))
    assert all(r["size"] == WORLD and r["local_batch"] == BATCH // WORLD
               for r in results)
    cost = np.concatenate([a["cost"] for a in arrays])
    Ubar = np.concatenate([a["Ubar"] for a in arrays])
    np.testing.assert_allclose(cost, want_cost, rtol=1e-10)
    np.testing.assert_allclose(Ubar, np.asarray(want.state.Ubar), atol=1e-10)
    np.testing.assert_allclose(
        np.concatenate([a["dyn_feas"] for a in arrays]),
        np.asarray(want.dyn_feas), rtol=1e-8, atol=1e-12)

    for key in ("mean_cost", "max_tconstr", "max_feas", "n_failed"):
        got = [r["agg"][key] for r in results]
        assert got[0] == got[1], key
        assert abs(got[0] - float(jagg[key])) < 1e-8, (key, got, jagg[key])
    # the aggregates are the host reductions of the union
    assert abs(results[0]["agg"]["mean_cost"] - cost.mean()) < 1e-8
    assert results[0]["agg"]["n_failed"] == int(np.sum(
        np.asarray(want.solve_failed)))
    assert not np.any(np.asarray(jnp.asarray(want.solve_failed)))


def test_sharded_fleet_matches_unsharded(two_ranks, tmp_path):
    torch.set_num_threads(2)
    init, steps = _step_fleet(_fleet(workload.gait_file("trot", tmp_path)),
                              FLEET_STEPS)
    results, arrays = two_ranks["collect"]()
    for key in ("mean_cost", "max_tconstr", "max_feas", "n_failed"):
        for r in results:
            assert abs(r["fleet_init"][key] - init[key]) <= 1e-10 * max(
                1.0, abs(init[key])), key
    for k, want in enumerate(steps):
        for name, w in want.items():
            got = np.concatenate([a[f"fleet{k}_{name}"] for a in arrays])
            assert got.shape == w.shape, (k, name)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(w))
            np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(w),
                                       rtol=1e-10, atol=1e-10,
                                       err_msg=f"step {k} {name}")


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_multihost"):
        batch.make_mesh()


def test_mesh_size_must_divide_the_fleet(tmp_path):
    mesh = batch.Mesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    ref = workload.gait_file("trot", tmp_path)
    with pytest.raises(ValueError, match="do not split"):
        _fleet(ref, mesh)
    with pytest.raises(ValueError, match="do not split"):
        batch.local_block(8, mesh)
    assert _fleet(ref, mesh, n=6).rows == slice(0, 2)
    assert batch.local_block(6, batch.Mesh(None, 2, 3, torch.device(
        "cpu"))) == slice(4, 6)


def test_sharded_fleet_checkpoint_holds_its_rows(tmp_path):
    """A shard's file records its rows: another rank, or a fleet of another
    size, refuses it; a shard takes its rows from the whole fleet's file and
    steps on as the whole fleet does."""
    torch.set_num_threads(2)
    ref = workload.gait_file("trot", tmp_path)
    stream = workload.meas_stream(FLEET_N, 0)
    full = _fleet(ref)
    full.initialize()
    m = stream(0)
    full.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    full.save(str(tmp_path / "full.npz"))
    shards = [_fleet(ref, batch.Mesh(None, r, WORLD, torch.device("cpu")))
              for r in range(WORLD)]
    for r, shard in enumerate(shards):
        shard.resume(str(tmp_path / "full.npz"))
        np.testing.assert_array_equal(shard._state_dev.Ubar.numpy(),
                                      full._state_dev.Ubar[shard.rows].numpy())
        shard.save(str(tmp_path / f"shard{r}.npz"))
    with pytest.raises(ValueError, match="holds robots 0:2, this process "
                                         "owns 2:4"):
        shards[1].resume(str(tmp_path / "shard0.npz"))
    with pytest.raises(ValueError, match="holds robots 2:4"):
        full.resume(str(tmp_path / "shard1.npz"))
    with pytest.raises(ValueError, match="of 4 robots, the fleet has 2"):
        _fleet(ref, n=2).resume(str(tmp_path / "shard0.npz"))
    shards[1].resume(str(tmp_path / "shard1.npz"))
    m = stream(1)
    want = full.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                     mpc_time=0.01)
    got = shards[1].step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time=0.01)
    for name in ("controls", "gains", "foot_placement"):
        np.testing.assert_allclose(got[name], want[name][2:], rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_keep_bundles_returns_each_steps_bundle(tmp_path):
    torch.set_num_threads(2)
    ref = workload.gait_file("trot", tmp_path)
    n_steps = 3
    a, b = _fleet(ref, n=2), _fleet(ref, n=2)
    a.initialize()
    b.initialize()
    stream_a, stream_b = (workload.meas_stream(2, 1) for _ in range(2))
    bundles = a.rollout_steps(n_steps, stream_a, keep_bundles=True)
    assert isinstance(bundles, list) and len(bundles) == n_steps
    for k, bundle in enumerate(bundles):
        m = stream_b(k)
        want = b.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                      mpc_time=0.01 * k)
        got = a.unpack(bundle)
        for name, g in got.items():
            np.testing.assert_array_equal(g, want[name], err_msg=f"{k} {name}")
    last = a.rollout_steps(1, stream_a)
    assert isinstance(last, torch.Tensor) and last.shape[0] == 2


if __name__ == "__main__":
    _worker(*sys.argv[1:])
