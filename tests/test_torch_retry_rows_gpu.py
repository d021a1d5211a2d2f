"""`backward.RETRY_ROWS` in the device programs on a CUDA device: at the
2.0 s plan (T = 250, B = 256, the benchmark cell `trot_t250.sweep_b256`'s
shape) a replay of the solve's program folds the rows and sweeps its
retries ran, equal to its eager body's, on the bench's drawn scenarios
and on rows forced to retry (a negative ReB weight); and at T = 75, B =
4096 a replay that runs no retry runs the 707 nodes it ran before the
count was kept (the tally's nodes sit in the retry piece). Skipped
without a card. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_retry_rows_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch import bench
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import backward, ddp
from hkdmpc_tpu_torch.workload import trot_problem

pytestmark = pytest.mark.gpu

REB_SCALE = (1.0, -1e-3, -0.1, -100.0)
NODES_T75 = 707       # nodes of a trot replay at T = 75 with no retry


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device programs have no CPU "
                    "mode")
    return torch.device("cuda")


def _counts():
    return backward.RETRY_ROWS, backward.RETRY_SWEEPS


def _gained(before):
    torch.cuda.synchronize()
    return tuple(b - a for a, b in zip(before, _counts()))


def _last_stats(nb, T):
    from hkdmpc_tpu_torch.solver import graphs
    head = f"solve_batch(B={nb}, T={T},"
    return [s for s in graphs.stats() if s["label"].startswith(head)
            and s["replays"]][-1]


@pytest.mark.parametrize("forced", [False, True], ids=["drawn", "forced"])
def test_t250_replay_folds_the_eager_count(cuda, forced):
    prob, state, opt = bench.scenarios("trot", 256, 0, cuda, 2.0)
    if forced:
        scale = torch.tensor(REB_SCALE * 64, device=cuda)[:, None, None]
        state = dataclasses.replace(state, constr=dataclasses.replace(
            state.constr, reb_eps=state.constr.reb_eps * scale))
    before = _counts()
    ddp._solve_batch(prob, state, opt, kernel_jac=True)
    eager = _gained(before)
    ddp.solve_batch(prob, state, opt, kernel_jac=True)   # build, replay
    before = _counts()
    ddp.solve_batch(prob, state, opt, kernel_jac=True)
    assert _gained(before) == eager
    rows, sweeps = eager
    st = _last_stats(256, prob.T)
    assert st["retries"] == sweeps
    print(f"T = {prob.T}, B = 256: {rows} rows in {sweeps} retry sweeps, "
          f"{st['nodes_run']} nodes run")
    if forced:
        assert rows > sweeps > 0
    assert rows >= sweeps


def test_replay_without_retries_runs_its_nodes(cuda):
    _, prob, state, opt = trot_problem(dtype=torch.float32, device=cuda)
    prob, state = replicate_problem(prob, state, 4096)
    prob = perturb_scenarios(prob, noise=np.random.default_rng(
        6).standard_normal((4096, 24)))
    opt = opt.runtime()
    ddp.solve_batch(prob, state, opt, kernel_jac=True)
    before = _counts()
    ddp.solve_batch(prob, state, opt, kernel_jac=True)
    assert _gained(before) == (0, 0)
    st = _last_stats(4096, prob.T)
    assert st["retries"] == 0 and st["pieces"]["retry"]["runs"] == 0
    assert st["nodes_run"] == NODES_T75
