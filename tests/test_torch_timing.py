"""Port parity: `hkdmpc_tpu_torch.utils.timing` (`StageTimer`,
`profile_solve`) against the JAX package's `utils/timing.py`, float64 on the
CPU: the stage-by-stage loop at B = 1 for two iterations from the trot's
cold start (plan 0.2 s) ends at the JAX loop's Xbar, Ubar and dU at 1e-9,
fills all four stage buckets and counts the same backward sweeps."""
import numpy as np
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.utils import timing as jtiming
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.solver.structs import tree_map
from hkdmpc_tpu_torch.utils import timing
from tests._torch_twin import assert_close, port_option, problem_pair

torch.set_num_threads(2)

BUCKETS = ("time_partial_ms", "time_bws_ms", "time_fit_ms",
           "time_rollout_ms")


def test_profile_solve_matches_jax_at_batch_one(tmp_path, capsys):
    jpb, tpb = problem_pair("trot", 0.2, tmp_path)
    x0 = default_stand_state(tpb.phases[0].contact)
    jprob, jstate = jpb.build(x0)
    prob, state = tpb.build(x0)
    jopt = HSDDPOption()

    jtimer, timer = jtiming.StageTimer(), timing.StageTimer()
    want = jtiming.profile_solve(jprob, jstate, jopt, jtimer, max_iters=2)
    got = timing.profile_solve(tree_map(lambda a: a[None], prob),
                               tree_map(lambda a: a[None], state),
                               port_option(jopt), timer, max_iters=2)

    for name in ("Xbar", "Ubar", "dU"):
        g = getattr(got, name)
        assert g.shape[0] == 1 and bool(torch.isfinite(g).all()), name
        assert_close(g[0], np.asarray(getattr(want, name)), 1e-9, name)

    s, js = timer.summary(), jtimer.summary()
    assert s["iterations"] == js["iterations"] == 2
    for k in BUCKETS:
        assert s[k] > 0.0, (k, s)
    assert ([r.n_bws for r in timer.records]
            == [r.n_bws for r in jtimer.records] == [1, 1])
    assert [r.ddp_iter for r in timer.records] == [1, 2]
    timer.print_summary()
    assert "over 2 iterations" in capsys.readouterr().out


def test_line_search_keeps_the_best_candidate_per_scenario(tmp_path):
    """Two scenarios of one batch (one at the stand pose, one moved): each
    ends where a profile of that scenario alone ends, so the line search
    picks per scenario."""
    _, tpb = problem_pair("trot", 0.2, tmp_path)
    opt = port_option(HSDDPOption())
    x0 = default_stand_state(tpb.phases[0].contact)
    prob, state = tpb.build(x0)
    noise = np.zeros((2, 24))
    noise[1, 3:6] = [0.02, -0.01, 0.015]
    prob2 = tree_map(lambda a: torch.stack([a, a]), prob)
    prob2.x0 = prob2.x0 + torch.as_tensor(noise)
    state2 = tree_map(lambda a: torch.stack([a, a]), state)
    both = timing.profile_solve(prob2, state2, opt, timing.StageTimer(),
                                max_iters=2)
    for b in range(2):
        one = timing.profile_solve(tree_map(lambda a: a[b:b + 1], prob2),
                                   tree_map(lambda a: a[b:b + 1], state2),
                                   opt, timing.StageTimer(), max_iters=2)
        for name in ("Xbar", "Ubar", "dU"):
            assert_close(getattr(both, name)[b], getattr(one, name)[0]
                         .numpy(), 1e-12, f"{name} scenario {b}")
