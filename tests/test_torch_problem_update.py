"""The port's receding-horizon HKDProblem.update against the JAX package's:
40 updates of the in-repo trot and flytrot at plans 0.6 s and 0.3 s, with
the schedule, the flat layout, the shift descriptor and every warm-start
array of every phase exactly equal after each update (host numpy on both
sides, so equality is exact)."""
import numpy as np
import pytest

from tests._torch_twin import problem_pair

PHASE_ARRAYS = ("Xbar", "Ubar", "dU", "K", "dX", "defect_bar", "reb_delta",
                "reb_eps", "al_lambda", "al_sigma", "td_mask", "contact",
                "next_contact", "contact_duration")
PHASE_SCALARS = ("uid", "horizon", "start_time", "end_time", "reach_end",
                 "has_tconstr")
N_UPDATES = 40


def _assert_same(jpb, tpb, at):
    assert len(tpb.phases) == len(jpb.phases), at
    for jp, tp in zip(jpb.phases, tpb.phases):
        for name in PHASE_SCALARS:
            assert getattr(tp, name) == getattr(jp, name), (at, name)
        for name in PHASE_ARRAYS:
            np.testing.assert_array_equal(getattr(tp, name),
                                          getattr(jp, name),
                                          err_msg=f"{at} {name}")
    assert tpb.all_shooting() == jpb.all_shooting(), at
    ja, ta = jpb.problem_arrays(), tpb.problem_arrays()
    assert set(ta) == set(ja)
    for name in ja:
        np.testing.assert_array_equal(np.asarray(ta[name]),
                                      np.asarray(ja[name]),
                                      err_msg=f"{at} {name}")
    assert tpb.flat_offsets() == jpb.flat_offsets(), at


@pytest.mark.parametrize("gait,plan", [("trot", 0.6), ("trot", 0.3),
                                       ("flytrot", 0.6), ("flytrot", 0.3)])
def test_update_matches_jax(tmp_path, gait, plan):
    jpb, tpb = problem_pair(gait, plan, tmp_path)
    _assert_same(jpb, tpb, "init")
    events = {"append": 0, "pop": 0, "not_all_shooting": 0}
    for k in range(1, N_UPDATES + 1):
        old_j, old_t = jpb.flat_offsets(), tpb.flat_offsets()
        uids = [ph.uid for ph in jpb.phases]
        jpb.update(1)
        tpb.update(1)
        at = f"{gait} plan {plan} update {k}"
        _assert_same(jpb, tpb, at)
        jd, td = jpb.shift_descriptor(old_j), tpb.shift_descriptor(old_t)
        for name in jd:
            np.testing.assert_array_equal(td[name], jd[name],
                                          err_msg=f"{at} {name}")
        events["append"] += jpb.phases[-1].uid not in uids
        events["pop"] += jpb.phases[0].uid != uids[0]
        events["not_all_shooting"] += not jpb.all_shooting()
    # the 40 updates cross both kinds of schedule change and the steps
    # whose last phase is too short to shoot
    assert all(events.values()), events


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_problem_checkpoint_crosses_packages(tmp_path, direction):
    """save_problem in one package and load_problem in the other, after 9
    updates (an appended phase, not all-shooting) with seeded warm starts:
    the loaded problem equals the saved one, and it goes on updating like
    the other package's problem."""
    from hkdmpc_tpu.utils import checkpoint as jckpt
    from hkdmpc_tpu_torch.utils import checkpoint as tckpt
    jpb, tpb = problem_pair("trot", 0.3, tmp_path)
    for _ in range(9):
        jpb.update(1)
        tpb.update(1)
    rng = np.random.default_rng(3)
    for jp, tp in zip(jpb.phases, tpb.phases):
        for name in ("Xbar", "Ubar", "K", "al_lambda"):
            a = rng.standard_normal(np.shape(getattr(jp, name)))
            setattr(jp, name, a)
            setattr(tp, name, a.copy())
    path = str(tmp_path / "problem.npz")
    (tmp_path / "fresh").mkdir()
    fresh_j, fresh_t = problem_pair("trot", 0.3, tmp_path / "fresh")
    if direction == "port_to_jax":
        tckpt.save_problem(path, tpb)
        jckpt.load_problem(path, fresh_j)
        jpb = fresh_j
    else:
        jckpt.save_problem(path, jpb)
        tckpt.load_problem(path, fresh_t)
        tpb = fresh_t
    _assert_same(jpb, tpb, "loaded")
    assert not tpb.all_shooting()
    for k in range(6):
        old_j, old_t = jpb.flat_offsets(), tpb.flat_offsets()
        jpb.update(1)
        tpb.update(1)
        _assert_same(jpb, tpb, f"update {k} after the load")
        jd, td = jpb.shift_descriptor(old_j), tpb.shift_descriptor(old_t)
        for name in jd:
            np.testing.assert_array_equal(td[name], jd[name])


def test_update_by_several_steps_matches_jax(tmp_path):
    """update(nsteps=3): three window slides and one zeroed front control
    per call."""
    jpb, tpb = problem_pair("trot", 0.3, tmp_path)
    for k in range(8):
        old_j, old_t = jpb.flat_offsets(), tpb.flat_offsets()
        jpb.update(3)
        tpb.update(3)
        _assert_same(jpb, tpb, f"update {k}")
        jd, td = jpb.shift_descriptor(old_j), tpb.shift_descriptor(old_t)
        for name in jd:
            np.testing.assert_array_equal(td[name], jd[name])
