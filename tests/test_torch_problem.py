"""Port parity: gait synthesis, problem build, the numpy carry-over
(`structs.from_numpy`) and scenario batching, against the JAX package,
float64 on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.parallel.batch import replicate_problem as jreplicate
from hkdmpc_tpu.reference import refgen as jrefgen
from hkdmpc_tpu.solver import structs as jstructs
from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                             replicate_problem)
from hkdmpc_tpu_torch.reference import refgen
from hkdmpc_tpu_torch.solver import structs
from tests._torch_twin import (F64, jax_trot_problem, tile_tree,
                               to_numpy_tree, x0_noise)

torch.set_num_threads(2)

SEGMENTS = {"trot": workload.TROT_SEGMENTS,
            "mixed": (("trot", 0.4, 0.3), ("hop", 0.4, 0.2),
                      ("pronk", 0.4, 0.3))}


@pytest.mark.parametrize("gait", sorted(SEGMENTS))
def test_synthesized_gait_matches(gait, tmp_path):
    """Synthesized arrays equal to 1e-12; written CSV files identical."""
    a = refgen.GaitSynthesizer().synthesize(SEGMENTS[gait])
    b = jrefgen.GaitSynthesizer().synthesize(SEGMENTS[gait])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=0, atol=1e-12, err_msg=k)
    pa = refgen.GaitSynthesizer().write(str(tmp_path / "port.csv"),
                                        SEGMENTS[gait])
    pb = jrefgen.GaitSynthesizer().write(str(tmp_path / "jax.csv"),
                                         SEGMENTS[gait])
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()


def test_leg_inverse_kinematics_matches():
    rng = np.random.default_rng(5)
    for _ in range(16):
        p = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.15, 0.15),
                      rng.uniform(-0.35, -0.2)])
        for side in (-1.0, 1.0):
            np.testing.assert_allclose(
                refgen.leg_inverse_kinematics(p, side),
                jrefgen.leg_inverse_kinematics(p, side), rtol=0, atol=1e-12)


@pytest.fixture(scope="module", params=[0.6, 2.0], ids=["T75", "T250"])
def built(request):
    plan = request.param
    jpb, jprob, jstate, _ = jax_trot_problem(plan)
    pb, prob, state, _ = workload.trot_problem(plan, dtype=F64, device="cpu")
    return jpb, jprob, jstate, pb, prob, state


def _fields(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        elif not (v is None or isinstance(v, bool)):   # no host-side note
            yield prefix + f.name, v


def test_problem_build_matches(built):
    """Every ProblemData / SolverState field equal between the packages."""
    jpb, jprob, jstate, pb, prob, state = built
    assert pb.T == jpb.T and pb.all_shooting() == jpb.all_shooting()
    assert [p.horizon for p in pb.phases] == [p.horizon for p in jpb.phases]
    for (name, got), (_, want) in zip(
            list(_fields(prob)) + list(_fields(state)),
            list(_fields(jprob)) + list(_fields(jstate))):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert prob.kind.dtype == torch.int32


def test_problem_arrays_match(built):
    jpb, _, _, pb, _, _ = built
    a, b = pb.problem_arrays(), jpb.problem_arrays()
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "node_map":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trot_phase_structure(built):
    """The 0.6 s trot has T = 75: 60 DYN, 4 RESET, 11 PAD transitions."""
    _, _, _, pb, prob, _ = built
    k = prob.kind.numpy()
    counts = (int((k == structs.DYN).sum()), int((k == structs.RESET).sum()),
              int((k == structs.PAD).sum()))
    expected = {75: (60, 4, 11), 250: (200, 19, 31)}[pb.T]
    assert counts == expected
    assert pb.all_shooting()


@pytest.mark.parametrize("cls", ["ProblemData", "SolverState"])
def test_from_numpy_round_trip(built, cls):
    """from_numpy of the JAX struct's numpy fields gives the port's own
    build, f64-exact, and converts back to the same numpy arrays."""
    _, jprob, jstate, _, prob, state = built
    jobj, own = {"ProblemData": (jprob, prob),
                 "SolverState": (jstate, state)}[cls]
    tree = to_numpy_tree(jobj)
    got = structs.from_numpy(tree, "cpu", F64)
    assert type(got).__name__ == cls
    for (name, a), (_, b) in zip(_fields(got), _fields(own)):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    back = dataclasses.asdict(structs.tree_map(lambda a: a.numpy(), got))
    flat = lambda d, p="": [(p + k, v) for k, v in d.items()
                            if not isinstance(v, dict)] + [
        kv for k, v in d.items() if isinstance(v, dict)
        for kv in flat(v, p + k + ".")]
    for (name, a), (_, b) in zip(flat(back), flat(tree)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_from_numpy_rejects_other_trees():
    with pytest.raises(ValueError):
        structs.from_numpy({"foo": np.zeros(3)}, "cpu", F64)


def test_replicate_and_perturb_match(built):
    """replicate_problem + perturb_scenarios with numpy noise give the JAX
    package's replicated problem with x0 + noise * x0_scale."""
    _, jprob, jstate, _, prob, state = built
    B = 3
    noise, scaled = x0_noise(B, seed=11)
    prob_b, state_b = replicate_problem(prob, state, B)
    prob_b = perturb_scenarios(prob_b, noise=noise)
    jprob_b, jstate_b = jreplicate(jprob, jstate, B)
    jprob_b = dataclasses.replace(jprob_b, x0=jprob_b.x0 + jnp.asarray(scaled))
    for (name, got), (_, want) in zip(
            list(_fields(prob_b)) + list(_fields(state_b)),
            list(_fields(jprob_b)) + list(_fields(jstate_b))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        assert got.is_contiguous(), name


def test_perturb_with_generator_is_seeded(built):
    _, _, _, _, prob, state = built
    prob_b, _ = replicate_problem(prob, state, 4)
    a = perturb_scenarios(prob_b, generator=torch.Generator().manual_seed(3))
    b = perturb_scenarios(prob_b, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.x0, b.x0)
    assert not torch.equal(a.x0, prob_b.x0)
    with pytest.raises(ValueError):
        perturb_scenarios(prob_b)
    tiled = tile_tree({"x0": prob.x0.numpy()}, 4)["x0"]
    np.testing.assert_array_equal(prob_b.x0.numpy(), tiled)
