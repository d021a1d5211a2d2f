"""The port's own copies of the JAX package's jax-free modules stay equal to
them: `hkdmpc_tpu_torch.config` against `hkdmpc_tpu.config` (every field
default, the derived options, both settings loaders on small in-test
texts) and `hkdmpc_tpu_torch.reference.quad_reference` against
`hkdmpc_tpu.reference.quad_reference` (every array of the same
GaitSynthesizer gait file, the window queries, the MHPC reorder)."""
import dataclasses

import numpy as np
import pytest

from hkdmpc_tpu import config as jconfig
from hkdmpc_tpu.reference.quad_reference import QuadReference as JQuadReference
from hkdmpc_tpu.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch import config as tconfig
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference

CLASSES = ("HSDDPOption", "REBParam", "ALParam", "ConstraintParams")

DDP_SETTING = """
ddp
{
    alpha            0.5
    gamma            0.01
    update_penalty   6
    max_DDP_iter     7
    max_AL_iter      4
    cost_thresh      1e-2
    AL_active        false
    ReB_active       true
    MS               true
    unknown_key      3
}
"""

CONSTRAINT_PARAMS = """
GRF_ReB { delta 0.2; delta_min 0.02; eps 2.0 }
Swing_ReB
{
    delta 0.3
    delta_min 0.03
    eps 0.5
}
TD_AL { lambda 0.1; sigma 7.0; sigma_max 1e3 }
"""

GAITS = {"trot": (("trot", 1.0, 0.5),), "hop": (("hop", 0.6, 0.2),)}
ARRAYS = ("body_state", "qJ", "qJd", "foot_placements", "grf", "torque",
          "contact", "status_dur")


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_field_defaults_equal(name):
    """Same fields in the same order, same types, same default values."""
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert _fields(tcls) == _fields(jcls)
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("kwargs", [
    {}, {"alpha": 0.5}, {"alpha": 0.3, "max_DDP_iter_runtime": 4,
                         "max_AL_iter_runtime": 3}],
    ids=["defaults", "alpha", "caps"])
def test_derived_options_equal(kwargs):
    """runtime() and line_search_epsilons; the port's option stays hashable
    and frozen."""
    jopt, topt = jconfig.HSDDPOption(**kwargs), tconfig.HSDDPOption(**kwargs)
    assert (dataclasses.asdict(topt.runtime())
            == dataclasses.asdict(jopt.runtime()))
    assert topt.line_search_epsilons == jopt.line_search_epsilons
    assert hash(topt) == hash(tconfig.HSDDPOption(**kwargs))
    with pytest.raises(dataclasses.FrozenInstanceError):
        topt.alpha = 1.0


@pytest.mark.parametrize("loader,text", [
    ("load_ddp_setting", DDP_SETTING),
    ("load_constraint_params", CONSTRAINT_PARAMS)])
def test_settings_loaders_equal(tmp_path, loader, text):
    """Both loaders on a small settings text: the same parse tree and the
    same loaded values, and the values are the text's, not the defaults."""
    path = tmp_path / "settings.info"
    path.write_text(text)
    assert tconfig.parse_info(text) == jconfig.parse_info(text)
    got = getattr(tconfig, loader)(str(path))
    want = getattr(jconfig, loader)(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got) != dataclasses.asdict(type(got)())


def _pair(tmp_path, gait, reorder=False):
    path = GaitSynthesizer().write(str(tmp_path / f"{gait}.csv"), GAITS[gait])
    return (QuadReference.from_file(path, reorder=reorder),
            JQuadReference.from_file(path, reorder=reorder))


@pytest.mark.parametrize("reorder", [False, True], ids=["plain", "reordered"])
@pytest.mark.parametrize("gait", sorted(GAITS))
def test_quad_reference_arrays_equal(tmp_path, gait, reorder):
    """The same gait file gives exactly equal arrays and dense tables."""
    got, want = _pair(tmp_path, gait, reorder)
    assert (got.dt, got.n) == (want.dt, want.n) and got.n > 10
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.hkd_state_table(),
                                  want.hkd_state_table())
    np.testing.assert_array_equal(got.hkd_control_table(),
                                  want.hkd_control_table())


@pytest.mark.parametrize("gait", sorted(GAITS))
def test_quad_reference_window_queries_equal(tmp_path, gait):
    """initialize / step and the time-indexed queries agree along a sliding
    window, past the end of the file too."""
    got, want = _pair(tmp_path, gait)
    for ref in (got, want):
        ref.initialize(0.3)
    assert (got.sz, got.dur) == (want.sz, want.dur)
    for _ in range(got.n // 7 + 2):
        for ref in (got, want):
            ref.step(7 * ref.dt)
        assert (got.k_cur, got.start_time, got.end_time) == (
            want.k_cur, want.start_time, want.end_time)
        for t in (0.0, 0.004, 0.0051, 0.1, 0.3, 0.35):
            assert got._index(t) == want._index(t)
            np.testing.assert_array_equal(got.contact_at_t(t),
                                          want.contact_at_t(t))
            np.testing.assert_array_equal(got.contact_duration_at_t(t),
                                          want.contact_duration_at_t(t))
        k = min(got.k_cur, got.n - 1)
        np.testing.assert_array_equal(got.hkd_state_at(k),
                                      want.hkd_state_at(k))
        np.testing.assert_array_equal(got.hkd_control_at(k),
                                      want.hkd_control_at(k))
