"""Port parity: the forward-mode AD Jacobians of `hkdmpc_tpu_torch.models.hkd`
(`dynamics_jacobians`, `reset_map_jacobian_ad`, `torch.func.jacfwd`) and the
batched conveniences (`dynamics_vmap_steps`, `dynamics_jacobians_vmap`)
against the JAX package's jacfwd / vmap versions and against the port's own
closed forms, float64 on the CPU, at 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.models import hkd as jhkd
from hkdmpc_tpu_torch.models import hkd

torch.set_num_threads(2)

TOL = 1e-10
DT = 0.01
# every stance / swing pattern a quadruped gait uses, and each transition
CONTACTS = np.array([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0], [0, 0, 0, 0],
                     [1, 1, 0, 0], [0, 1, 0, 1]], np.float64)


def _samples(n, seed):
    """n states near the stand pose, controls of the trot's magnitude and
    per-sample contacts (cycling through CONTACTS)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.1, size=(n, 24))
    x[:, 5] += 0.25
    x[:, 12:24] += np.tile([0.0, -0.8, 1.6], 4)
    u = rng.normal(scale=5.0, size=(n, 24))
    c = CONTACTS[np.arange(n) % len(CONTACTS)]
    return x, u, c


# the JAX functions compiled once (eager jacfwd dispatches op by op)
_jdyn_jac = jax.jit(jhkd.dynamics_jacobians)
_jreset_jac = jax.jit(jhkd.reset_map_jacobian_ad)
_jdyn_steps = jax.jit(jhkd.dynamics_vmap_steps)
_jdyn_jac_steps = jax.jit(jhkd.dynamics_jacobians_vmap)


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_dynamics_jacobians_match_jax_and_closed_form():
    x, u, c = _samples(12, 0)
    A, B = hkd.dynamics_jacobians(t(x), t(u), t(c), DT)
    assert A.shape == (12, 24, 24) and B.shape == (12, 24, 24)
    Aa, Ba = hkd.dynamics_jacobians_analytic(t(x), t(u), t(c), DT)
    np.testing.assert_allclose(A.numpy(), Aa.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(B.numpy(), Ba.numpy(), rtol=0, atol=TOL)
    for k in range(len(x)):
        jA, jB = _jdyn_jac(jnp.asarray(x[k]), jnp.asarray(u[k]),
                           jnp.asarray(c[k]), DT)
        np.testing.assert_allclose(A[k].numpy(), np.asarray(jA), rtol=0,
                                   atol=TOL, err_msg=f"A sample {k}")
        np.testing.assert_allclose(B[k].numpy(), np.asarray(jB), rtol=0,
                                   atol=TOL, err_msg=f"B sample {k}")


def test_dynamics_jacobians_take_any_leading_shape():
    x, u, c = _samples(6, 1)
    A1, B1 = hkd.dynamics_jacobians(t(x[2]), t(u[2]), t(c[2]), DT)
    assert A1.shape == (24, 24)
    A, B = hkd.dynamics_jacobians(t(x).reshape(2, 3, 24),
                                  t(u).reshape(2, 3, 24),
                                  t(c).reshape(2, 3, 4),
                                  torch.full((2, 3), DT, dtype=torch.float64))
    assert A.shape == (2, 3, 24, 24)
    np.testing.assert_array_equal(A[0, 2].numpy(), A1.numpy())
    np.testing.assert_array_equal(B[0, 2].numpy(), B1.numpy())


@pytest.mark.parametrize("transition", ["touchdown", "liftoff", "mixed"])
def test_reset_map_jacobian_ad_matches_jax_and_closed_form(transition):
    x, _, c = _samples(6, 2)
    c_next = {"touchdown": np.maximum(c, 1.0 - c[::-1]),
              "liftoff": c * c[::-1],
              "mixed": 1.0 - c}[transition]
    P = hkd.reset_map_jacobian_ad(t(x), t(c), t(c_next))
    Pa = hkd.reset_map_jacobian(t(x), t(c), t(c_next))
    np.testing.assert_allclose(P.numpy(), Pa.numpy(), rtol=0, atol=TOL)
    for k in range(len(x)):
        jP = _jreset_jac(jnp.asarray(x[k]), jnp.asarray(c[k]),
                         jnp.asarray(c_next[k]))
        np.testing.assert_allclose(P[k].numpy(), np.asarray(jP), rtol=0,
                                   atol=TOL, err_msg=f"sample {k}")


def test_vmap_helpers_match_jax():
    x, u, c = _samples(9, 3)
    jx, ju, jc = jnp.asarray(x), jnp.asarray(u), jnp.asarray(c)
    np.testing.assert_allclose(
        hkd.dynamics_vmap_steps(t(x), t(u), t(c), DT).numpy(),
        np.asarray(_jdyn_steps(jx, ju, jc, DT)), rtol=0, atol=TOL)
    A, B = hkd.dynamics_jacobians_vmap(t(x), t(u), t(c), DT)
    jA, jB = _jdyn_jac_steps(jx, ju, jc, DT)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0, atol=TOL)
