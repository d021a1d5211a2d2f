"""Port parity of the dense-LQ slice: `solve_batch(kernel_jac=False,
model=...)` of the PyTorch port against the JAX package's
`solve_batch(parallel_rollout=True, pallas_backward=True, unroll_caps=True,
model=...)`, float64 on the CPU (where the JAX batched rule runs its scan).

Models: the default HKD model and the swing-constraint model on the in-repo
trot (B = 3, plan 0.6 s, T = 75, runtime caps, identical numpy-made x0
noise), and the bouncing mass of tests/test_model_api.py — a point mass with
an inelastic impact reset, written as a ModelSpec in each package — at its
padded (xs = us = 24) and native (xs = 2, us = 1) widths. Decisions must
agree exactly (n_iters, solve_failed, trace lengths); costs and traces to
1e-9, trajectories and gains to 1e-8, relative to each array's magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.solver import ddp as jddp
from hkdmpc_tpu.solver import model_api as jmodel_api
from hkdmpc_tpu.solver import structs as jstructs
from hkdmpc_tpu_torch.solver import ddp, model_api
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import assert_solves_match, solve_both

torch.set_num_threads(2)

GRAVITY = 9.81


@pytest.mark.parametrize("model", ["default", "swing"])
def test_dense_solve_matches_jax(model):
    got, want = solve_both(batch=3, seed=23, plan_duration=0.6, model=model)
    assert_solves_match(got, want)
    assert not bool(got.solve_failed.any())
    assert bool(torch.isfinite(got.cost).all())
    assert int(np.asarray(want.n_iters).min()) >= 1
    rows = {"default": 20, "swing": 24}[model]
    assert got.state.constr.reb_delta.shape[-1] == rows


def test_kernel_jac_path_takes_no_model():
    """kernel_jac=True is the default model's path: a model is refused."""
    spec = model_api.hkd_model_spec()
    with pytest.raises(ValueError, match="kernel_jac"):
        ddp.solve_batch(None, None, HSDDPOption(), kernel_jac=True,
                        model=spec)


# ---------------------------------------------------------------------------
# the bouncing mass: the physics lives in x[0] (height), x[1] (velocity) and
# u[0] (thrust in the second phase); any further coordinates are inert
# ---------------------------------------------------------------------------


def _jax_spec(xs, us):
    """tests/test_model_api.py:_solve_bouncing_mass's ModelSpec."""
    def dyn(x, u, contact, dt):
        acc = -GRAVITY + contact[0] * u[0]
        return x.at[0].add(dt * x[1]).at[1].add(dt * acc)

    def dyn_jac(x, u, contact, dt):
        A = jnp.eye(xs, dtype=x.dtype).at[0, 1].set(dt)
        B = jnp.zeros((xs, us), x.dtype).at[1, 0].set(dt * contact[0])
        return A, B

    class HeightTracking(jmodel_api.CostTerm):
        def running(self, x, u, ctx):
            dx0 = x[0] - ctx["xr"][0]
            return ctx["dt"] * (0.5 * dx0 * dx0 + 0.5e-4 * jnp.sum(u * u))

        def running_partials(self, x, u, ctx):
            dt, dtype = ctx["dt"], x.dtype
            dx0 = x[0] - ctx["xr"][0]
            return (jnp.zeros(xs, dtype).at[0].set(dt * dx0), dt * 1e-4 * u,
                    jnp.zeros((xs, xs), dtype).at[0, 0].set(dt),
                    jnp.eye(us, dtype=dtype) * (dt * 1e-4),
                    jnp.zeros((us, xs), dtype))

        def terminal(self, x, ctx):
            dx0 = x[0] - ctx["xr"][0]
            return 10.0 * 0.5 * dx0 * dx0

        def terminal_partials(self, x, ctx):
            dx0 = x[0] - ctx["xr"][0]
            return (jnp.zeros(xs, x.dtype).at[0].set(10.0 * dx0),
                    jnp.zeros((xs, xs), x.dtype).at[0, 0].set(10.0))

    return jmodel_api.ModelSpec(
        dynamics=dyn, dynamics_jacobians=dyn_jac,
        reset_map=lambda x, c, cn: x.at[1].multiply(-0.5),
        reset_map_jacobian=lambda x, c, cn: jnp.eye(
            xs, dtype=x.dtype).at[1, 1].set(-0.5),
        cost_terms=[HeightTracking()], xs=xs, us=us)


def _port_spec(xs, us):
    """The same model on tensors with leading batch dimensions."""
    def dyn(x, u, contact, dt):
        acc = -GRAVITY + contact[..., 0] * u[..., 0]
        return torch.cat([(x[..., 0] + dt * x[..., 1])[..., None],
                          (x[..., 1] + dt * acc)[..., None], x[..., 2:]], -1)

    def dyn_jac(x, u, contact, dt):
        lead = x.shape[:-1]
        A = torch.eye(xs, dtype=x.dtype).expand(lead + (xs, xs)).clone()
        A[..., 0, 1] = dt
        B = x.new_zeros(lead + (xs, us))
        B[..., 1, 0] = dt * contact[..., 0]
        return A, B

    def reset(x, c, cn):
        return torch.cat([x[..., :1], -0.5 * x[..., 1:2], x[..., 2:]], -1)

    def reset_jac(x, c, cn):
        P = torch.eye(xs, dtype=x.dtype).expand(x.shape[:-1] + (xs, xs))
        P = P.clone()
        P[..., 1, 1] = -0.5
        return P

    def e0(x, v):
        """v in coordinate 0 of a zero vector shaped like x."""
        out = torch.zeros_like(x)
        out[..., 0] = v
        return out

    class HeightTracking(model_api.CostTerm):
        def running(self, x, u, ctx):
            dx0 = x[..., 0] - ctx["xr"][..., 0]
            return ctx["dt"] * (0.5 * dx0 * dx0
                                + 0.5e-4 * torch.sum(u * u, -1))

        def running_partials(self, x, u, ctx):
            dt = ctx["dt"]
            dx0 = x[..., 0] - ctx["xr"][..., 0]
            lxx = x.new_zeros(x.shape + (xs,))
            lxx[..., 0, 0] = dt
            luu = torch.diag_embed((dt * 1e-4)[..., None].expand(u.shape))
            return (e0(x, dt * dx0), dt[..., None] * 1e-4 * u, lxx, luu,
                    None)

        def terminal(self, x, ctx):
            dx0 = x[..., 0] - ctx["xr"][..., 0]
            return 10.0 * 0.5 * dx0 * dx0

        def terminal_partials(self, x, ctx):
            phixx = x.new_zeros(x.shape + (xs,))
            phixx[..., 0, 0] = 10.0
            return e0(x, 10.0 * (x[..., 0] - ctx["xr"][..., 0])), phixx

    return model_api.ModelSpec(
        dynamics=dyn, dynamics_jacobians=dyn_jac, reset_map=reset,
        reset_map_jacobian=reset_jac, cost_terms=[HeightTracking()],
        xs=xs, us=us)


def _bouncing_problem(xs, us, heights):
    """Numpy field trees of the two-phase problem (10 steps of flight, the
    impact reset, 10 steps of thrust toward 1 m), one scenario per start
    height."""
    T = 21
    kind = np.zeros(T, np.int32)
    kind[:10] = jstructs.DYN
    kind[10] = jstructs.RESET
    kind[11:] = jstructs.DYN
    contact = np.zeros((T, 4))
    contact[11:, 0] = 1.0
    xr = np.zeros((T + 1, xs))
    xr[:, 0] = 1.0
    term_mask = np.zeros(T + 1)
    term_mask[[10, T]] = 1.0
    start_mask = np.zeros(T + 1)
    start_mask[[0, 11]] = 1.0
    one = dict(
        kind=kind, contact=contact,
        contact_next=np.where(np.arange(T)[:, None] >= 10, contact[-1],
                              contact[0]),
        dt=np.asarray(0.02), xr=xr, ur=np.zeros((T + 1, us)),
        foot_r=np.zeros((T + 1, 12)), term_mask=term_mask,
        term_contact=np.vstack([contact, contact[-1:]]),
        td_mask=np.zeros((T + 1, 4)), ss_mask=np.ones(T + 1),
        start_mask=start_mask, x0=np.zeros(xs))
    prob = {k: np.repeat(np.asarray(v)[None], len(heights), axis=0)
            for k, v in one.items()}
    prob["x0"][:, 0] = heights
    nb = len(heights)
    constr = dict(reb_delta=np.zeros((nb, T, 0)),
                  reb_delta_min=np.zeros((nb, T, 0)),
                  reb_eps=np.zeros((nb, T, 0)),
                  al_lambda=np.zeros((nb, T + 1, 0)),
                  al_sigma=np.zeros((nb, T + 1, 0)),
                  al_sigma_max=np.zeros((nb, T + 1, 0)))
    return prob, constr


def _solve_bouncing(xs, us):
    prob_n, constr_n = _bouncing_problem(xs, us, heights=[2.0, 1.6])
    jprob = jstructs.ProblemData(**{k: jnp.asarray(v)
                                    for k, v in prob_n.items()})
    jconstr = jstructs.ConstraintState(**{k: jnp.asarray(v)
                                          for k, v in constr_n.items()})
    jstate = jax.vmap(jstructs.SolverState.init)(jprob, jconstr)
    prob = tstructs.from_numpy(prob_n, "cpu", torch.float64)
    state = tstructs.SolverState.init(prob, tstructs.ConstraintState(
        **{k: torch.as_tensor(v) for k, v in constr_n.items()}))
    opt = HSDDPOption(max_DDP_iter=12, max_AL_iter=1, AL_active=False,
                      ReB_active=False)
    got = ddp.solve_batch(prob, state, opt, kernel_jac=False,
                          model=_port_spec(xs, us))
    want = jddp.solve_batch(jprob, jstate, opt, parallel_rollout=True,
                            model=_jax_spec(xs, us), pallas_backward=True,
                            unroll_caps=True)
    return got, jax.tree_util.tree_map(np.asarray, want)


@pytest.fixture(scope="module")
def bouncing():
    return {xs: _solve_bouncing(xs, us) for xs, us in ((24, 24), (2, 1))}


@pytest.mark.parametrize("xs", [24, 2])
def test_bouncing_mass_matches_jax(bouncing, xs):
    got, want = bouncing[xs]
    assert_solves_match(got, want)
    assert not bool(got.solve_failed.any())
    assert float(got.dyn_feas.max()) < 1e-3
    # after the bounce, thrust drives the mass toward the 1 m target
    assert float((got.state.Xbar[:, -1, 0] - 1.0).abs().max()) < 0.3


def test_bouncing_mass_is_dimension_generic(bouncing):
    """The native widths (xs = 2, us = 1) solve as the padded ones do."""
    g24, g2 = bouncing[24][0], bouncing[2][0]
    assert g2.state.Xbar.shape[-1] == 2 and g2.state.Ubar.shape[-1] == 1
    np.testing.assert_allclose(g2.state.Xbar.numpy(),
                               g24.state.Xbar[..., :2].numpy(), atol=1e-8)
    np.testing.assert_allclose(g2.state.Ubar[..., 0].numpy(),
                               g24.state.Ubar[..., 0].numpy(), atol=1e-8)
    np.testing.assert_allclose(g2.cost.numpy(), g24.cost.numpy(), atol=1e-8)
