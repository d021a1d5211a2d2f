"""Pluggable model / cost / constraint API — port of
`hkdmpc_tpu/solver/model_api.py`, the framework's extension surface.

Parity role: the reference's abstraction layer — SinglePhaseBase with its
dynamics/reset callbacks (SinglePhase.h:40-50), CostBase / CostContainer
(SinglePhaseInterface.h), PathConstraintBase / TerminalConstraintBase /
ConstraintContainer (ConstraintsBase.h). A ModelSpec bundles the dynamics,
the reset map, their Jacobians and the cost and constraint terms; user
models, costs and constraints plug in without touching solver code.

**Batched terms.** The JAX package calls each function on one node and
vmaps it. Here every function is called once on all nodes at once: it takes
tensors with leading batch dimensions — x (..., xs), u (..., us), and a
`ctx` dict whose fields carry the same leading dimensions — and returns its
outputs with those leading dimensions in front: a cost (...), partials
lx (..., xs), lxx (..., xs, xs), constraint rows g (..., n_rows), Jacobians
gx (..., n_rows, xs). The solver passes (scenario, transition) or
(scenario, node) as the leading dimensions; there is no vmap and no loop
over the horizon. User terms follow the same rule.

`ctx` holds the reference data of each node: contact (..., 4),
term_contact (..., 4), xr (..., xs), ur (..., us), foot_r (..., 12),
dt (...) and td_mask (..., 4) (`solver/rollout.run_ctx` / `term_ctx`).
Dynamics and reset maps take the same leading dimensions:
dynamics(x, u, contact, dt), reset_map(x, c_cur, c_next), and their
Jacobians return (A (..., xs, xs), B (..., xs, us)) and Px (..., xs, xs).

`running_partials` returns (lx, lu, lxx, luu, lux); lux (..., us, xs) may be
None for a term without u-x cross terms (every in-repo term), where the JAX
package returns zeros.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.ops import hkd_tminor, precise
from hkdmpc_tpu_torch.ops.jac_tminor import build_AB_tminor
from hkdmpc_tpu_torch.solver import costs as hkd_costs


class CostTerm:
    """Interface for additive cost terms (CostBase analog)."""
    name = "cost"

    def running(self, x, u, ctx):            # -> (...) (already * dt)
        return 0.0

    def running_partials(self, x, u, ctx):   # -> (lx, lu, lxx, luu, lux)
        raise NotImplementedError

    def terminal(self, x, ctx):              # -> (...)
        return 0.0

    def terminal_partials(self, x, ctx):     # -> (phix, phixx)
        raise NotImplementedError


class PathConstraintTerm:
    """Inequality path constraints g(x, u) >= 0 handled by ReB
    (PathConstraintBase analog). `n_rows` is static; inactive rows are
    masked. Gauss-Newton: only first derivatives (gx, gu) are used, as in
    the reference's HKD constraints (gxx = guu = 0)."""
    name = "path"
    n_rows = 0

    def violation(self, x, u, ctx):          # -> (g (..., n), mask (..., n))
        raise NotImplementedError

    def jacobian(self, x, u, ctx):           # -> (gx, gu) (..., n, xs|us)
        raise NotImplementedError


class TerminalConstraintTerm:
    """Equality terminal constraints h(x) = 0 handled by AL
    (TerminalConstraintBase analog)."""
    name = "terminal"
    n_rows = 0

    def violation(self, x, ctx):             # -> (h (..., n), mask (..., n))
        raise NotImplementedError

    def jacobian(self, x, ctx):              # -> hx (..., n, xs)
        raise NotImplementedError


class ModelSpec:
    """Dynamics + reset + cost terms + constraints, with the optional
    horizon-minor fast paths of the default HKD model (set by
    `hkd_model_spec`; None selects the generic term path)."""

    def __init__(self, dynamics, dynamics_jacobians, reset_map,
                 reset_map_jacobian, cost_terms: Sequence[CostTerm],
                 path_constraints: Sequence[PathConstraintTerm] = (),
                 terminal_constraints: Sequence[TerminalConstraintTerm] = (),
                 xs: int = 24, us: int = 24):
        self.dynamics = dynamics
        self.dynamics_jacobians = dynamics_jacobians
        self.reset_map = reset_map
        self.reset_map_jacobian = reset_map_jacobian
        self.cost_terms = tuple(cost_terms)
        self.path_constraints = tuple(path_constraints)
        self.terminal_constraints = tuple(terminal_constraints)
        self.xs = xs
        self.us = us
        # optional horizon-minor fast paths (ops/jac_tminor, ops/hkd_tminor)
        self.build_AB_tminor = None
        self.dynamics_tbatch = None
        self.reset_tbatch = None
        self.compute_cost_tbatch = None
        self.running_partials_tbatch = None
        self.terminal_partials_tbatch = None
        # a model whose running cost has no u-x cross terms sets this, and
        # the LQ approximation then carries lux = None
        self.lux_is_zero = False

    @property
    def n_path_rows(self) -> int:
        return sum(c.n_rows for c in self.path_constraints)

    @property
    def n_terminal_rows(self) -> int:
        return sum(c.n_rows for c in self.terminal_constraints)

    # --- aggregation over terms (Container analogs) -----------------------

    def running_cost(self, x, u, ctx):
        return sum(term.running(x, u, ctx) for term in self.cost_terms)

    def running_cost_partials(self, x, u, ctx):
        """(lx, lu, lxx, luu, lux) summed over the cost terms; lux is None
        when every term's is."""
        parts = [term.running_partials(x, u, ctx) for term in self.cost_terms]
        lx, lu, lxx, luu = (sum(p[i] for p in parts) for i in range(4))
        luxs = [p[4] for p in parts if p[4] is not None]
        return lx, lu, lxx, luu, (sum(luxs) if luxs else None)

    def terminal_cost(self, x, ctx):
        return sum(term.terminal(x, ctx) for term in self.cost_terms)

    def terminal_cost_partials(self, x, ctx):
        parts = [term.terminal_partials(x, ctx) for term in self.cost_terms]
        return tuple(sum(p[i] for p in parts) for i in range(2))

    def path_violations(self, x, u, ctx):
        """Concatenated (g, mask) across path constraints, (..., n_path)."""
        if not self.path_constraints:
            z = x.new_zeros(x.shape[:-1] + (0,))
            return z, z
        gs, masks = zip(*(c.violation(x, u, ctx)
                          for c in self.path_constraints))
        return torch.cat(gs, dim=-1), torch.cat(masks, dim=-1)

    def path_jacobians(self, x, u, ctx):
        if not self.path_constraints:
            return (x.new_zeros(x.shape[:-1] + (0, self.xs)),
                    x.new_zeros(x.shape[:-1] + (0, self.us)))
        gxs, gus = zip(*(c.jacobian(x, u, ctx)
                         for c in self.path_constraints))
        lead = x.shape[:-1]
        return (torch.cat([g.expand(lead + g.shape[-2:]) for g in gxs], -2),
                torch.cat([g.expand(lead + g.shape[-2:]) for g in gus], -2))

    def terminal_violations(self, x, ctx):
        if not self.terminal_constraints:
            z = x.new_zeros(x.shape[:-1] + (0,))
            return z, z
        hs, masks = zip(*(c.violation(x, ctx)
                          for c in self.terminal_constraints))
        return torch.cat(hs, dim=-1), torch.cat(masks, dim=-1)

    def terminal_jacobians(self, x, ctx):
        if not self.terminal_constraints:
            return x.new_zeros(x.shape[:-1] + (0, self.xs))
        return torch.cat([c.jacobian(x, ctx)
                          for c in self.terminal_constraints], dim=-2)


# ---------------------------------------------------------------------------
# HKD default terms (parity with HKDCost.h / HKDConstraints.cpp)
# ---------------------------------------------------------------------------


class HKDTrackingCost(CostTerm):
    name = "HKD tracking"

    def running(self, x, u, ctx):
        dx = x - ctx["xr"]
        du = u - ctx["ur"]
        l = 0.5 * torch.sum(hkd_costs.q_diag(ctx["contact"]) * dx * dx, -1)
        l = l + 0.5 * torch.sum(hkd_costs.r_diag(x.dtype, x.device) * du * du,
                                -1)
        return ctx["dt"] * l

    def running_partials(self, x, u, ctx):
        dt = ctx["dt"][..., None]
        Q = hkd_costs.q_diag(ctx["contact"])
        R = hkd_costs.r_diag(x.dtype, x.device).expand(u.shape)
        return (dt * Q * (x - ctx["xr"]), dt * R * (u - ctx["ur"]),
                torch.diag_embed(dt * Q), torch.diag_embed(dt * R), None)

    def terminal(self, x, ctx):
        dx = x - ctx["xr"]
        return 0.5 * torch.sum(hkd_costs.qf_diag(ctx["term_contact"]) * dx
                               * dx, -1)

    def terminal_partials(self, x, ctx):
        Qf = hkd_costs.qf_diag(ctx["term_contact"])
        return Qf * (x - ctx["xr"]), torch.diag_embed(Qf)


class HKDFootPlaceReg(CostTerm):
    name = "Foot regularization"

    def running(self, x, u, ctx):
        d, qf, _ = hkd_costs._footreg_terms(x, ctx["contact"], ctx["xr"],
                                            ctx["foot_r"])
        return ctx["dt"] * 0.5 * torch.sum(qf * d * d, -1)

    def running_partials(self, x, u, ctx):
        dt = ctx["dt"][..., None]
        d, qf, J = hkd_costs._footreg_terms(x, ctx["contact"], ctx["xr"],
                                            ctx["foot_r"])
        lx = dt * precise.vm(qf * d, J)
        lxx = dt[..., None] * precise.xtwx(J, qf)
        zero = u.new_zeros(())
        return (lx, zero.expand(u.shape), lxx,
                zero.expand(u.shape + u.shape[-1:]), None)

    def terminal(self, x, ctx):
        d, qf, _ = hkd_costs._footreg_terms(x, ctx["term_contact"], ctx["xr"],
                                            ctx["foot_r"])
        return 10.0 * torch.sum(qf * d * d, -1)

    def terminal_partials(self, x, ctx):
        d, qf, J = hkd_costs._footreg_terms(x, ctx["term_contact"], ctx["xr"],
                                            ctx["foot_r"])
        return 20.0 * precise.vm(qf * d, J), 20.0 * precise.xtwx(J, qf)


class GRFConstraint(PathConstraintTerm):
    name = "GRF"
    n_rows = 20

    def violation(self, x, u, ctx):
        return hkd_costs.grf_constraints(u, ctx["contact"])

    def jacobian(self, x, u, ctx):
        lead = x.shape[:-1]
        return (x.new_zeros(lead + (20, x.shape[-1])),
                hkd_costs.grf_constraint_jac(x.dtype, x.device).expand(
                    lead + (20, u.shape[-1])))


class SwingHeightConstraint(PathConstraintTerm):
    """Swing-foot ground clearance: pf_z(x) - ground >= 0 per swing leg.

    The reference declares this constraint but never implements or
    instantiates it (HKDConstraints.h:66-103); here it is a working
    optional term."""
    name = "Swing"
    n_rows = 4

    def __init__(self, ground_height: float = 0.0):
        self.ground = ground_height

    def violation(self, x, u, ctx):
        pf = hkd.foot_positions(x[..., 3:6], x[..., 0:3], x[..., 12:24])
        return pf[..., 2] - self.ground, 1.0 - ctx["contact"]

    def jacobian(self, x, u, ctx):
        gx = torch.stack([hkd.foot_height_jacobian(x, leg)
                          for leg in range(4)], dim=-2)
        return gx, u.new_zeros(u.shape[:-1] + (4, u.shape[-1]))


class TouchDownConstraint(TerminalConstraintTerm):
    name = "TouchDown"
    n_rows = 4

    def __init__(self, ground_height: float = 0.0):
        self.ground = ground_height

    def violation(self, x, ctx):
        pf = hkd.foot_positions(x[..., 3:6], x[..., 0:3], x[..., 12:24])
        return ctx["td_mask"] * (pf[..., 2] - self.ground), ctx["td_mask"]

    def jacobian(self, x, ctx):
        return torch.stack([hkd.foot_height_jacobian(x, leg)
                            for leg in range(4)], dim=-2)


def hkd_model_spec(swing_constraint: bool = False) -> ModelSpec:
    """The default HKD model (the reference's problem setup), optionally
    with the swing-height path constraint (24 path rows instead of 20)."""
    path = [GRFConstraint()]
    if swing_constraint:
        path.append(SwingHeightConstraint())
    spec = ModelSpec(
        dynamics=hkd.dynamics,
        dynamics_jacobians=hkd.dynamics_jacobians_analytic,
        reset_map=hkd.reset_map,
        reset_map_jacobian=hkd.reset_map_jacobian,
        cost_terms=[HKDTrackingCost(), HKDFootPlaceReg()],
        path_constraints=path,
        terminal_constraints=[TouchDownConstraint()],
    )
    # horizon-minor fast paths: the LQ Jacobians, the rollout's dynamics and
    # reset maps for every model; the cost and its partials only for the
    # default term set, which they hard-code
    spec.build_AB_tminor = build_AB_tminor
    spec.lux_is_zero = True
    spec.dynamics_tbatch = hkd_tminor.dynamics_tbatch
    spec.reset_tbatch = hkd_tminor.reset_tbatch
    if not swing_constraint:
        spec.compute_cost_tbatch = hkd_tminor.compute_cost_tbatch
        spec.running_partials_tbatch = hkd_tminor.running_partials_tbatch
        spec.terminal_partials_tbatch = hkd_tminor.terminal_partials_tbatch
    return spec
