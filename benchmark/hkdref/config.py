"""Solver options: the port's `config.py`, frozen on its defaults (the
benchmark loads no settings file). Mirrors the reference's HSDDP_OPTION
struct (HSDDPSolver/common/HSDDP_CompoundTypes.h:18-60) by its parameter
names, and the constraint parameters of constraint_params.info.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HSDDPOption:
    """Frozen (hashable), as in the JAX package, where it is a static jit
    argument."""
    # names/defaults parity: HSDDP_CompoundTypes.h:18-60
    alpha: float = 0.1                  # line search step shrink factor
    gamma: float = 0.1                  # Armijo scale on expected merit change
    update_penalty: float = 8.0         # AL penalty update beta
    update_relax: float = 0.1           # ReB relaxation (delta) update
    update_regularization: float = 2.0  # backward-sweep regularization growth
    update_ReB: float = 7.0             # ReB weight (eps) update
    max_DDP_iter: int = 3               # inner loop cap (cold solve)
    max_AL_iter: int = 2                # outer loop cap (cold solve)
    max_DDP_iter_runtime: int = 1       # inner loop cap (MPC re-solve)
    max_AL_iter_runtime: int = 2        # outer loop cap (MPC re-solve)
    cost_thresh: float = 1e-3
    tconstr_thresh: float = 1e-3
    pconstr_thresh: float = 1e-3
    dynamics_feas_thresh: float = 1e-3
    merit_rho: float = 1e4
    merit_scale: float = 0.2
    merit_offset: float = 10.0
    AL_active: bool = True
    ReB_active: bool = True
    smooth_active: bool = False
    MS: bool = True                     # multiple shooting
    nsteps_per_node: int = 1

    def runtime(self) -> "HSDDPOption":
        """Copy with the runtime (MPC-loop) iteration caps applied
        (reference: HKDMPC/HKDMPC.cpp:102-103)."""
        return dataclasses.replace(
            self, max_DDP_iter=self.max_DDP_iter_runtime,
            max_AL_iter=self.max_AL_iter_runtime)

    @property
    def line_search_epsilons(self):
        """The exact candidate step sizes the reference's sequential line
        search would try: eps = 1, alpha, alpha^2, ... while eps > 1e-3
        (reference: MultiPhaseDDP.cpp:113-136). Trying them in parallel and
        picking the first Armijo-satisfying one is semantically identical."""
        eps, out = 1.0, []
        while eps > 1e-3:
            out.append(eps)
            eps *= self.alpha
        return out


@dataclasses.dataclass
class REBParam:
    # reference: ConstraintsBase.h:73-86 + constraint_params.info
    delta: float = 0.1
    delta_min: float = 0.01
    eps: float = 1.0


@dataclasses.dataclass
class ALParam:
    # reference: ConstraintsBase.h:58-70 + constraint_params.info
    lambda_: float = 0.0
    sigma: float = 5.0
    sigma_max: float = 1e4


@dataclasses.dataclass
class ConstraintParams:
    grf_reb: REBParam = dataclasses.field(default_factory=REBParam)
    td_al: ALParam = dataclasses.field(default_factory=ALParam)
