"""Solver options and config loading.

The port's own copy of `hkdmpc_tpu/config.py` (the port imports nothing of
the JAX package); `tests/test_torch_config.py` pins the two equal. Mirrors the reference's HSDDP_OPTION struct and its boost property-tree INFO
loader (reference: HSDDPSolver/common/HSDDP_CompoundTypes.h:18-87), using the
same parameter names so settings files are auditable 1:1. A minimal parser for
the boost INFO format is included so the reference's own setting files
(HKDMPC/settings/ddp_setting.info, constraint_params.info) load unchanged.
"""

from __future__ import annotations

import dataclasses
import re


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
    swing_reb: REBParam = dataclasses.field(default_factory=REBParam)
    td_al: ALParam = dataclasses.field(default_factory=ALParam)


def parse_info(text: str) -> dict:
    """Parse the subset of boost property-tree INFO format used by the
    reference's settings files: `key value` pairs inside `name { ... }`
    blocks. Returns nested dicts of strings."""
    tokens = re.findall(r"\{|\}|[^\s{};]+", re.sub(r";", " ", text))
    root: dict = {}
    stack = [root]
    pending_key = None
    for tok in tokens:
        if tok == "{":
            d: dict = {}
            stack[-1][pending_key] = d
            stack.append(d)
            pending_key = None
        elif tok == "}":
            stack.pop()
            pending_key = None
        elif pending_key is None:
            pending_key = tok
        else:
            stack[-1][pending_key] = tok
            pending_key = None
    return root


def _coerce(v: str):
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    try:
        f = float(v)
        return int(f) if f == int(f) and "." not in v and "e" not in v.lower() else f
    except ValueError:
        return v


def load_ddp_setting(path: str) -> HSDDPOption:
    """Load an HSDDP_OPTION from a boost-INFO settings file
    (parity: loadHSDDPSetting, HSDDP_CompoundTypes.h:62-87)."""
    with open(path) as f:
        tree = parse_info(f.read())
    ddp = tree.get("ddp", {})
    kwargs = {f.name: _coerce(ddp[f.name])
              for f in dataclasses.fields(HSDDPOption) if f.name in ddp}
    return HSDDPOption(**kwargs)


def load_constraint_params(path: str) -> ConstraintParams:
    """Load ReB/AL constraint parameters from a boost-INFO file
    (parity: HKDProblem::loadConstrintParameters, HKDProblem.h:69-90)."""
    with open(path) as f:
        tree = parse_info(f.read())
    cp = ConstraintParams()
    if "GRF_ReB" in tree:
        g = tree["GRF_ReB"]
        cp.grf_reb = REBParam(float(g["delta"]), float(g["delta_min"]), float(g["eps"]))
    if "Swing_ReB" in tree:
        s = tree["Swing_ReB"]
        cp.swing_reb = REBParam(float(s["delta"]), float(s["delta_min"]), float(s["eps"]))
    if "TD_AL" in tree:
        t = tree["TD_AL"]
        cp.td_al = ALParam(float(t["lambda"]), float(t["sigma"]), float(t["sigma_max"]))
    return cp
