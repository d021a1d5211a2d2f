"""The host-side problem of a `ModelSpec` with other path rows than the
default HKD model's: the port's `solver/problem.py`, whose per-row ReB
parameters and row counts follow the model's terms (`_reb_row_params`,
`n_path_rows`, `n_term_rows`), frozen as a subclass of
`hkdref.solver.problem.HKDProblem` (the default model's 20 GRF and 4
touchdown rows), which keeps everything else: the segmentation, the
flattening and the warm start.
"""

from __future__ import annotations

import numpy as np

from hkdref.config import REBParam
from hkdref.solver.problem import HKDProblem

# the port's `config.ConstraintParams.swing_reb` default, which the benchmark
# loads no settings file to change (constraint_params.info is not in the
# repository)
SWING_REB = REBParam()


class ModelProblem(HKDProblem):
    """HKDProblem for `model` (a `hkdref.solver.model_api.ModelSpec`): one
    ReB row per row of each path-constraint term, with the GRF rows' and the
    Swing rows' parameters."""

    def __init__(self, quad_ref, *, model, **kw):
        self.model = model
        super().__init__(quad_ref, **kw)

    def _reb_row_params(self):
        """Per-row ReB parameter vectors (delta, delta_min, eps) from the
        model's path-constraint terms, keyed by term name
        (HKDProblem::loadConstrintParameters analog)."""
        deltas, delta_mins, epss = [], [], []
        for c in self.model.path_constraints:
            p = {"GRF": self.cparams.grf_reb, "Swing": SWING_REB}.get(c.name)
            d, dm, e = ((p.delta, p.delta_min, p.eps) if p
                        else (0.01, 0.001, 1.0))
            deltas += [d] * c.n_rows
            delta_mins += [dm] * c.n_rows
            epss += [e] * c.n_rows
        return (np.asarray(deltas), np.asarray(delta_mins), np.asarray(epss))

    @property
    def n_path_rows(self) -> int:
        return self.model.n_path_rows

    @property
    def n_term_rows(self) -> int:
        return self.model.n_terminal_rows
