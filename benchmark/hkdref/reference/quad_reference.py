"""Reference-trajectory manager (host side, numpy only).

The port's own copy of `hkdmpc_tpu/reference/quad_reference.py` (the port
imports nothing of the JAX package); `tests/test_torch_config.py` pins the
two equal.

Loads the reference's sectioned-CSV gait files (format written by
scripts/ReferenceGen/generate_reference.m; parsed in the reference by
Reference/QuadReference.cpp:129-285) into dense numpy arrays and provides the
same windowed, time-indexed queries the reference's deque-backed QuadReference
offers (initialize / step / get_*_at_t, QuadReference.cpp:6-119).

Design difference from the C++ reference: instead of a deque of structs we keep the whole
top-level trajectory as dense arrays and express the sliding MPC window as an
integer offset `k_cur` — queries are O(1) gathers, and the per-solve reference
tensors handed to the device are plain slices.
"""

from __future__ import annotations

import numpy as np

_SECTIONS = ("body_state", "qJ", "foot_placements", "grf", "torque",
             "contact", "status_dur")
_SIZES = {"body_state": 12, "qJ": 12, "foot_placements": 12, "grf": 12,
          "torque": 12, "contact": 4, "status_dur": 4}


class QuadReference:
    """Windowed view over a long gait reference trajectory.

    Arrays (over the full top-level horizon, length ``n``):
      body_state (n,12) [eul(yaw,pitch,roll), pos, omega, vel]
      qJ, qJd, foot_placements, grf, torque (n,12); contact (n,4) float;
      status_dur (n,4).
    """

    def __init__(self):
        self.dt = 0.0
        self.n = 0
        self.k_cur = 0      # start index of the current window
        self.sz = 0         # number of window points = round(dur/dt) + 1
        self.dur = 0.0

    # ---- loading ----------------------------------------------------------

    def load_file(self, fname: str):
        """Parse the sectioned CSV format (see module docstring).

        Record semantics mirror the reference parser exactly
        (QuadReference.cpp:129-285): a `body_state` header starts a fresh
        zeroed record, known section headers (substring match) fill it,
        `status_dur` commits it. Unknown sections (e.g. flytrot's
        `jnt_angle` / `foot_velocities`) are ignored, leaving zeros — the
        reference behaves identically on those files."""
        arrays = {s: [] for s in _SECTIONS}
        record = {s: [0.0] * _SIZES[s] for s in _SECTIONS}
        dt = None
        with open(fname) as f:
            lines = iter(f.read().splitlines())
        for line in lines:
            key = line.strip()
            if key == "dt":
                dt = float(next(lines))
                continue
            for s in _SECTIONS:
                if s in key:
                    if s == "body_state":
                        record = {k: [0.0] * _SIZES[k] for k in _SECTIONS}
                    vals = [float(w) for w in next(lines).split()][: _SIZES[s]]
                    vals += [0.0] * (_SIZES[s] - len(vals))
                    record[s] = vals
                    if s == "status_dur":
                        for k in _SECTIONS:
                            arrays[k].append(record[k])
                    break
        assert dt is not None, f"no dt record in {fname}"
        self.dt = dt
        self.body_state = np.asarray(arrays["body_state"])
        self.qJ = np.asarray(arrays["qJ"])
        self.foot_placements = np.asarray(arrays["foot_placements"])
        self.grf = np.asarray(arrays["grf"])
        self.torque = np.asarray(arrays["torque"])
        self.contact = np.asarray(arrays["contact"])
        self.status_dur = np.asarray(arrays["status_dur"])
        self.qJd = np.zeros_like(self.qJ)
        self.n = self.body_state.shape[0]
        return self

    @classmethod
    def from_file(cls, fname: str) -> "QuadReference":
        return cls().load_file(fname)

    # ---- windowing (parity with QuadReference.cpp:6-47) -------------------

    def initialize(self, plan_horizon: float):
        self.k_cur = 0
        self.dur = plan_horizon
        self.sz = int(round(plan_horizon / self.dt)) + 1

    def step(self, dt_sim: float):
        """Slide the window forward by one simulation step."""
        nsteps = int(round(dt_sim / self.dt))
        self.k_cur += max(nsteps, 1)

    @property
    def start_time(self) -> float:
        return self.k_cur * self.dt

    @property
    def end_time(self) -> float:
        return self.k_cur * self.dt + self.dur

    # ---- time-indexed queries (parity: QuadReference.cpp:65-119) ----------

    def _index(self, t: float) -> int:
        """Window-relative time -> absolute index, with the reference's
        half-step rounding, clamped to the window end."""
        k = int(np.floor(t / self.dt + 1e-9))
        if t - k * self.dt > 0.5 * self.dt:
            k += 1
        k = min(k, self.sz)
        return min(self.k_cur + k, self.n - 1)

    def contact_at_t(self, t: float) -> np.ndarray:
        return self.contact[self._index(t)]

    def contact_duration_at_t(self, t: float) -> np.ndarray:
        return self.status_dur[self._index(t)]

    def hkd_state_table(self) -> np.ndarray:
        """(n, 24) dense table of hkd_state_at over every index — the
        device-residency path gathers per-solve references from this."""
        if getattr(self, "_state_table", None) is None:
            c = self.contact.reshape(-1, 4, 1)
            qd = (c * self.foot_placements.reshape(-1, 4, 3)
                  + (1 - c) * self.qJ.reshape(-1, 4, 3)).reshape(-1, 12)
            self._state_table = np.concatenate([self.body_state, qd], axis=1)
        return self._state_table

    def hkd_control_table(self) -> np.ndarray:
        """(n, 24) dense table of hkd_control_at over every index."""
        if getattr(self, "_control_table", None) is None:
            self._control_table = np.concatenate([self.grf, self.qJd], axis=1)
        return self._control_table

    def hkd_state_at(self, k_abs: int) -> np.ndarray:
        """24-dim HKD state reference at absolute index (parity:
        HKDSinglePhaseReference::get_reference_at_t, HKDReference.cpp:24-57):
        body_state, then per-leg foot placement (stance) or qJ (swing)."""
        return self.hkd_state_table()[k_abs]

    def hkd_control_at(self, k_abs: int) -> np.ndarray:
        """24-dim control reference: [grf, commanded joint velocity]."""
        return self.hkd_control_table()[k_abs]
